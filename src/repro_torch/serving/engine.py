"""In-process LLM serving engine on PyTorch — the local model executor the
PREDICT operator drives (port of ``repro/serving/engine.py``).

  * batched prefill (bucketed lengths, left padding) + lock-step decode
  * grammar-constrained decoding: per-step masks from serving.grammar,
    applied on the card by the fused constrained-sample kernel
  * shared-prefix KV reuse: the instruction prefix of a marshaled prompt is
    prefilled once (batch=1) and memoized in an LRU.  Two layouts:
      - kv_layout="dense": per-row contiguous caches; the memoized prefix
        KV is broadcast (copied) to the row batch
      - kv_layout="paged": one global pool of fixed-size KV pages plus
        per-row block tables; shared full prefix pages are referenced, not
        copied, by every row; a radix tree over token sequences finds
        partial prefix overlap with any earlier prompt ("radix", the
        default) or an exact-string memo resolves a caller's prefix
        ("exact"); frozen tree pages may be stored as int8
        (kv_quant="int8")
  * per-row cache write cursors (dense) or page-table slot lifecycle
    (paged) for continuous batching (scheduler.py)
  * the ssm and hybrid families' per-row SSM state: part of the dense
    cache, carried beside the pool as ``extra`` in the paged layout (which
    needs attention: an attention-free model runs dense only)

The page pool is written in place; growth reallocates it, so every call
builds its cache dict from the engine's current pool tensors.  Logits stay
on the device; only the sampled token ids come back to the host.
The Gumbel noise is drawn on the host from ``np.random.default_rng(seed)``
with the JAX engine's shapes, so both engines sample the same tokens from
the same logits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as KOPS
from repro_torch.models import model as MDL
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params
from repro_torch.serving import tokenizer as TOK
from repro_torch.serving.grammar import JsonGrammar
from repro_torch.serving.radix import RadixPrefixCache

NEG_INF = -1e30


def resolve_device(device=None) -> torch.device:
    """None means CUDA.  Without a GPU only an explicit CPU request runs:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA and no GPU is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


@dataclasses.dataclass
class GenStats:
    calls: int = 0
    input_tokens: int = 0
    output_tokens: int = 0
    prefill_tokens: int = 0        # actually prefit through the model
    decode_steps: int = 0
    wall_s: float = 0.0
    prefix_hits: int = 0
    radix_hit_tokens: int = 0      # prompt tokens served from the radix tree
    cow_copies: int = 0            # pages privatized by copy-on-write forks
    kv_bytes: int = 0              # peak KV-cache footprint (high-water)

    def add(self, other: "GenStats") -> None:
        for f in dataclasses.fields(self):
            if f.name == "kv_bytes":       # high-water mark, not a flow
                self.kv_bytes = max(self.kv_bytes, other.kv_bytes)
            else:
                setattr(self, f.name,
                        getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class GenResult:
    texts: List[str]
    stats: GenStats


class PageAllocator:
    """Host-side bookkeeping for the global KV page pool: a free list plus
    per-page refcounts (shared instruction-prefix pages are referenced by
    the prefix memo AND by every running batch that uses them) and a
    high-water mark — the `peak cache bytes` number the benchmarks report."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))       # pop() → 0 first
        self._ref = np.zeros(num_pages, np.int64)
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def resident_pages(self) -> int:
        """Pages currently referenced by anyone (memo, radix tree, runs)."""
        return self.in_use

    @property
    def high_water(self) -> int:
        return self.peak_in_use

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, free {len(self._free)}"
                f" of {self.num_pages}")
        ids = [self._free.pop() for _ in range(n)]
        for p in ids:
            self._ref[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return ids

    def retain(self, ids: Sequence[int]) -> None:
        for p in ids:
            self._ref[p] += 1

    def refs(self, page: int) -> int:
        return int(self._ref[page])

    def release(self, ids: Sequence[int]) -> None:
        for p in ids:
            self._ref[p] -= 1
            assert self._ref[p] >= 0, f"double free of page {p}"
            if self._ref[p] == 0:
                self._free.append(p)

    def grow(self, extra: int) -> None:
        start = self.num_pages
        self.num_pages += extra
        self._ref = np.concatenate([self._ref, np.zeros(extra, np.int64)])
        self._free.extend(range(self.num_pages - 1, start - 1, -1))


@dataclasses.dataclass
class _PrefixEntry:
    """Memoized shared-prefix KV: the batch=1 dense prefill cache of the
    prefix (never written to — `prefix_cache_for` hands out copies, since
    decode updates caches in place) plus, in paged mode, the pool pages it
    is currently resident in."""
    kv: dict
    off: int                        # bucketed prefix length (dense slots)
    real_len: int                   # true token count
    pages: Optional[List[int]] = None


class InferenceEngine:
    """Single-device engine around one model of a ported family (dense,
    MoE, ssm or hybrid; ``models.params.PORTED_FAMILIES``).  `device` None means
    CUDA (raises without a GPU); tests pass ``device="cpu"``, where the
    kernel wrappers run their plain PyTorch versions."""

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 seed: int = 0, max_len: int = 1024, kv_layout: str = "dense",
                 page_size: int = 64, page_pool_pages: Optional[int] = None,
                 prefix_memo_entries: int = 16,
                 prefix_cache_mode: str = "radix", kv_quant: str = "none",
                 device=None):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} cannot generate")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if prefix_cache_mode not in ("exact", "radix"):
            raise ValueError(f"unknown prefix_cache_mode {prefix_cache_mode!r}")
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        if kv_layout == "paged" and not cfg.has_attention:
            raise ValueError(f"{cfg.name}: paged KV layout needs attention")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.kv_layout = kv_layout
        self.params = params if params is not None else init_params(
            cfg, torch.Generator(device=self.device).manual_seed(seed),
            self.device)
        self.page_size = int(page_size)
        self.page_pool_pages = page_pool_pages
        self.prefix_memo_entries = int(prefix_memo_entries)
        #: "radix": partial-overlap prefix reuse through a refcounted radix
        #: tree over token sequences; "exact": exact-string prefix memo
        self.prefix_cache_mode = prefix_cache_mode
        #: "int8": frozen (tree-committed) pages are quantized on commit to
        #: an int8 shadow pool with per-page scales; live pages stay fp
        self.kv_quant = kv_quant
        #: per-row block-table width: max_len tokens worth of pages
        self.num_table_blocks = max(1, -(-max_len // self.page_size))
        #: LRU memo of shared-prefix KV (touch-on-get, capped — mirrors
        #: PromptCache semantics); evicting a paged-resident entry releases
        #: its pool pages
        self._prefix_kv: Dict[Tuple[str, int], _PrefixEntry] = {}
        self._rng = np.random.default_rng(seed)
        #: session-cumulative stats (EXPLAIN `-- dispatch --` surfacing)
        self.total = GenStats()
        # paged-layout state (lazy): device page pool + host allocator +
        # radix prefix tree + frozen-page quant flags (host array, copied
        # to the device before the next model call after every change)
        self._pool: Optional[Dict[str, torch.Tensor]] = None
        self._alloc: Optional[PageAllocator] = None
        self._radix: Optional[RadixPrefixCache] = None
        self._quant_flags: Optional[np.ndarray] = None
        self._quant_flags_dev: Optional[torch.Tensor] = None
        #: running peak of the pool's logical KV bytes, counting quantized
        #: pages at 1 byte/element — the `kv_bytes` number runs report
        self.kv_peak_bytes = 0

    # ------------------------------- steps ------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def decode_step(self, toks: np.ndarray, positions: np.ndarray, cache: dict
                    ) -> Tuple[torch.Tensor, dict]:
        """One lock-step decode tick: toks/positions (B,) host int arrays.
        Returns (float32 logits (B, Vp) on the device, cache)."""
        logits, cache = MDL.forward(
            self.cfg, self.params,
            {"tokens": self._tensor(toks.astype(np.int32)[:, None]),
             "positions": self._tensor(positions.astype(np.int32)[:, None])},
            mode="decode", cache=cache)
        return logits[:, 0].float(), cache

    # ------------------------------- prefill ----------------------------------
    def _prefill(self, token_lists: List[List[int]], *, offset: int = 0,
                 pos_offset: Optional[int] = None,
                 cache: Optional[dict] = None, row_idx_mode: bool = False):
        """offset = cache slot offset (bucketed prefix length);
        pos_offset = absolute position offset (REAL prefix length — RoPE
        positions must not jump over the prefix bucket padding).
        Returns (float32 last-token logits (B, Vp) on the device, cache,
        lens, prefill token count)."""
        if pos_offset is None:
            pos_offset = offset
        B = len(token_lists)
        L = _bucket(max(len(t) for t in token_lists))
        toks = np.full((B, L), TOK.PAD_ID, np.int32)
        pos = np.zeros((B, L), np.int32)
        for i, t in enumerate(token_lists):
            pad = L - len(t)
            toks[i, pad:] = t                                # left padding
            pos[i] = np.arange(L) - pad + pos_offset
            pos[i, :pad] = -1      # pads masked (never overlap the prefix)
        if cache is None:
            cache = MDL.init_cache(self.cfg, B, self.max_len,
                                   device=self.device)
        logits, cache = MDL.forward(
            self.cfg, self.params,
            {"tokens": self._tensor(toks), "positions": self._tensor(pos)},
            mode="prefill", cache=cache, extend_offset=offset, last_only=True)
        if "row_idx" in cache or row_idx_mode:
            cache["row_idx"] = torch.full((B,), offset + L, dtype=torch.int32,
                                          device=self.device)
        lens = np.array([pos_offset + len(t) for t in token_lists], np.int32)
        return logits[:, -1].float(), cache, lens, B * L

    def _dense_cache_bytes(self, cache: dict) -> int:
        return int(cache["k"].numel() * cache["k"].element_size()
                   + cache["v"].numel() * cache["v"].element_size()) \
            if "k" in cache else 0

    # ----------------------------- prefix memo --------------------------------
    def _prefix_memo_get(self, key) -> Optional[_PrefixEntry]:
        ent = self._prefix_kv.get(key)
        if ent is not None:
            del self._prefix_kv[key]           # touch-on-get: move to MRU end
            self._prefix_kv[key] = ent
        return ent

    def _prefix_memo_put(self, key, ent: _PrefixEntry) -> None:
        while len(self._prefix_kv) >= max(1, self.prefix_memo_entries):
            old = self._prefix_kv.pop(next(iter(self._prefix_kv)))
            if old.pages is not None and self._alloc is not None:
                self._alloc.release(old.pages)   # refcounted: in-flight
                old.pages = None                 # users keep them alive
        self._prefix_kv[key] = ent

    def _prefix_entry_for(self, prefix_text: str, stats: GenStats
                          ) -> _PrefixEntry:
        """Memo lookup; on miss the prefix is prefilled ONCE (batch=1)."""
        ids = TOK.encode(prefix_text)
        key = (prefix_text, self.max_len)
        ent = self._prefix_memo_get(key)
        if ent is None:
            _, cache1, _, _ = self._prefill([ids])
            ent = _PrefixEntry(kv=cache1, off=int(cache1["idx"]),
                               real_len=len(ids))
            self._prefix_memo_put(key, ent)
            stats.prefill_tokens += len(ids)
        else:
            stats.prefix_hits += 1
        return ent

    def prefix_cache_for(self, prefix_text: str, batch: int):
        """Prefill the shared instruction prefix ONCE (batch=1), memoize,
        broadcast (copy) to the row batch: K/V and, for the ssm and hybrid
        families, the SSM state after the prefix, so each row's suffix
        prefill continues it.  The copies are new tensors, so the memo's
        are never written.  Returns (cache, offset, real_len,
        new_prefill_tokens, hit)."""
        ids = TOK.encode(prefix_text)
        probe = GenStats()
        ent = self._prefix_entry_for(prefix_text, probe)
        hit = probe.prefix_hits > 0
        cache = {"idx": ent.kv["idx"]}
        for k, v in ent.kv.items():
            if k == "slot_pos":                              # (1, lc)
                cache[k] = v.repeat(batch, 1)
            elif k != "idx":                                 # (ln, 1, ...)
                cache[k] = v.repeat(1, batch, *[1] * (v.dim() - 2))
        return cache, ent.off, ent.real_len, (0 if hit else len(ids)), hit

    def prefix_pages_for(self, prefix_text: str, stats: GenStats
                         ) -> Tuple[List[int], int, List[int]]:
        """Paged layout: resolve the shared prefix to pool pages.  Only
        FULL pages are shared (every referencing row reads them in place);
        the sub-page tail rides with each row's suffix so rows never write
        into a shared page.  Returns (page_ids, shared_token_count,
        tail_token_ids)."""
        ids = TOK.encode(prefix_text)
        ps = self.page_size
        n_share = (len(ids) // ps) * ps
        if n_share == 0:
            return [], 0, ids
        npre = n_share // ps
        peek = self._prefix_kv.get((prefix_text, self.max_len))
        if (peek is None or peek.pages is None) and not self._ensure_pool(npre):
            # pinned pool too small to ever share: bail BEFORE the memo so
            # no batch=1 prefill is wasted and no phantom prefix_hits are
            # counted for reuse that cannot physically happen
            return [], 0, ids
        ent = self._prefix_entry_for(prefix_text, stats)
        if ent.pages is None:
            pages = self.alloc_pages(npre)
            cfg = self.cfg
            # prefill wrote the bucketed sequence at slots 0..off-1 with the
            # left padding first: token t lives at slot (off - len) + t
            pad = ent.off - len(ids)
            shp = (cfg.num_layers, npre, ps, cfg.num_kv_heads, cfg.head_dim)
            pg = self._index(pages)
            for kk in ("k", "v"):
                # (ln, npre·ps, kv, hd) → (ln, kv, npre, ps, hd)
                src = ent.kv[kk][:, 0, pad:pad + n_share].reshape(shp)
                self._pool[kk][:, :, pg] = src.permute(0, 3, 1, 2, 4).to(
                    self._pool[kk].dtype)
            ent.pages = pages
        return list(ent.pages), n_share, ids[n_share:]

    # ------------------------------ page pool ---------------------------------
    def _index(self, ids: Sequence[int]) -> torch.Tensor:
        return torch.tensor(list(ids), dtype=torch.long, device=self.device)

    def _page_bytes(self) -> int:
        cfg = self.cfg
        itemsize = 2 if cfg.compute_dtype in ("bfloat16", "float16") else 4
        return (2 * cfg.num_layers * self.page_size * cfg.num_kv_heads
                * cfg.head_dim * itemsize)

    def _page_bytes_quant(self) -> int:
        """Logical bytes of a frozen int8 page (scales are negligible)."""
        cfg = self.cfg
        return (2 * cfg.num_layers * self.page_size * cfg.num_kv_heads
                * cfg.head_dim)

    def _note_kv(self) -> None:
        """Fold the pool's current logical KV footprint into the running
        peak: live pages at full precision, frozen pages at int8."""
        a = self._alloc
        if a is None:
            return
        nq = 0
        if self._quant_flags is not None:
            nq = int(np.sum((self._quant_flags[:a.num_pages] > 0)
                            & (a._ref[:a.num_pages] > 0)))
        cur = (a.in_use - nq) * self._page_bytes() \
            + nq * self._page_bytes_quant()
        self.kv_peak_bytes = max(self.kv_peak_bytes, cur)

    def _set_quant_flags(self, ids: Sequence[int], value: int) -> None:
        self._quant_flags[np.asarray(ids, np.int64)] = value
        self._quant_flags_dev = None           # re-sent before the next call

    # page lifecycle wrappers: every allocation flows through here so quant
    # flags are reset on reuse and the kv-bytes peak is tracked in one place
    def alloc_pages(self, n: int) -> List[int]:
        ids = self._alloc.alloc(n)
        if self._quant_flags is not None and ids:
            self._set_quant_flags(ids, 0)
        self._note_kv()
        return ids

    def retain_pages(self, ids: Sequence[int]) -> None:
        self._alloc.retain(ids)

    def release_pages(self, ids: Sequence[int]) -> None:
        self._alloc.release(ids)

    def copy_pages(self, srcs: Sequence[int], dsts: Sequence[int]) -> None:
        """Copy-on-write privatization: batched device copy of fp pages
        (COW sources are live, never-quantized pages by construction).  The
        gather of every source completes before the first write."""
        if not srcs:
            return
        s, d = self._index(srcs), self._index(dsts)
        for kk in ("k", "v"):
            self._pool[kk][:, :, d] = self._pool[kk][:, :, s]

    def _quantize_pages(self, pages: Sequence[int]) -> None:
        """Quantize-on-commit: symmetric per-(layer, kv-head, page) int8
        with scale = abs-max / 127 (round half to even, as jnp.round),
        written to the shadow pool.  Only ever called for freshly
        tree-committed (frozen) pages; the fp copy stays authoritative until
        the flag flips, and the very next model call reads the quantized
        form."""
        if not pages:
            return
        pg = self._index(pages)
        for kk, qk, sk in (("k", "kq", "kscale"), ("v", "vq", "vscale")):
            src = self._pool[kk][:, :, pg].float()      # (ln, kv, n, ps, hd)
            amax = src.abs().amax(dim=(3, 4))           # (ln, kv, n)
            scale = torch.clamp(amax, min=1e-8) / 127.0
            qv = torch.clamp(torch.round(src / scale[..., None, None]),
                             -127, 127).to(torch.int8)
            self._pool[qk][:, :, pg] = qv
            self._pool[sk][:, :, pg] = scale
        self._set_quant_flags(pages, 1)
        self._note_kv()

    def _ensure_pool(self, need_pages: int) -> bool:
        """Make `need_pages` allocatable: create the pool lazily, then free
        pages by dropping LRU prefix residencies, then grow the device
        tensors — unless the operator pinned `page_pool_pages`, in which
        case the pool is a hard memory bound and False is returned when the
        demand cannot fit (callers wait for slot frees or raise).  Growth
        reallocates the pool tensors: callers read `self._pool` afresh."""
        quant = self.kv_quant == "int8"
        if self._pool is None:
            n = self.page_pool_pages or \
                max(2 * need_pages, 2 * self.num_table_blocks)
            n = max(n, 1)
            if self.page_pool_pages is None:
                n = max(n, need_pages)
            self._pool = MDL.init_paged_cache(self.cfg, n, self.page_size,
                                              quant=quant, device=self.device)
            self._alloc = PageAllocator(n)
            if quant:
                self._quant_flags = np.zeros(n, np.int8)
            if self.prefix_cache_mode == "radix":
                self._radix = RadixPrefixCache(self._alloc, self.page_size)
            return self._alloc.free_pages >= need_pages
        a = self._alloc
        if a.free_pages >= need_pages:
            return True
        for key in list(self._prefix_kv):      # LRU-first residency drop
            if a.free_pages >= need_pages:
                break
            ent = self._prefix_kv[key]
            # skip entries whose pages an in-flight run still retains:
            # releasing the memo's reference would free nothing while
            # permanently discarding the zero-copy residency
            if ent.pages is not None and \
                    all(a.refs(p) == 1 for p in ent.pages):
                a.release(ent.pages)
                ent.pages = None
        if a.free_pages < need_pages and self._radix is not None:
            # radix eviction: LRU leaf nodes with no outside readers
            self._radix.evict(need_pages - a.free_pages)
        if a.free_pages >= need_pages:
            return True
        if self.page_pool_pages is not None:
            return False                       # pinned pool: hard bound
        extra = max(need_pages - a.free_pages, a.num_pages // 2)
        for kk, pool in self._pool.items():
            # page axis of the (ln, KV, P, ...) layout
            pad = torch.zeros(pool.shape[:2] + (extra,) + pool.shape[3:],
                              dtype=pool.dtype, device=pool.device)
            self._pool[kk] = torch.cat([pool, pad], dim=2)
        if self._quant_flags is not None:
            self._quant_flags = np.concatenate(
                [self._quant_flags, np.zeros(extra, np.int8)])
            self._quant_flags_dev = None
        a.grow(extra)
        return True

    def _ssm_state(self, batch: int) -> Dict[str, torch.Tensor]:
        """Zero per-row SSM state of a paged run (``conv``, ``h``; shapes
        from ``model.paged_cache_specs``), {} without a mixer."""
        if not self.cfg.has_ssm:
            return {}
        specs = MDL.paged_cache_specs(self.cfg, 1, self.page_size,
                                      batch=batch)
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in specs.items() if k in ("conv", "h")}

    # ------------------------------ radix cache --------------------------------
    def radix_match(self, ids: Sequence[int], stats: GenStats,
                    limit: Optional[int] = None) -> Tuple[List[int], int]:
        """Deepest page-aligned prefix of `ids` resident in the radix tree.
        Returned pages are retained for the caller (release when done)."""
        if self._radix is None:
            return [], 0
        pages, n = self._radix.match(ids, limit=limit)
        if n:
            stats.prefix_hits += 1
            stats.radix_hit_tokens += n
        return pages, n

    def radix_insert(self, ids: Sequence[int], pages: Sequence[int]
                     ) -> List[int]:
        """Commit the full-page span of `ids` (backed by `pages`) to the
        radix tree; newly adopted pages are frozen and, in int8 mode,
        quantized on the spot."""
        if self._radix is None:
            return []
        nfull = len(ids) // self.page_size
        if nfull == 0:
            return []
        adopted = self._radix.insert(
            list(ids[:nfull * self.page_size]), list(pages[:nfull]))
        if adopted and self.kv_quant == "int8":
            self._quantize_pages(adopted)
        return adopted

    # -- warm-state snapshots (core/snapshot.py) -------------------------
    def export_radix_state(self) -> Optional[dict]:
        """Host-side payload of the radix prefix cache: every node's full
        root-to-node token path plus the fp KV of its own pages (float32
        numpy, (layers, KV, pages, ps, head_dim)), in parent-before-child
        order so a restore can rebuild the tree with plain `radix_insert`
        calls.  int8 shadow pages are NOT exported — restore re-quantizes
        adopted pages from the fp data, yielding the identical quantized
        form.  None when nothing is resident (and always for the dense
        layout, which holds no tree)."""
        if self._radix is None or self._pool is None:
            return None
        entries = []
        stack = [(self._radix._root, ())]
        order = []
        while stack:
            node, path = stack.pop()
            if node.key:
                order.append((node, path + tuple(node.key)))
            for c in node.children.values():
                stack.append((c, path + tuple(node.key)))
        # DFS pop order is not parent-first for siblings' subtrees; sort
        # by path length, which is: a parent's path is a strict prefix
        # (hence strictly shorter) than any descendant's
        order.sort(key=lambda t: len(t[1]))
        for node, path in order:
            pg = self._index(node.pages)
            entries.append({
                "path": list(path),
                "k": self._pool["k"][:, :, pg].float().cpu().numpy(),
                "v": self._pool["v"][:, :, pg].float().cpu().numpy(),
            })
        if not entries:
            return None
        return {"page_size": self.page_size, "entries": entries}

    def restore_radix_state(self, payload: dict) -> int:
        """Rebuild the radix tree from an `export_radix_state` payload on
        a (typically fresh) engine: alloc pages, write the KV back, and
        commit each node with `radix_insert` (which re-freezes and, in
        int8 mode, re-quantizes the adopted pages).  The payload's last
        axis is cut to head_dim, so a snapshot of the JAX engine, whose
        pool pads head_dim to 128 lanes, restores too.  Returns the number
        of pages restored; a payload from a different page-size geometry
        is ignored."""
        if not payload or int(payload.get("page_size", -1)) != self.page_size:
            return 0
        ps = self.page_size
        hd = self.cfg.head_dim
        restored = 0
        pages_for_path: Dict[Tuple[int, ...], List[int]] = {(): []}
        for ent in payload.get("entries", []):
            path = tuple(int(t) for t in ent["path"])
            k_host, v_host = ent["k"], ent["v"]
            own_np = int(k_host.shape[2])
            parent_path = path[: len(path) - own_np * ps]
            parent_pages = pages_for_path.get(parent_path)
            if parent_pages is None or len(path) % ps:
                continue               # orphaned entry: skip defensively
            if not self._ensure_pool(own_np):
                break                  # pinned pool exhausted: partial warm
            own = self.alloc_pages(own_np)
            pg = self._index(own)
            for kk, host in (("k", k_host), ("v", v_host)):
                src = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(host, np.float32)[..., :hd]))
                self._pool[kk][:, :, pg] = src.to(self.device,
                                                  self._pool[kk].dtype)
            full_pages = list(parent_pages) + list(own)
            self.radix_insert(list(path), full_pages)
            # the tree now holds its own reference to the adopted pages;
            # drop ours so restored nodes are plain LRU-evictable leaves
            self.release_pages(own)
            pages_for_path[path] = full_pages
            restored += own_np
        self._note_kv()
        return restored

    # ----------------------------- paged steps --------------------------------
    def _paged_cache(self, table: np.ndarray, pos: np.ndarray) -> dict:
        """The model's view of the pool for one call with positions `pos`
        (B, S): the current pool tensors (growth may have replaced them),
        the block table, the page-write indices and, with int8 pages, the
        device copy of the frozen flags.  The writes are those of the tokens
        whose block j = pos // ps has a page in the row's table, as (4, n)
        (row, token, page, offset); pads (pos < 0), blocks past the table
        (past max_len the sequence decodes against a frozen cache) and -1
        entries are left out, where the JAX model sends them out of bounds
        with mode="drop".  They are found here on the host, so the forward
        needs no device-to-host sync for them."""
        table = np.ascontiguousarray(table, np.int32)
        ps, NB = self.page_size, table.shape[1]
        blk = np.maximum(pos, 0) // ps
        entry = np.take_along_axis(table, np.minimum(blk, NB - 1), axis=1)
        rows, toks = np.nonzero((pos >= 0) & (blk < NB) & (entry >= 0))
        writes = np.stack([rows, toks, entry[rows, toks],
                           pos[rows, toks] % ps]).astype(np.int64)
        cache = dict(self._pool, block_tables=self._tensor(table),
                     writes=self._tensor(writes))
        if self._quant_flags is not None:
            if self._quant_flags_dev is None:
                self._quant_flags_dev = self._tensor(self._quant_flags)
            cache["quant_flags"] = self._quant_flags_dev
        return cache

    def paged_prefill(self, token_lists: List[List[int]], table_rows,
                      prefix_pages: Sequence[int], prefix_len: int, *,
                      extra: Optional[dict] = None, **attn):
        """Prefill suffixes straight into their block-table pages, reading
        shared prefix pages in place (no per-row replication).  table_rows:
        np.ndarray (B, NB) page ids; `extra` the rows' SSM state (hybrid
        family; ``_ssm_state``), continued and overwritten in place; `attn`
        overrides the model's attention functions and scan (``forward``'s
        ``attn_fn``, ``prefix_attn_fn``, ``scan_fn``).  Returns (float32
        last-token logits (B, Vp) on the device, lens, prefill token count,
        the SSM state: extra's tensors, {} without)."""
        B = len(token_lists)
        L = _bucket(max(len(t) for t in token_lists))
        toks = np.full((B, L), TOK.PAD_ID, np.int32)
        pos = np.zeros((B, L), np.int32)
        for i, t in enumerate(token_lists):
            pad = L - len(t)
            toks[i, pad:] = t
            pos[i] = np.arange(L) - pad + prefix_len
            pos[i, :pad] = -1
        cache = self._paged_cache(table_rows, pos)
        cache["prefix_table"] = self._tensor(
            np.asarray(prefix_pages, np.int32).reshape(len(prefix_pages)))
        cache["prefix_len"] = int(prefix_len)
        cache.update(extra or {})
        logits, _ = MDL.forward(
            self.cfg, self.params,
            {"tokens": self._tensor(toks), "positions": self._tensor(pos)},
            mode="prefill", cache=cache, last_only=True, **attn)
        lens = np.array([prefix_len + len(t) for t in token_lists], np.int32)
        return logits[:, -1].float(), lens, B * L, dict(extra or {})

    def paged_decode(self, toks, positions, table, num_blocks: int, *,
                     extra: Optional[dict] = None, **attn
                     ) -> Tuple[torch.Tensor, dict]:
        """One lock-step decode tick against the page pool.  `table` is the
        host block table (B, NB_full); only its first `num_blocks` columns
        (the batch's actual fill, bucketed by the caller) reach the device,
        so attention work scales with occupancy, not max_len.  `extra` as
        in paged_prefill; `attn` overrides the model's paged decode
        attention and scan (``forward``'s ``paged_decode_attn_fn``,
        ``scan_fn``).  Returns (float32 logits (B, Vp) on the device, the
        SSM state)."""
        pos = positions.astype(np.int32)[:, None]
        cache = self._paged_cache(table[:, :num_blocks], pos)
        cache.update(extra or {})
        logits, _ = MDL.forward(
            self.cfg, self.params,
            {"tokens": self._tensor(toks.astype(np.int32)[:, None]),
             "positions": self._tensor(pos)},
            mode="decode", cache=cache, **attn)
        return logits[:, 0].float(), dict(extra or {})

    def active_blocks(self, fills) -> int:
        """Bucketed block count covering the given fill levels (pow-2, as
        the JAX engine buckets its decode-step jit caches)."""
        need = max(1, max((int(f) // self.page_size) + 1 for f in fills))
        nb = 1
        while nb < need:
            nb *= 2
        return min(nb, self.num_table_blocks)

    # ------------------------------- generate ---------------------------------
    @staticmethod
    def _consume_tokens(toks, gs, states, out_tokens, done,
                        stats: GenStats) -> None:
        """Apply one sampled token per not-yet-done row: grammar advance,
        EOS, completion + per-tick stats."""
        for i in range(len(done)):
            if done[i]:
                continue
            t = int(toks[i])
            if gs[i] is not None:
                states[i] = gs[i].advance(states[i], t)
                if t != TOK.EOS_ID:
                    out_tokens[i].append(t)
                if gs[i].done(states[i]):
                    done[i] = True
            else:
                if t == TOK.EOS_ID:
                    done[i] = True
                else:
                    out_tokens[i].append(t)
        stats.decode_steps += 1
        stats.output_tokens += int((~done).sum())

    def generate(self, prompts: Sequence[str], *,
                 grammar: Optional[JsonGrammar] = None,
                 grammars: Optional[List[JsonGrammar]] = None,
                 max_new_tokens: int = 256, temperature: float = 0.0,
                 shared_prefix: str = "") -> GenResult:
        """Generate for a batch of prompts. If shared_prefix is given it is
        prefilled once and KV-reused across rows (prompts are then the
        suffixes). Grammar-constrained when grammar(s) provided."""
        t0 = time.time()
        stats = GenStats(calls=1)
        B = len(prompts)
        gs = grammars or ([grammar] * B if grammar else [None] * B)
        states = [g.init_state() if g else None for g in gs]

        if self.kv_layout == "paged":
            texts = self._generate_paged(prompts, gs, states, max_new_tokens,
                                         temperature, shared_prefix, stats)
            stats.wall_s = time.time() - t0
            self.total.add(stats)
            return GenResult(texts, stats)

        offset = 0
        pos_offset = None
        cache = None
        if shared_prefix:
            cache, offset, pos_offset, new_prefix_toks, hit = \
                self.prefix_cache_for(shared_prefix, B)
            stats.prefill_tokens += new_prefix_toks
            stats.prefix_hits += int(hit)
            stats.input_tokens += TOK.count_tokens(shared_prefix)

        token_lists = [TOK.encode(p, bos=not shared_prefix) for p in prompts]
        stats.input_tokens += sum(len(t) for t in token_lists)
        logits, cache, lens, pre = self._prefill(
            token_lists, offset=offset, pos_offset=pos_offset,
            cache=cache, row_idx_mode=True)
        stats.prefill_tokens += pre
        stats.kv_bytes = self._dense_cache_bytes(cache)

        out_tokens: List[List[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        positions = lens.copy()

        for step in range(max_new_tokens):
            toks = self._sample(logits, gs, states, temperature)
            self._consume_tokens(toks, gs, states, out_tokens, done, stats)
            if done.all():
                break
            logits, cache = self.decode_step(toks, positions, cache)
            positions += 1

        stats.wall_s = time.time() - t0
        self.total.add(stats)
        return GenResult([TOK.decode(t) for t in out_tokens], stats)

    def _generate_paged(self, prompts, gs, states, max_new_tokens,
                        temperature, shared_prefix, stats: GenStats
                        ) -> List[str]:
        """Paged-layout generate: per-row block tables over the global page
        pool.  prefix_cache_mode="exact": a shared prefix resolves through
        the exact-string memo and contributes the SAME page ids to every
        row's table.  "radix": the batch-common token prefix is matched
        against the radix tree (discovering partial overlap with ANY prior
        prompt), suffix prefill starts at the deepest matched page, and the
        rows' full prompt pages are committed back to the tree."""
        B = len(prompts)
        ps = self.page_size
        NBf = self.num_table_blocks
        cap = NBf * ps

        pages_pre: List[int] = []
        n_share = 0
        if self.prefix_cache_mode == "radix":
            self._ensure_pool(0)               # materialize pool + tree
            token_lists = [TOK.encode(shared_prefix + p) if shared_prefix
                           else TOK.encode(p) for p in prompts]
            if shared_prefix:
                stats.input_tokens += TOK.count_tokens(shared_prefix)
                npre_tok = len(TOK.encode(shared_prefix))
            else:
                npre_tok = 0
            stats.input_tokens += sum(len(t) - npre_tok for t in token_lists)
            # batch-common token prefix, leaving >= 1 suffix token per row
            common = list(token_lists[0])
            for t in token_lists[1:]:
                n = 0
                while n < len(common) and n < len(t) and common[n] == t[n]:
                    n += 1
                common = common[:n]
            aligned = min(len(common), min(len(t) for t in token_lists) - 1)
            aligned = (aligned // ps) * ps
            pages_pre, n_share = self.radix_match(common, stats,
                                                  limit=aligned)
            if B >= 2 and n_share < aligned and \
                    self._ensure_pool((aligned - n_share) // ps):
                # seed prefill: materialize the still-missing span of the
                # batch-common prefix ONCE (batch=1) and commit it, so the
                # per-row prefills below all start at `aligned`
                seed = self.alloc_pages((aligned - n_share) // ps)
                st = np.full((1, NBf), -1, np.int32)
                st[0, :n_share // ps] = pages_pre
                st[0, n_share // ps:aligned // ps] = seed
                _, _, pre, _ = self.paged_prefill(
                    [common[n_share:aligned]], st, pages_pre, n_share,
                    extra=self._ssm_state(1))
                stats.prefill_tokens += pre
                self.radix_insert(common[:aligned],
                                  list(st[0, :aligned // ps]))
                pages_pre = pages_pre + seed   # run holds one ref on each
                n_share = aligned
            token_lists = [t[n_share:] for t in token_lists]
        elif shared_prefix:
            pages_pre, n_share, tail = self.prefix_pages_for(
                shared_prefix, stats)
            stats.input_tokens += TOK.count_tokens(shared_prefix)
            token_lists = [tail + TOK.encode(p, bos=False) for p in prompts]
            stats.input_tokens += sum(len(t) - len(tail)
                                      for t in token_lists)
            if self._alloc is not None and pages_pre:
                self.retain_pages(pages_pre)   # survive memo eviction
        else:
            token_lists = [TOK.encode(p) for p in prompts]
            stats.input_tokens += sum(len(t) for t in token_lists)

        npre = len(pages_pre)
        table = np.full((B, NBf), -1, np.int32)
        if npre:
            table[:, :npre] = pages_pre        # shared: same ids every row
        owned: List[List[int]] = []
        try:
            need_each = [max(0, -(-min(n_share + len(t) + max_new_tokens,
                                       cap) // ps) - npre)
                         for t in token_lists]
            if not self._ensure_pool(sum(need_each)):
                raise RuntimeError(
                    f"page pool ({self.page_pool_pages} pages) too small "
                    f"for batch of {B} rows")
            for i, need in enumerate(need_each):
                ids = self.alloc_pages(need)
                owned.append(ids)
                table[i, npre:npre + need] = ids

            # the rows' SSM state starts from zeros after the shared pages:
            # the SSM never sees a radix-matched or memoised prefix (the
            # JAX engine's semantics)
            logits, lens, pre, extra = self.paged_prefill(
                token_lists, table, pages_pre, n_share,
                extra=self._ssm_state(B))
            stats.prefill_tokens += pre
            if self.prefix_cache_mode == "radix":
                # commit every row's full-page prompt span (clamped to the
                # pages actually allocated when the row is capacity-bound);
                # identical or overlapping rows dedup inside the tree
                for i, t in enumerate(token_lists):
                    nfull = min((n_share + len(t)) // ps,
                                npre + need_each[i])
                    if nfull > npre:
                        self.radix_insert((common[:n_share] + t)[:nfull * ps],
                                          list(table[i, :nfull]))

            out_tokens: List[List[int]] = [[] for _ in range(B)]
            done = np.zeros(B, bool)
            positions = lens.copy()

            for step in range(max_new_tokens):
                toks = self._sample(logits, gs, states, temperature)
                self._consume_tokens(toks, gs, states, out_tokens, done,
                                     stats)
                if done.all():
                    break
                nb = self.active_blocks(positions[~done])
                logits, extra = self.paged_decode(toks, positions, table, nb,
                                                  extra=extra)
                positions += 1
        finally:
            # errors must not leak refcounts: a pinned pool would shrink
            # permanently
            for ids in owned:
                self.release_pages(ids)
            if pages_pre:
                self.release_pages(pages_pre)
        self._note_kv()
        stats.kv_bytes = self.kv_peak_bytes
        return [TOK.decode(t) for t in out_tokens]

    # ------------------------------- sampling ---------------------------------
    def _sample(self, logits: torch.Tensor, gs, states, temperature: float
                ) -> np.ndarray:
        """Grammar-masked (Gumbel-)argmax of device logits (B, V): the mask
        is built on the host, the noise drawn from the engine's numpy rng
        exactly as the JAX engine draws it, and the fused kernel picks the
        tokens on the device.  Returns (B,) int32 on the host."""
        B, V = logits.shape
        mask = np.ones((B, V), np.int8)
        for i, (g, st) in enumerate(zip(gs, states)):
            if g is not None:
                m = g.mask(st)
                mask[i, :] = 0
                mask[i, :len(m)] = m
        noise = None
        if temperature > 0:
            u = self._rng.uniform(1e-9, 1.0, size=(B, V))
            noise = self._tensor(-np.log(-np.log(u)))
        toks = KOPS.constrained_sample(
            logits.contiguous(), self._tensor(mask), noise,
            temperature=temperature if temperature > 0 else 1.0)
        return toks.cpu().numpy()
