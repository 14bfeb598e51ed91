"""In-process LLM serving engine on PyTorch — the local model executor the
PREDICT operator drives (port of ``repro/serving/engine.py``, dense layout).

  * batched prefill (bucketed lengths, left padding) + lock-step decode
  * grammar-constrained decoding: per-step masks from serving.grammar,
    applied on the card by the fused constrained-sample kernel
  * shared-prefix KV reuse: the instruction prefix of a marshaled prompt is
    prefilled once (batch=1), memoized in an LRU, and broadcast to the row
    batch (``kv_layout="dense"``)
  * per-row cache write cursors for continuous batching (scheduler.py)

The paged layout (page pool, radix tree, int8 pages) is not ported yet.
Logits stay on the device; only the sampled token ids come back to the host.
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


@dataclasses.dataclass
class _PrefixEntry:
    """Memoized shared-prefix KV: the batch=1 prefill cache of the prefix.
    Never written to — `prefix_cache_for` hands out copies, since decode
    updates caches in place."""
    kv: dict
    off: int                        # bucketed prefix length (dense slots)
    real_len: int                   # true token count


class InferenceEngine:
    """Single-device engine around one dense model.  `device` None means
    CUDA (raises without a GPU); tests pass ``device="cpu"``, where the
    kernel wrappers run their plain PyTorch versions."""

    #: capacity of the shared-prefix LRU memo
    PREFIX_MEMO_ENTRIES = 16

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 seed: int = 0, max_len: int = 1024, kv_layout: str = "dense",
                 device=None):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} cannot generate")
        if kv_layout == "paged":
            raise NotImplementedError("paged KV: see ROADMAP")
        if kv_layout != "dense":
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        self.kv_layout = kv_layout
        self.params = params if params is not None else init_params(
            cfg, torch.Generator(device=self.device).manual_seed(seed),
            self.device)
        #: LRU memo of shared-prefix KV (touch-on-get, capped — mirrors
        #: PromptCache semantics)
        self._prefix_kv: Dict[Tuple[str, int], _PrefixEntry] = {}
        self._rng = np.random.default_rng(seed)
        #: session-cumulative stats (EXPLAIN `-- dispatch --` surfacing)
        self.total = GenStats()

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
        while len(self._prefix_kv) >= self.PREFIX_MEMO_ENTRIES:
            self._prefix_kv.pop(next(iter(self._prefix_kv)))
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
        broadcast (copy) to the row batch.  Returns (cache, offset,
        real_len, new_prefill_tokens, hit)."""
        ids = TOK.encode(prefix_text)
        probe = GenStats()
        ent = self._prefix_entry_for(prefix_text, probe)
        hit = probe.prefix_hits > 0
        c1 = ent.kv
        cache = {"idx": c1["idx"],
                 "k": c1["k"].repeat(1, batch, 1, 1, 1),    # (ln, B, lc, ...)
                 "v": c1["v"].repeat(1, batch, 1, 1, 1),
                 "slot_pos": c1["slot_pos"].repeat(batch, 1)}
        return cache, ent.off, ent.real_len, (0 if hit else len(ids)), hit

    def export_radix_state(self) -> None:
        """Warm-state snapshots export the paged layout's radix tree; the
        dense layout holds none."""
        return None

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
