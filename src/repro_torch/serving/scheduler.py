"""Slot-based continuous batching on top of InferenceEngine (port of
``repro/serving/scheduler.py``).

A fixed decode batch of `num_slots` sequences runs lock-step decode ticks;
finished slots are immediately refilled by prefilling queued requests into
the slot's cache rows (per-row cache indices make ragged fill levels safe).
Slot eviction doubles as straggler mitigation: a request exceeding its token
budget is cut off with `error` set, without stalling the batch.

Two KV layouts (engine.kv_layout):
  * dense — each slot owns a contiguous max_len cache row, so a shared
    instruction prefix is prefilled again for every slot; ``n_samples > 1``
    runs as that many independent jobs.
  * paged — slots own block tables over the engine's global page pool;
    refill allocates pages, completion/eviction frees them (a pinned pool
    stalls refills until pages free up), a shared prefix is prefilled ONCE
    into pool pages that every slot's table references zero-copy, and the
    streams of an ``n_samples > 1`` request fork copy-on-write off the
    first stream's prefill.
Either way the streams' texts are majority-voted.
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import model as MDL
from repro_torch.serving import tokenizer as TOK
from repro_torch.serving.engine import GenStats, InferenceEngine, NEG_INF
from repro_torch.serving.grammar import JsonGrammar


@dataclasses.dataclass
class Request:
    prompt: str
    grammar: Optional[JsonGrammar] = None
    max_new_tokens: int = 256
    n_samples: int = 1          # >1 ⇒ self-consistency: decode n streams,
    rid: int = -1               #      majority-vote the final text
    # filled on completion:
    text: Optional[str] = None
    error: Optional[str] = None
    samples: Optional[List[str]] = None   # per-stream texts when n_samples>1


class _Job:
    """One decode stream: a (request, sample-index) pair.  Duck-types the
    Request fields the slot machinery reads but carries its own text/error
    so n_samples streams of one request complete independently.  ``group``
    ties sibling streams to a shared-prefill fork snapshot (paged layout)."""
    __slots__ = ("req", "sample", "group", "rid", "text", "error")

    def __init__(self, req: Request, sample: int,
                 group: Optional["_ForkGroup"] = None):
        self.req = req
        self.sample = sample
        self.group = group
        self.rid = req.rid
        self.text: Optional[str] = None
        self.error: Optional[str] = None

    @property
    def prompt(self) -> str:
        return self.req.prompt

    @property
    def grammar(self) -> Optional[JsonGrammar]:
        return self.req.grammar

    @property
    def max_new_tokens(self) -> int:
        return self.req.max_new_tokens


class _ForkGroup:
    """Copy-on-write fork point for one request's n_samples streams (paged
    layout).  The first stream to fill a slot prefills normally; right after
    its prefill we snapshot the block-table row, position, last-token
    logits and SSM state (hybrid family), and retain every page covering
    the prompt.  Sibling streams then
    "fork": they reference the same shared pages zero-copy and only allocate
    fresh pages for their own decode capacity — no prefill.  Shared pages
    privatize lazily via the decode-loop COW guard on first write (which
    covers the sub-page tail every stream writes into)."""

    def __init__(self, fills_left: int):
        self.fills_left = fills_left   # siblings still waiting to fork
        self.snapshot: Optional[dict] = None
        self.retained: List[int] = []  # group's own leases on shared pages

    def snap(self, eng, row: np.ndarray, pos: int,
             logits_row: torch.Tensor, extra_slice: Optional[dict]) -> None:
        nsh = -(-int(pos) // eng.page_size)      # pages covering the prompt
        shared = [int(p) for p in row[:nsh] if p >= 0]
        eng.retain_pages(shared)
        self.retained = shared
        # the slot's logits row and SSM state are overwritten in place by
        # later ticks: keep copies
        self.snapshot = {"row": row[:nsh].copy(), "nsh": nsh, "pos": int(pos),
                         "logits": logits_row.clone(),
                         "extra": {k: v.clone() for k, v in
                                   (extra_slice or {}).items()}}

    def done_fill(self, eng) -> None:
        self.fills_left -= 1
        if self.fills_left <= 0:
            self.release(eng)

    def release(self, eng) -> None:
        if self.retained:
            eng.release_pages(self.retained)
            self.retained = []


def _vote(texts: Sequence[str]) -> str:
    """Majority text; ties break toward the earliest stream (Counter's
    most_common is insertion-stable)."""
    return Counter(texts).most_common(1)[0][0]


class ContinuousBatcher:
    def __init__(self, engine: InferenceEngine, num_slots: int = 8):
        self.engine = engine
        self.num_slots = num_slots
        self.stats = GenStats()

    def run(self, requests: Sequence[Request], *, temperature: float = 0.0,
            shared_prefix: str = "") -> List[Request]:
        """Process all requests to completion; returns them (order kept).
        `shared_prefix` is prepended to every prompt: the dense layout
        prefills it per slot, the paged layout prefills it once into shared
        pool pages."""
        st = GenStats(calls=1)
        t0 = time.time()
        reqs = list(requests)
        paged = self.engine.kv_layout == "paged"
        jobs: List[_Job] = []
        for i, r in enumerate(reqs):
            r.rid = i
            ns = max(1, r.n_samples)
            grp = _ForkGroup(ns - 1) if (ns > 1 and paged) else None
            jobs.extend(_Job(r, k, grp) for k in range(ns))
        if paged:
            self._run_paged(jobs, temperature, shared_prefix, st)
        else:
            self._run_dense(jobs, temperature, shared_prefix, st)
        self._reduce(reqs, jobs)
        st.wall_s = time.time() - t0
        self.stats.add(st)
        self.engine.total.add(st)
        return reqs

    @staticmethod
    def _reduce(reqs: List[Request], jobs: List[_Job]) -> None:
        """Fold per-stream results back onto their requests: single-stream
        requests copy through; multi-sample requests keep every stream in
        `samples` and majority-vote the final text (self-consistency)."""
        by_req: Dict[int, List[_Job]] = {}
        for j in jobs:
            by_req.setdefault(j.rid, []).append(j)
        for r in reqs:
            js = sorted(by_req[r.rid], key=lambda j: j.sample)
            if len(js) == 1:
                r.text, r.error = js[0].text, js[0].error
                continue
            r.samples = [j.text for j in js]
            ok = [j.text for j in js if j.error is None and j.text is not None]
            if ok:
                r.text = _vote(ok)
                r.error = None
            else:
                r.text, r.error = js[0].text, js[0].error

    # ---------------------------- per-tick advance ----------------------------
    @staticmethod
    def _advance_live(live, active, states, outs, budgets, toks, st, logits,
                      on_finish) -> int:
        """Consume one sampled token per live slot: grammar advance, EOS,
        token-budget eviction, completion.  Returns the number of slots that
        finished."""
        done = 0
        for b in live:
            r = active[b]
            t = int(toks[b])
            if r.grammar is not None:
                states[b] = r.grammar.advance(states[b], t)
                if t != TOK.EOS_ID:
                    outs[b].append(t)
                finished = r.grammar.done(states[b])
            else:
                finished = t == TOK.EOS_ID
                if not finished:
                    outs[b].append(t)
            budgets[b] -= 1
            st.output_tokens += 1
            if budgets[b] <= 0 and not finished:
                r.error = "token budget exceeded (slot evicted)"
                finished = True
            if finished:
                r.text = TOK.decode(outs[b])
                active[b] = None
                done += 1
                logits[b] = NEG_INF
                on_finish(b)
        return done

    # ------------------------------- dense ------------------------------------
    def _run_dense(self, reqs: List[_Job], temperature: float,
                   shared_prefix: str, st: GenStats) -> None:
        eng = self.engine
        queue = list(reqs)
        B = self.num_slots

        cache = MDL.init_cache(eng.cfg, B, eng.max_len, include_row_idx=True,
                               device=eng.device)
        st.kv_bytes = eng._dense_cache_bytes(cache)
        active: List[Optional[_Job]] = [None] * B
        states = [None] * B
        outs: List[List[int]] = [[] for _ in range(B)]
        budgets = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int32)
        #: last-token logits per slot, kept on the device
        logits = torch.full((B, eng.cfg.padded_vocab), NEG_INF,
                            dtype=torch.float32, device=eng.device)

        def fill_slot(b: int, job: _Job) -> None:
            ids = TOK.encode(shared_prefix + job.prompt)
            lg, c1, lens, pre = eng._prefill([ids], row_idx_mode=True)
            st.prefill_tokens += pre
            st.input_tokens += len(ids)
            # splice sequence 0 of c1 into slot b of the live cache (in place)
            for k in ("k", "v", "conv", "h"):               # (L, B, ...)
                if k in cache:
                    cache[k][:, b] = c1[k][:, 0]
            for k in ("slot_pos", "row_idx"):               # (B, ...)
                if k in cache:
                    cache[k][b] = c1[k][0]
            active[b] = job
            states[b] = job.grammar.init_state() if job.grammar else None
            outs[b] = []
            budgets[b] = job.max_new_tokens
            positions[b] = lens[0]
            logits[b] = lg[0][:logits.shape[1]]

        done_count = 0
        ticks = 0
        while done_count < len(reqs):
            # refill free slots
            for b in range(B):
                if active[b] is None and queue:
                    fill_slot(b, queue.pop(0))
            live = [b for b in range(B) if active[b] is not None]
            if not live:
                break

            gs = [active[b].grammar if active[b] else None for b in range(B)]
            toks = eng._sample(logits, gs, states, temperature)
            done_count += self._advance_live(live, active, states, outs,
                                             budgets, toks, st, logits,
                                             lambda b: None)

            if done_count >= len(reqs):
                break
            live = [b for b in range(B) if active[b] is not None]
            if not live:
                continue           # all finished this tick; refill next
            lg, cache = eng.decode_step(toks, positions, cache)
            rows = torch.tensor(live, device=eng.device)
            logits[rows] = lg[rows]
            positions += 1
            ticks += 1

        st.decode_steps += ticks

    # ------------------------------- paged ------------------------------------
    def _run_paged(self, reqs: List[_Job], temperature: float,
                   shared_prefix: str, st: GenStats) -> None:
        eng = self.engine
        ps = eng.page_size
        NBf = eng.num_table_blocks
        cap = NBf * ps
        B = self.num_slots
        queue = list(reqs)
        radix = eng.prefix_cache_mode == "radix"
        groups = {id(j.group): j.group for j in reqs if j.group is not None}

        pages_pre: List[int] = []
        n_share = 0
        tail: List[int] = []
        if shared_prefix and not radix:
            # exact mode: resolve the prefix once up front.  radix mode
            # skips this — the first fill commits the prefix pages to the
            # tree and every later fill discovers them at match time.
            pages_pre, n_share, tail = eng.prefix_pages_for(shared_prefix, st)
            if pages_pre:
                eng.retain_pages(pages_pre)

        table = np.full((B, NBf), -1, np.int32)
        slot_pages: List[List[int]] = [[] for _ in range(B)]   # owned (alloc)
        slot_shared: List[List[int]] = [[] for _ in range(B)]  # leased (retain)
        active: List[Optional[_Job]] = [None] * B
        states = [None] * B
        outs: List[List[int]] = [[] for _ in range(B)]
        budgets = np.zeros(B, np.int64)
        positions = np.zeros(B, np.int32)
        #: last-token logits per slot, kept on the device
        logits = torch.full((B, eng.cfg.padded_vocab), NEG_INF,
                            dtype=torch.float32, device=eng.device)
        #: the slots' SSM state (hybrid family), updated in place; a refill
        #: continues from what the slot's previous stream left there, as
        #: in the JAX batcher
        extra = eng._ssm_state(B)

        def place(b: int, job: _Job, pos: int, lg_row: torch.Tensor) -> None:
            active[b] = job
            states[b] = job.grammar.init_state() if job.grammar else None
            outs[b] = []
            budgets[b] = job.max_new_tokens
            positions[b] = pos
            logits[b] = lg_row[:logits.shape[1]]

        def fill_fork(b: int, job: _Job, grp: _ForkGroup) -> bool:
            """Fork a sibling stream off the group snapshot: share every
            page covering the prompt zero-copy, allocate only fresh decode
            capacity, skip prefill entirely."""
            sn = grp.snapshot
            nsh, pos = sn["nsh"], sn["pos"]
            tot = min(pos + job.max_new_tokens, cap)
            need = max(0, -(-tot // ps) - nsh)
            if not eng._ensure_pool(need):
                return False
            pg = eng.alloc_pages(need)
            shared = [int(p) for p in sn["row"] if p >= 0]
            eng.retain_pages(shared)
            slot_pages[b] = pg
            slot_shared[b] = shared
            table[b, :nsh] = sn["row"]
            table[b, nsh:nsh + need] = pg
            table[b, nsh + need:] = -1
            for k, v in sn["extra"].items():
                extra[k][:, b:b + 1] = v
            st.input_tokens += pos
            place(b, job, pos, sn["logits"])
            grp.done_fill(eng)
            return True

        def fill_slot(b: int, job: _Job) -> bool:
            """Allocate pages + prefill the slot. False ⇒ the (pinned) pool
            cannot take the request right now — it stays queued until other
            slots free pages."""
            grp = job.group
            if grp is not None and grp.snapshot is not None:
                return fill_fork(b, job, grp)
            if radix:
                ids = TOK.encode(shared_prefix + job.prompt)
                pre_pages, pre_len = eng.radix_match(ids, st)
                suffix = ids[pre_len:]
            else:
                ids = tail + TOK.encode(job.prompt, bos=not shared_prefix)
                pre_pages, pre_len = pages_pre, n_share
                suffix = ids
            nfixed = len(pre_pages)
            tot = min(pre_len + len(suffix) + job.max_new_tokens, cap)
            need = max(0, -(-tot // ps) - nfixed)
            if not eng._ensure_pool(need):
                if radix and pre_pages:
                    eng.release_pages(pre_pages)
                return False
            pg = eng.alloc_pages(need)
            slot_pages[b] = pg
            if radix:
                slot_shared[b] = pre_pages
            if nfixed:
                table[b, :nfixed] = pre_pages
            table[b, nfixed:nfixed + need] = pg
            table[b, nfixed + need:] = -1
            lg, lens, pre, _ = eng.paged_prefill(
                [suffix], table[b:b + 1], pre_pages, pre_len,
                extra={k: v[:, b:b + 1] for k, v in extra.items()})
            if radix:
                # commit the full-page span of the prompt so later fills
                # (and later runs) reuse it at match time
                nfull = min(len(ids) // ps, nfixed + need)
                if nfull > pre_len // ps:
                    eng.radix_insert(ids[: nfull * ps],
                                     [int(p) for p in table[b, :nfull]])
            st.prefill_tokens += pre
            st.input_tokens += pre_len + len(suffix)
            place(b, job, int(lens[0]), lg[0])
            if grp is not None:
                grp.snap(eng, table[b], positions[b], logits[b],
                         {k: v[:, b:b + 1] for k, v in extra.items()})
            return True

        def free_slot(b: int) -> None:
            eng.release_pages(slot_pages[b])
            slot_pages[b] = []
            if slot_shared[b]:
                eng.release_pages(slot_shared[b])
                slot_shared[b] = []
            table[b, :] = -1           # dead rows must never write pages

        def cow_guard(live: List[int]) -> None:
            """Privatize this tick's write page for any slot that shares it
            (refcount > 1): fork streams share the sub-page prompt tail, so
            the first decode write of each stream must land on a private
            copy.  Batched into one device copy per tick."""
            srcs: List[int] = []
            dsts: List[int] = []
            for b in live:
                w = int(positions[b]) // ps
                if w >= NBf:
                    continue
                pgid = int(table[b, w])
                if pgid < 0 or eng._alloc.refs(pgid) <= 1:
                    continue
                if not eng._ensure_pool(1):
                    raise RuntimeError(
                        "page pool exhausted during copy-on-write")
                new = eng.alloc_pages(1)[0]
                srcs.append(pgid)
                dsts.append(new)
                table[b, w] = new
                slot_pages[b].append(new)
                # the lease on the old page stays in slot_shared/slot_pages
                # and is released at free_slot — release here would race
                # siblings still reading it
            if srcs:
                eng.copy_pages(srcs, dsts)
                st.cow_copies += len(srcs)

        done_count = 0
        ticks = 0
        try:
            while done_count < len(reqs):
                stalled = False
                for b in range(B):
                    if active[b] is None and queue and not stalled:
                        if fill_slot(b, queue[0]):
                            queue.pop(0)
                        else:
                            stalled = True
                live = [b for b in range(B) if active[b] is not None]
                if not live:
                    if queue:
                        raise RuntimeError(
                            f"page pool ({eng.page_pool_pages} pages) too "
                            f"small for even one request")
                    break

                gs = [active[b].grammar if active[b] else None
                      for b in range(B)]
                toks = eng._sample(logits, gs, states, temperature)
                done_count += self._advance_live(live, active, states, outs,
                                                 budgets, toks, st, logits,
                                                 free_slot)

                if done_count >= len(reqs):
                    break
                live = [b for b in range(B) if active[b] is not None]
                if not live:
                    continue           # all finished this tick; refill next
                cow_guard(live)
                nb = eng.active_blocks(positions[live])
                lg, _ = eng.paged_decode(toks, positions, table, nb,
                                         extra=extra)
                rows = torch.tensor(live, device=eng.device)
                logits[rows] = lg[rows]
                positions += 1
                ticks += 1
        finally:
            # errors must not leak slot pages, fork-group leases, or the
            # prefix retain: a pinned pool would shrink permanently
            for b in range(B):
                if slot_pages[b]:
                    eng.release_pages(slot_pages[b])
                    slot_pages[b] = []
                if slot_shared[b]:
                    eng.release_pages(slot_shared[b])
                    slot_shared[b] = []
            for g in groups.values():
                g.release(eng)
            if pages_pre:
                eng.release_pages(pages_pre)
        st.decode_steps += ticks
        eng._note_kv()
        st.kv_bytes = eng.kv_peak_bytes
