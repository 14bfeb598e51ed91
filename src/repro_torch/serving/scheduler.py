"""Slot-based continuous batching on top of InferenceEngine (port of
``repro/serving/scheduler.py``, dense layout).

A fixed decode batch of `num_slots` sequences runs lock-step decode ticks;
finished slots are immediately refilled by prefilling queued requests into
the slot's cache rows (per-row cache indices make ragged fill levels safe).
Slot eviction doubles as straggler mitigation: a request exceeding its token
budget is cut off with `error` set, without stalling the batch.

Each slot owns a contiguous max_len cache row, so a shared instruction
prefix is prefilled again for every slot.  ``n_samples > 1`` runs as that
many independent jobs (the copy-on-write fork groups belong to the paged
layout, which is not ported yet) whose texts are majority-voted.
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
    so n_samples streams of one request complete independently."""
    __slots__ = ("req", "sample", "rid", "text", "error")

    def __init__(self, req: Request, sample: int):
        self.req = req
        self.sample = sample
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
        `shared_prefix` is prepended to every prompt and prefilled per
        slot."""
        st = GenStats(calls=1)
        t0 = time.time()
        reqs = list(requests)
        jobs: List[_Job] = []
        for i, r in enumerate(reqs):
            r.rid = i
            jobs.extend(_Job(r, k) for k in range(max(1, r.n_samples)))
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
            for k in ("k", "v"):                            # (L, B, ...)
                cache[k][:, b] = c1[k][:, 0]
            for k in ("slot_pos", "row_idx"):               # (B, ...)
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
