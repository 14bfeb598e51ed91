"""The physical PREDICT operator (paper §5) with the intra-operator
optimizations of §6:

  configuration stage  — option precedence: model OPTIONS > session SET >
                         defaults (§5.3)
  loading stage        — executor resolution via the registry
  execution stage      — chunked, vectorized, and SPLIT INTO TWO PHASES:
      submit(table)  -> PendingChunk   cache probe, prompt rewriting
                                       (§5.1), multi-row marshaling (§6.2)
                                       and request construction; requests
                                       are queued on the shared
                                       InferenceService, nothing blocks
      resolve(pending) -> Table        typed extraction (Table 3), retry
                                       with stricter formatting, per-tuple
                                       fallback, output assembly

  The split lets physical operators keep several windows submitted ahead
  (`inflight_windows`) so the service can dispatch them as one batch —
  cross-window and cross-operator overlap (§6.3) instead of the old
  synchronous one-chunk-at-a-time loop.  `__call__` remains the
  degenerate submit-then-resolve case with behavior identical to the old
  synchronous operator.

Scheduling/makespan accounting lives in `repro.core.service`; each chunk
opens one DispatchGroup whose makespan (greedy worker pool + rate limit)
covers every call made for the chunk, including retries and fallbacks —
the same numbers the operator used to compute locally.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cancel import QueryCancelled
from repro_torch.core.executors import CallResult, Predictor
from repro_torch.core.faults import DeadlineExceeded, TransientError
from repro_torch.core.service import (DispatchGroup, InferenceHandle,
                                InferenceRequest, InferenceService, makespan)
from repro_torch.core.stats import stats_key
from repro_torch.relational.plan import PredictInfo
from repro_torch.relational.table import Table, _coerce

__all__ = ["DEFAULTS", "PredictStats", "PredictOperator", "PromptCache",
           "PendingBatch", "PendingChunk", "makespan", "extract_json",
           "parse_structured", "cast_value", "render_rows"]

DEFAULTS = {
    "batch_size": 16,        # marshaled rows per call
    "n_threads": 16,         # parallel workers
    "use_batching": True,    # multi-row marshaling
    "use_dedup": True,       # prompt deduplication
    "rate_limit_rpm": 0,     # 0 = unlimited
    "retry_limit": 2,
    "chunk_size": 2048,      # vectorized chunk (DuckDB-analog)
    "inflight_windows": 1,   # chunks kept submitted ahead of resolution
    "dispatch_workers": 1,   # per-backend dispatch pool (1 = synchronous)
    "num_slots": 8,          # continuous-batching decode slots (jax)
    "n_samples": 1,          # self-consistency streams per row (jax)
    # front-door multi-tenancy tags: every request the operator submits
    # carries them, so dispatch batches are session-pure and the service
    # can account (and cancel) per session.  "" = plain Python API.
    "tenant": "",
    "session": "",
    # resilience (core/faults.py).  deadline_ms: end-to-end query budget
    # via the §5.3 precedence (expression WITH > model OPTIONS > session
    # SET); 0 = none.  query_start_ts anchors it (the database stamps
    # time.monotonic() at query start so every operator of one query
    # derives the same absolute deadline).  retry_backoff_s: base of the
    # exponential backoff between transient-failure retries (deterministic
    # seeded jitter); 0 = retry immediately, the old behavior.
    "deadline_ms": 0,
    "query_start_ts": 0.0,
    "retry_backoff_s": 0.0,
}


@dataclasses.dataclass
class PredictStats:
    calls: int = 0
    in_tokens: int = 0
    out_tokens: int = 0
    sim_latency_s: float = 0.0     # modeled makespan (workers + rate limit)
    serial_latency_s: float = 0.0  # sum of per-call latencies
    wall_s: float = 0.0
    rows_in: int = 0
    cache_hits: int = 0
    retries: int = 0
    batch_fallbacks: int = 0
    null_outputs: int = 0
    pc_hits: int = 0               # cross-query prompt-cache hits
    pc_misses: int = 0             # lookups that had to dispatch a call
    inflight_hits: int = 0         # submits that joined a pending handle
    # engine-side serving accounting (jax backend; zero for API backends)
    prefill_tokens: int = 0        # tokens prefit through the model
    decode_tokens: int = 0         # lock-step decode tokens generated
    prefix_hits: int = 0           # shared-prefix KV memo/radix hits
    radix_hit_tokens: int = 0      # prompt tokens served from the radix tree
    # cascade accounting (CascadePredictor backend; zero for direct routes)
    proxy_calls: int = 0           # proxy-stage prompts scored
    escalated_calls: int = 0       # expensive-stage calls actually made
    cascade_rows: int = 0          # rows routed through a cascade
    escalated_rows: int = 0        # rows escalated to the expensive stage
    # resilience accounting (core/faults.py)
    transient_retries: int = 0     # resubmits after transient backend errors
    deadline_drops: int = 0        # calls/retries abandoned past the deadline
    degraded_calls: int = 0        # cascade batches degraded to proxy-only

    def add(self, o: "PredictStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(o, f.name))


_JSON_RE = re.compile(r"[\[{].*[\]}]", re.DOTALL)


def extract_json(text: str) -> Optional[object]:
    """Locate and parse the outermost JSON value in model text, tolerating
    surrounding prose. Returns the decoded value or None."""
    m = _JSON_RE.search(text)
    if not m:
        return None
    try:
        return json.loads(m.group(0))
    except json.JSONDecodeError:
        return None


def parse_structured(text: str, schema: Sequence[Tuple[str, str]],
                     num_rows: int) -> Optional[List[dict]]:
    """Extract typed rows from model text; returns None if unusable."""
    v = extract_json(text)
    if v is None:
        return None
    objs = v if isinstance(v, list) else [v]
    if len(objs) < num_rows:
        return None
    out = []
    for o in objs[:num_rows]:
        if not isinstance(o, dict):
            return None
        row = {}
        for name, typ in schema:
            row[name] = cast_value(o.get(name), typ)
        out.append(row)
    return out


def cast_value(v, typ: str):
    t = typ.upper()
    try:
        if v is None:
            return None
        if t == "INTEGER":
            return int(v)
        if t == "DOUBLE":
            return float(v)
        if t == "BOOLEAN":
            if isinstance(v, str):
                return v.strip().lower() in ("true", "yes", "1")
            return bool(v)
        return str(v)
    except (TypeError, ValueError):
        return None


def render_rows(rows: List[dict]) -> str:
    """Render marshaled input rows into the prompt tail.  Module-level so
    the CascadePredictor can split a marshaled prompt back into its
    (preamble, rendered rows) parts when re-batching escalations."""
    if len(rows) == 1:
        return "Input: " + json.dumps(rows[0], default=str)
    return (f"Inputs ({len(rows)} rows — return a JSON array with "
            f"exactly {len(rows)} objects, in order): "
            + json.dumps(rows, default=str))


_MISS = object()

_STRICT = ("\nSTRICT: output MUST be raw JSON parsable by json.loads, "
           "nothing else.\n")


class PromptCache:
    """Cross-query prompt cache, owned by the database and shared by every
    PredictOperator it creates. Keyed by (model, instruction, input tuple);
    survives across operators, chunks, and queries, so a repeated query (or
    an overlapping one against the same model/instruction) re-uses prior
    inference results instead of re-dispatching calls.

    Eviction is LRU: `get` re-inserts the hit entry at the back of the
    (insertion-ordered) dict, `put` evicts from the front, so hot entries
    survive churn that would have rotated them out under FIFO.

    All access is lock-protected: with per-backend dispatch pools, flushes
    (and the operators that feed the cache from their results) run off the
    submitting thread, and the touch-on-get delete/re-insert pair is not
    atomic under the GIL — two unsynchronized readers of one hot key would
    race the delete."""

    def __init__(self, max_entries: int = 200_000):
        self._d: Dict[Tuple, List[Optional[object]]] = {}
        self._lock = threading.Lock()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple):
        with self._lock:
            v = self._d.get(key, _MISS)
            if v is _MISS:
                self.misses += 1
            else:
                self.hits += 1
                del self._d[key]           # touch-on-get: move to MRU end
                self._d[key] = v
            return v

    def put(self, key: Tuple, value: List[Optional[object]]) -> None:
        with self._lock:
            if key not in self._d and len(self._d) >= self.max_entries:
                self._d.pop(next(iter(self._d)))      # LRU eviction
            self._d[key] = value

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    # -- warm-state snapshots (core/snapshot.py) -----------------------
    def export_state(self) -> List[Tuple[Tuple, List[Optional[object]]]]:
        """(key, value) pairs in LRU order (oldest first), so a restore
        that overflows max_entries keeps the hottest tail."""
        with self._lock:
            return list(self._d.items())

    def restore_state(self, items) -> int:
        """Re-insert snapshot entries (hit/miss counters untouched)."""
        for k, v in items:
            self.put(k, v)
        return len(items)


@dataclasses.dataclass
class PendingBatch:
    """One marshaled call in flight: the chunk-row indices it answers, the
    rendered input rows, and the service handle.  `owned` is False when
    the request joined another submitter's identical in-flight handle
    (the joiner must not account the call's tokens)."""
    idxs: List[int]
    rows: List[dict]
    handle: InferenceHandle
    owned: bool


@dataclasses.dataclass
class PendingChunk:
    """Result of `PredictOperator.submit`: everything `resolve` needs to
    turn the dispatched requests back into an output table."""
    table: Table
    keys: List[Tuple]
    use_dedup: bool
    seen: Dict[Tuple, int]
    cached: Dict[int, List[Optional[object]]]
    batches: List[PendingBatch]
    group: DispatchGroup


class PredictOperator:
    def __init__(self, info: PredictInfo, executor: Predictor,
                 session_options: Dict[str, object],
                 prompt_cache: Optional[PromptCache] = None,
                 service: Optional[InferenceService] = None,
                 stats_store=None):
        # --- configuration stage (precedence per §5.3) ---
        opts = dict(DEFAULTS)
        opts.update({k: v for k, v in session_options.items()
                     if k in DEFAULTS})
        opts.update({k: v for k, v in (info.options or {}).items()})
        self.opts = opts
        self.info = info
        self.executor = executor
        executor.configure(opts)
        # --- loading stage ---
        executor.load()
        # dispatch goes through the (usually database-owned) service;
        # standalone operators get a private one
        self.service = service if service is not None else InferenceService()
        # dedup store: the database-owned cross-query cache when injected,
        # else a private per-operator dict
        self.prompt_cache = prompt_cache
        self.cache: Dict[Tuple, List[Optional[object]]] = {}
        # cascaded executors carry a stage tag: their (possibly
        # proxy-resolved) answers must not poison the direct route's
        # cross-query prompt-cache namespace, and their dispatch
        # accounting records under the staged stats key
        self._stage = str(getattr(executor, "stats_stage", "") or "")
        # the namespace must cover every option that changes the *answer*
        # for the same (model, instruction, input): n_samples majority
        # voting, sampling temperature, token/string budgets, and the
        # table-generation row budget.  Batching/slot/window options shape
        # dispatch, not answers, and stay out so they keep sharing entries.
        shaping = tuple(
            (k, opts.get(k, d)) for k, d in (
                ("n_samples", 1), ("temperature", 0.7),
                ("max_tokens", 4096), ("max_str", 24), ("gen_rows", 4))
            if opts.get(k, d) != d)
        self._ns = (info.model_name, self._instruction()) + shaping + \
            ((self._stage,) if self._stage else ())
        self.stats = PredictStats()
        # adaptive statistics: calls/tokens/latency are recorded by the
        # service at dispatch; the operator records retries + fallbacks
        self.stats_store = stats_store
        self._skey = stats_key(info)
        # absolute deadline on the time.monotonic() scale (0 = none):
        # derived once here from the precedence-resolved deadline_ms and
        # the query-start anchor, stamped on every request this operator
        # submits, and re-checked before every retry attempt
        dl_ms = float(opts.get("deadline_ms", 0) or 0)
        self._deadline_ts = 0.0
        if dl_ms > 0:
            start = float(opts.get("query_start_ts", 0.0) or 0.0)
            self._deadline_ts = (start or time.monotonic()) + dl_ms / 1000.0

    def _cache_put(self, k: Tuple, v: List[Optional[object]]) -> None:
        # total parse failures are memoized for the operator's lifetime
        # only: a transient malformed response must not become a sticky
        # NULL answer across queries
        if self.prompt_cache is None or all(x is None for x in v):
            self.cache[k] = v
        else:
            self.prompt_cache.put(self._ns + (k,), v)

    # ------------------------------ prompts --------------------------------
    def _instruction(self) -> str:
        instr = self.info.prompt.instruction if self.info.prompt else \
            f"predict {', '.join(n for n, _ in self.info.outputs)}"
        types = ", ".join(f'"{n}" ({t})' for n, t in self.info.outputs)
        return (f"You are a precise data engine. Task: {instr}\n"
                f"Return ONLY a JSON value with keys {types}. "
                f"No explanations, no code fences.")

    def _render_rows(self, rows: List[dict]) -> str:
        return render_rows(rows)

    # ------------------------------ dispatch -------------------------------
    def _open_group(self) -> DispatchGroup:
        return self.service.open_group(
            workers=int(self.opts.get("n_threads", 16)),
            rpm=float(self.opts.get("rate_limit_rpm", 0)))

    def _submit_call(self, prompt: str, nr: int, rows, instr: str, *,
                     exact_rows: bool = False
                     ) -> Tuple[InferenceHandle, bool]:
        req = InferenceRequest(
            model_name=self.info.model_name, instruction=instr,
            prompt=prompt, schema=tuple(self.info.outputs),
            num_rows=nr if exact_rows else max(nr, 1),
            executor=self.executor, rows=rows,
            dedup=bool(self.opts.get("use_dedup", True)),
            stats_key=self._skey, stage=self._stage,
            tenant=str(self.opts.get("tenant", "") or ""),
            session=str(self.opts.get("session", "") or ""),
            deadline_ts=self._deadline_ts)
        handle, owned = self.service.submit_one(req)
        if not owned:
            self.stats.inflight_hits += 1
        return handle, owned

    def _consume(self, handle: InferenceHandle, owned: bool,
                 group: DispatchGroup) -> CallResult:
        """Force a handle and account it: the call's tokens (owner only)
        and its modeled latency, appended to the chunk's dispatch group in
        consumption order so the greedy makespan matches the synchronous
        schedule exactly."""
        res = handle.result()            # flushes if still queued
        if owned:
            self._account(res)
            group.latencies.append(res.sim_latency_s)
        return res

    def _call_now(self, prompt: str, nr: int, rows, instr: str,
                  group: DispatchGroup, *, exact_rows: bool = False
                  ) -> CallResult:
        """Synchronous call through the service (retries, fallbacks)."""
        handle, owned = self._submit_call(prompt, nr, rows, instr,
                                          exact_rows=exact_rows)
        return self._consume(handle, owned, group)

    # ------------------------------ resilience -----------------------------
    def _session(self) -> str:
        return str(self.opts.get("session", "") or "")

    def _remaining(self) -> float:
        """Seconds until the query deadline (+inf when none is set)."""
        if not self._deadline_ts:
            return float("inf")
        return self._deadline_ts - time.monotonic()

    def _backoff(self, attempt: int, prompt: str) -> None:
        """Exponential backoff before retry `attempt` (1-based), with
        deterministic jitter seeded from the prompt so replays sleep the
        same schedule.  Capped at the remaining deadline; a zero base
        (the default) retries immediately like the old bare loop."""
        base = float(self.opts.get("retry_backoff_s", 0) or 0)
        if base <= 0:
            return
        h = hashlib.sha256(f"backoff:{attempt}:{prompt}".encode()).digest()
        jitter = 0.5 + h[0] / 512.0            # deterministic [0.5, 1.0)
        delay = base * (2 ** (attempt - 1)) * jitter
        rem = self._remaining()
        if rem != float("inf"):
            delay = min(delay, max(0.0, rem))
        if delay > 0:
            time.sleep(delay)

    def _force_result(self, handle: InferenceHandle, owned: bool,
                      group: DispatchGroup, *, prompt: str, nr: int,
                      rows, instr: str, exact_rows: bool = False
                      ) -> Optional[CallResult]:
        """Force a handle, absorbing the fault model: transient backend
        failures (injected faults, call timeouts, open breakers) are
        retried with deterministic exponential backoff, re-checking the
        remaining deadline before each attempt; an expired deadline or an
        exhausted retry budget returns None and the caller degrades to
        NULL outputs instead of crashing the query."""
        retries = int(self.opts.get("retry_limit", 2))
        attempt = 0
        while True:
            try:
                return self._consume(handle, owned, group)
            except QueryCancelled:
                raise
            except DeadlineExceeded:
                # the service already counted the dispatch-side drop
                self.stats.deadline_drops += 1
                return None
            except TransientError:
                attempt += 1
                if attempt > retries:
                    return None
                if self._remaining() <= 0:
                    self.stats.deadline_drops += 1
                    self.service.note_deadline_drop(self._session())
                    return None
                self.stats.transient_retries += 1
                self.service.note_transient_retry(self._session())
                self._backoff(attempt, prompt)
                handle, owned = self._submit_call(prompt, nr, rows, instr,
                                                  exact_rows=exact_rows)

    # ------------------------------ execution -------------------------------
    def __call__(self, table: Table) -> Table:
        """Synchronous table/scalar inference — the degenerate pipeline:
        submit one chunk and resolve it immediately."""
        return self.resolve(self.submit(table))

    def submit(self, table: Table) -> PendingChunk:
        """Phase 1: probe caches, marshal the misses into batched requests
        and queue them on the inference service.  Returns without
        dispatching — `resolve` (or any service flush) does that."""
        t0 = time.time()
        n = len(table)
        self.stats.rows_in += n
        in_cols = [c for c in self.info.inputs]
        rows = [{c: table.row(i)[c] for c in in_cols} for i in range(n)] \
            if in_cols else [{} for _ in range(n)]
        keys = [tuple(sorted(r.items())) for r in rows]

        use_dedup = bool(self.opts.get("use_dedup", True))
        pending: List[int] = []
        seen: Dict[Tuple, int] = {}
        cached: Dict[int, List[Optional[object]]] = {}
        for i, k in enumerate(keys):
            if not use_dedup:
                pending.append(i)
                continue
            if k in seen:                  # in-chunk duplicate of a pending
                self.stats.cache_hits += 1   # key: no cache probe
                continue
            v = self.cache.get(k, _MISS)   # operator-lifetime memo
            if v is _MISS and self.prompt_cache is not None:
                v = self.prompt_cache.get(self._ns + (k,))
                if v is not _MISS:
                    self.stats.pc_hits += 1
            if v is not _MISS:
                self.stats.cache_hits += 1
                cached[i] = v
                continue
            seen[k] = i
            pending.append(i)
            if self.prompt_cache is not None:
                self.stats.pc_misses += 1

        bs = int(self.opts.get("batch_size", 16)) \
            if self.opts.get("use_batching", True) else 1
        group = self._open_group()
        instr = self._instruction()
        batches: List[PendingBatch] = []
        for s in range(0, len(pending), bs):
            idxs = pending[s:s + bs]
            batch_rows = [rows[i] for i in idxs]
            prompt = instr + "\n" + self._render_rows(batch_rows)
            handle, owned = self._submit_call(prompt, len(batch_rows),
                                              batch_rows, instr)
            batches.append(PendingBatch(idxs, batch_rows, handle, owned))

        self.stats.wall_s += time.time() - t0
        return PendingChunk(table, keys, use_dedup, seen, cached, batches,
                            group)

    def kick(self) -> None:
        """Speculatively start background dispatch of hot service queues
        (complete `max_dispatch`-sized slices on concurrency-capable
        backends).  Physical operators call this after each `submit` so
        dispatch overlaps the production of the next window instead of
        waiting for the first `resolve`."""
        self.service.kick()

    def resolve(self, pending: PendingChunk) -> Table:
        """Phase 2: force dispatch, parse/retry/fallback every batch, and
        assemble the output chunk.  `drain_for` dispatches exactly the
        slices covering this chunk's handles (scheduling
        concurrency-capable backends on their worker lanes); requests
        queued behind them — later inflight windows, other sessions —
        stay queued for their own resolve, so an early-exit Limit can
        still cancel them undispatched.  The per-handle `result()` calls
        below then block on any lane futures (synchronous backends
        dispatch inline during the drain)."""
        t0 = time.time()
        self.service.drain_for([b.handle for b in pending.batches])
        results: Dict[int, List[Optional[object]]] = {}
        for b in pending.batches:
            vals = self._resolve_batch(b, pending.group)
            for i, v in zip(b.idxs, vals):
                results[i] = v
                if pending.use_dedup:
                    self._cache_put(pending.keys[i], v)

        self.stats.sim_latency_s += pending.group.makespan()
        self.stats.serial_latency_s += pending.group.serial()

        out_vals: List[List[Optional[object]]] = []
        for i, k in enumerate(pending.keys):
            if i in results:
                out_vals.append(results[i])
            elif i in pending.cached:
                out_vals.append(pending.cached[i])
            elif pending.use_dedup and pending.seen.get(k) in results:
                out_vals.append(results[pending.seen[k]])
            else:
                out_vals.append([None] * len(self.info.outputs))

        out = pending.table
        for j, ((name, typ), col) in enumerate(
                zip(self.info.outputs, self.info.out_cols)):
            colvals = [v[j] for v in out_vals]
            self.stats.null_outputs += sum(1 for v in colvals if v is None)
            out = out.with_column(col, _coerce(colvals, typ), typ)
        self.stats.wall_s += time.time() - t0
        return out

    def cancel(self, pending: PendingChunk) -> None:
        """Discard a submitted chunk whose results are no longer needed
        (pipelined operator closed early, e.g. under a Limit).  Joined
        batches release their reference too, so a request is dropped from
        the queue exactly when its last interested chunk cancels."""
        for b in pending.batches:
            self.service.cancel(b.handle)

    # table generation (ρ^s)
    def scan(self, max_rows: int = 64) -> Table:
        t0 = time.time()
        group = self._open_group()
        prompt = self._instruction() + \
            f"\nReturn a JSON array of at most {max_rows} objects."
        raw = self.info.prompt.instruction if self.info.prompt else ""
        # num_rows=0 is meaningful here: table generation lets the model
        # decide cardinality
        handle, owned = self._submit_call(prompt, 0, [], raw,
                                          exact_rows=True)
        res = self._force_result(handle, owned, group, prompt=prompt, nr=0,
                                 rows=[], instr=raw, exact_rows=True)
        rows = []
        v = None if res is None else extract_json(res.text)
        if v is not None:
            objs = v if isinstance(v, list) else [v]
            for o in objs[:max_rows]:
                if isinstance(o, dict):
                    rows.append({n: cast_value(o.get(n), t)
                                 for n, t in self.info.outputs})
        self.stats.sim_latency_s += group.makespan()
        self.stats.serial_latency_s += group.serial()
        cols = {}
        sch = {}
        for (n, t), c in zip(self.info.outputs, self.info.out_cols):
            cols[c] = _coerce([r.get(n) for r in rows], t)
            sch[c] = t
        self.stats.wall_s += time.time() - t0
        return Table(cols, sch)

    # semantic aggregate (LLM AGG): one call per group, all groups
    # dispatched as one service batch
    def aggregate(self, groups: List[List[dict]]) -> List[Optional[object]]:
        t0 = time.time()
        group = self._open_group()
        instr = self._instruction()
        suffix = "\nAggregate ALL rows into ONE JSON object."
        pend = []
        for g in groups:
            prompt = instr + "\n" + self._render_rows(g) + suffix
            pend.append((g, *self._submit_call(prompt, 1, g, instr)))
        self.service.drain_for([h for _, h, _ in pend])
        outs = []
        retries = int(self.opts.get("retry_limit", 2))
        for g, handle, owned in pend:
            prompt = instr + "\n" + self._render_rows(g) + suffix
            res = self._force_result(handle, owned, group, prompt=prompt,
                                     nr=1, rows=g, instr=instr)
            parsed = None if res is None else \
                parse_structured(res.text, self.info.outputs, 1)
            attempt = 0
            while res is not None and parsed is None and attempt < retries:
                if self._remaining() <= 0:
                    # deadline re-check before each retry (see
                    # _resolve_batch): expired groups degrade to NULL
                    self.stats.deadline_drops += 1
                    self.service.note_deadline_drop(self._session())
                    break
                attempt += 1
                self._note_retry()
                stricter = (instr + _STRICT + self._render_rows(g) + suffix)
                sh, sowned = self._submit_call(stricter, 1, g, instr)
                res = self._force_result(sh, sowned, group, prompt=stricter,
                                         nr=1, rows=g, instr=instr)
                parsed = None if res is None else \
                    parse_structured(res.text, self.info.outputs, 1)
            outs.append(parsed[0][self.info.outputs[0][0]] if parsed else None)
        self.stats.sim_latency_s += group.makespan()
        self.stats.serial_latency_s += group.serial()
        self.stats.wall_s += time.time() - t0
        return outs

    # ------------------------------------------------------------------
    def _resolve_batch(self, b: PendingBatch, group: DispatchGroup
                       ) -> List[List[Optional[object]]]:
        """Parse one resolved batch (+strict retries, + per-tuple
        fallback). Returns per-row output value lists."""
        nr = len(b.rows)
        instr = self._instruction()
        prompt = instr + "\n" + self._render_rows(b.rows)
        res = self._force_result(b.handle, b.owned, group, prompt=prompt,
                                 nr=nr, rows=b.rows, instr=instr)
        if res is None:                 # deadline / retry budget exhausted
            return [[None] * len(self.info.outputs) for _ in b.idxs]
        parsed = parse_structured(res.text, self.info.outputs, nr)
        retries = int(self.opts.get("retry_limit", 2))
        attempt = 0
        while parsed is None and attempt < retries:
            if self._remaining() <= 0:
                # re-check the deadline before every retry attempt: a
                # nearly-expired chunk no longer burns the full
                # retry_limit — it degrades to NULLs immediately
                self.stats.deadline_drops += 1
                self.service.note_deadline_drop(self._session())
                return [[None] * len(self.info.outputs) for _ in b.idxs]
            attempt += 1
            self._note_retry()
            stricter = instr + _STRICT + self._render_rows(b.rows)
            sh, sowned = self._submit_call(stricter, nr, b.rows, instr)
            res = self._force_result(sh, sowned, group, prompt=stricter,
                                     nr=nr, rows=b.rows, instr=instr)
            if res is None:
                return [[None] * len(self.info.outputs) for _ in b.idxs]
            parsed = parse_structured(res.text, self.info.outputs, nr)

        if parsed is None and nr > 1:
            # §6.3: failed batch → per-tuple fallback, dispatched together
            self._note_fallback()
            subs = []
            for i, r in zip(b.idxs, b.rows):
                prompt = instr + "\n" + self._render_rows([r])
                handle, owned = self._submit_call(prompt, 1, [r], instr)
                subs.append(PendingBatch([i], [r], handle, owned))
            self.service.drain_for([sb.handle for sb in subs])
            return [self._resolve_batch(sb, group)[0] for sb in subs]
        if parsed is None:
            return [[None] * len(self.info.outputs)]
        names = [n for n, _ in self.info.outputs]
        return [[p[n] for n in names] for p in parsed]

    def _account(self, res: CallResult) -> None:
        self.stats.calls += 1
        self.stats.in_tokens += res.in_tokens
        self.stats.out_tokens += res.out_tokens
        self.stats.prefill_tokens += res.prefill_tokens
        self.stats.decode_tokens += res.decode_tokens
        self.stats.prefix_hits += res.prefix_hits
        self.stats.radix_hit_tokens += res.radix_hit_tokens
        self.stats.proxy_calls += res.proxy_calls
        self.stats.escalated_calls += res.escalated_calls
        self.stats.cascade_rows += res.cascade_rows
        self.stats.escalated_rows += res.escalated_rows
        self.stats.degraded_calls += res.degraded_calls

    def _note_retry(self) -> None:
        self.stats.retries += 1
        if self.stats_store is not None:
            self.stats_store.record_retry(self._skey)

    def _note_fallback(self) -> None:
        self.stats.batch_fallbacks += 1
        if self.stats_store is not None:
            self.stats_store.record_fallback(self._skey)
