"""Shared inference service: the async dispatch layer between relational
operators and model executors (paper §6.3, generalized).

Operators no longer call executors directly.  They build
`InferenceRequest`s and `submit()` them to the database-owned
`InferenceService`, receiving `InferenceHandle` futures.  The service

  * maintains one queue per (model, instruction, schema) — requests that
    can be answered by the same executor configuration batch together,
    across chunks, windows and operators;
  * dedups in-flight requests: a second identical request submitted while
    the first is still pending joins the existing handle instead of
    re-dispatching (complementing the cross-query PromptCache, which only
    covers *resolved* results);
  * dispatches each queue in one `Predictor.complete_many` call per
    `flush()` — for the JAX backend that is one continuous-batching run
    over all marshaled prompts, for the oracle/tabular backends one
    vectorized pass — optionally capped at `max_dispatch` calls per batch
    (a simple provider rate limit);
  * runs dispatch batches on PER-BACKEND WORKER POOLS when the backend
    declares it can take concurrent dispatches
    (`Predictor.dispatch_workers()` > 1): queues for different (model,
    instruction) keys flush on background threads while operators keep
    submitting, so an oracle/API-style backend's modeled wait overlaps
    the local JAX engine's real compute.  `dispatch_workers = 1` (the
    default) is exactly the old synchronous flush;
  * prioritizes flushes smallest-expected-makespan-first: queues whose
    expected dispatch makespan (PR 3 CostModel over the statistics store)
    is lowest are started first, so short batches are never stuck behind
    a long-running one.  Prioritization never starves a queue — every
    `flush()` dispatches every queued request;
  * speculatively flushes hot queues (`kick()`): when a queue has
    accumulated at least `max_dispatch` requests for a concurrency-capable
    backend, the complete slices a later `flush()` would dispatch anyway
    are started early in the background.  Batch composition is invariant
    (the same prefix slices, in submission order), so accounting does not
    depend on when the kick happened;
  * owns makespan accounting: per-call modeled latencies are recorded on
    `DispatchGroup`s (one per predict chunk) and reduced with the same
    greedy worker-pool + rpm model that previously lived inside
    `PredictOperator`.

Determinism contract: rows, ExecStats and modeled latencies are
byte-identical regardless of `dispatch_workers` and of which worker
finishes first.  This holds because (a) batch composition is a pure
function of submission order + `max_dispatch`, (b) handles are resolved
by the operator in submission order, (c) all shared state (queues,
in-flight map, counters, StatisticsStore, PromptCache) is lock-protected
and accumulates order-independent sums.  `tests/test_concurrent_dispatch.py`
pins this with a scripted-latency backend and barrier-forced worst-case
interleavings.

Synchronous execution is the degenerate case: submit immediately followed
by flush()+resolve behaves exactly like the old direct `complete()` path.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cancel import QueryCancelled
from repro_torch.core.executors import CallResult, Predictor, default_latency_model
from repro_torch.core.faults import (CLOSED, BackendTimeout, CircuitBreaker,
                               CircuitOpenError, DeadlineExceeded,
                               TransientError)


def makespan(latencies: Sequence[float], workers: int, rpm: float = 0.0
             ) -> float:
    """Greedy schedule of calls onto `workers`, optionally throttled to
    `rpm` requests/minute (paper Fig. 5 model)."""
    if not latencies:
        return 0.0
    heap = [0.0] * max(1, workers)
    heapq.heapify(heap)
    gap = 60.0 / rpm if rpm else 0.0
    next_slot = 0.0
    end = 0.0
    for l in latencies:
        free = heapq.heappop(heap)
        start = max(free, next_slot)
        next_slot = start + gap
        fin = start + l
        end = max(end, fin)
        heapq.heappush(heap, fin)
    return end


@dataclasses.dataclass
class DispatchGroup:
    """Accounting scope for one unit of operator work (one predict chunk,
    one aggregate call, one table scan).  Every call made on behalf of the
    group — including retries and per-tuple fallbacks — records its
    modeled latency here in batch order (the operator appends as it
    consumes results), so the group's greedy makespan matches the old
    per-chunk `PredictOperator` accounting exactly.  Appends happen on the
    consuming operator's thread only, never on dispatch workers, which is
    what keeps the latency order (and the float sums) deterministic."""
    workers: int = 16
    rpm: float = 0.0
    latencies: List[float] = dataclasses.field(default_factory=list)

    def makespan(self) -> float:
        return makespan(self.latencies, self.workers, self.rpm)

    def serial(self) -> float:
        return float(sum(self.latencies))


def staged_key(key: Tuple[str, str], stage: str) -> Tuple[str, str]:
    """Statistics-store key for one cascade stage of a (model, instruction)
    predicate.  Stage-tagged keys keep a cascaded dispatch's merged-call
    accounting separate from the base key, so a predicate's per-call stats
    are never double-counted (once inside the cascade stages, once at the
    service) — the fix for the PR 7 stats double-count."""
    if not stage:
        return key
    return (f"{key[0]}#{stage}", key[1])


@dataclasses.dataclass
class InferenceRequest:
    """One executor call to be: a fully rendered prompt plus the metadata
    the executor needs to answer and the service needs to route it."""
    model_name: str
    instruction: str
    prompt: str
    schema: Tuple[Tuple[str, str], ...]
    num_rows: int
    executor: Predictor
    rows: Optional[List[dict]] = None
    shared_prefix: str = ""
    dedup: bool = True                 # False: never join another handle
    # statistics-store key ((model, raw instruction)); set by the predict
    # operator so dispatch accounting can feed the adaptive cost model
    stats_key: Optional[Tuple[str, str]] = None
    # cascade stage tag ("" = direct).  Staged requests batch and dedup
    # separately from direct ones, and their dispatch accounting records
    # under `staged_key(stats_key, stage)` so a cascaded predicate's base
    # key only ever sees the per-stage records written by the cascade
    # executor itself (never the merged two-stage call on top of them).
    stage: str = ""
    # front-door multi-tenancy tags ("" = the plain Python API).  Both
    # are part of queue_key AND dedup_key: requests of different tenants
    # or sessions never share a dispatch batch or join each other's
    # handles, so (a) per-session ExecStats are a pure function of that
    # session's own submission order (byte-identical across
    # interleavings), and (b) cancelling one session can drop its whole
    # queued backlog without touching another session's handles.
    tenant: str = ""
    session: str = ""
    # absolute end-to-end deadline on the time.monotonic() scale (0 = no
    # deadline).  Set once per query from `deadline_ms` (§5.3 option
    # precedence / front-door request body) and shared by every request
    # of the query, so it needs no place in queue_key: batches are
    # session-pure and a session runs one query at a time.  Expired
    # requests are dropped at dispatch with `DeadlineExceeded` instead of
    # being sent to the backend.
    deadline_ts: float = 0.0

    @property
    def queue_key(self) -> Tuple:
        # shared_prefix included so every dispatch batch is
        # prefix-homogeneous (executors apply one prefix per batch)
        return (self.model_name, self.instruction, self.schema,
                self.shared_prefix, self.stage, self.tenant, self.session)

    @property
    def dedup_key(self) -> Tuple:
        return (self.model_name, self.instruction, self.schema,
                self.shared_prefix, self.prompt, self.num_rows, self.stage,
                self.tenant, self.session)


class InferenceHandle:
    """Future for one dispatched (or joined) request.

    Lifecycle: QUEUED (in a service queue) → DISPATCHING (popped for a
    dispatch batch; `_event` is set iff the batch runs on a worker thread)
    → DONE (`_result` or `_error` set).  A handle dropped from its queue
    without dispatch (cancel, shutdown, a failed flush) stays result-less
    and `result()` raises."""
    __slots__ = ("request", "_service", "_result", "_error", "_event",
                 "refs")

    def __init__(self, request: InferenceRequest, service: "InferenceService"):
        self.request = request
        self._service = service
        self._result: Optional[CallResult] = None
        self._error: Optional[BaseException] = None
        self._event: Optional[threading.Event] = None
        self.refs = 1                  # submitters sharing this handle

    @property
    def done(self) -> bool:
        return self._result is not None or self._error is not None

    def result(self) -> CallResult:
        if not self.done:
            self._service._force(self)
        if self._error is not None:
            raise self._error
        if self._result is None:
            raise RuntimeError("inference request cancelled before dispatch")
        return self._result


@dataclasses.dataclass
class SessionCounters:
    """Per-session dispatch accounting (front-door streams).  Because a
    session's requests never share a batch with another session's (the
    session tag is part of queue_key), these are well-defined per-session
    numbers, not an attribution heuristic — they are the session-scoped
    analog of the global before/after deltas `IPDB.sql` takes on
    ServiceStats, which would double-count under concurrent sessions."""
    submitted: int = 0
    dispatched_calls: int = 0
    dispatch_batches: int = 0
    inflight_dedup_hits: int = 0
    cancelled_requests: int = 0        # queued handles dropped by a cancel
    transient_retries: int = 0         # operator retries after TransientError
    deadline_drops: int = 0            # requests dropped past their deadline
    backend_timeouts: int = 0          # dispatch batches killed by call timeout
    breaker_rejections: int = 0        # requests shed by an open breaker


@dataclasses.dataclass
class ServiceStats:
    submitted: int = 0
    dispatched_calls: int = 0          # executor calls actually made
    dispatch_batches: int = 0          # complete_many invocations
    inflight_dedup_hits: int = 0       # submits that joined a pending handle
    # worker-pool accounting (not surfaced in per-query ExecStats: the
    # sync/async split is an execution detail, batch composition is not)
    async_batches: int = 0             # batches run on a worker thread
    speculative_batches: int = 0       # batches started by kick()
    # resilience accounting (see core/faults.py): surfaced per-query in
    # ExecStats and globally in EXPLAIN's -- resilience -- section
    transient_retries: int = 0         # operator retries after TransientError
    deadline_drops: int = 0            # requests dropped past their deadline
    backend_timeouts: int = 0          # dispatch batches killed by call timeout
    breaker_rejections: int = 0        # requests shed by an open breaker
    degraded_calls: int = 0            # cascade batches degraded to proxy-only

    @property
    def mean_batch_occupancy(self) -> float:
        if self.dispatch_batches == 0:
            return 0.0
        return self.dispatched_calls / self.dispatch_batches


class _Lane:
    """Per-backend dispatch lane: at most `workers` batches of one
    executor run concurrently; excess batches wait in `pending` and are
    started FIFO as running ones finish (so per-queue slice order is
    preserved without blocking a pool thread on a semaphore)."""
    __slots__ = ("workers", "active", "pending")

    def __init__(self, workers: int):
        self.workers = max(1, int(workers))
        self.active = 0
        self.pending: Deque["_DispatchTask"] = collections.deque()


@dataclasses.dataclass
class _DispatchTask:
    """One dispatch batch: a slice of one queue, ready to execute (its
    in-flight keys are already cleared)."""
    handles: List[InferenceHandle]
    speculative: bool = False


class InferenceService:
    """Batching request broker between predict operators and executors.

    `submit()` enqueues; nothing reaches an executor until `flush()`
    (called implicitly by `InferenceHandle.result()`) or a speculative
    `kick()`, so pipelined operators can stack several windows of requests
    and have them dispatched as one batch per (model, instruction) queue."""

    #: upper bound on concurrently running dispatch batches, all backends
    POOL_THREADS = min(32, 4 * (os.cpu_count() or 4))

    def __init__(self, *, max_dispatch: int = 0, stats_store=None,
                 cost_model=None, speculative: bool = True):
        # guards queues, in-flight map, lanes, counters and handle state
        # transitions; executor calls NEVER run under it
        self._lock = threading.RLock()
        self._idle = threading.Condition(self._lock)
        # queues preserve submission order (dict insertion order)
        self._queues: Dict[Tuple, List[InferenceHandle]] = {}
        self._inflight: Dict[Tuple, InferenceHandle] = {}
        self._lanes: Dict[int, _Lane] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._outstanding = 0          # scheduled-but-unfinished async tasks
        self._closed = False
        self.max_dispatch = int(max_dispatch)   # 0 = unbounded batch
        self.speculative = bool(speculative)
        self.stats = ServiceStats()
        # resilience policy (database stamps these from the §5.3 option
        # precedence before each query).  call_timeout_s = 0 keeps the
        # exact old unbounded-call behavior; breakers only ever act after
        # transient failures, so a healthy backend never notices them.
        self.call_timeout_s = 0.0
        self.breaker_threshold = 3
        self.breaker_probe_every = 4
        # per-backend breakers keyed by model name — stable across the
        # per-operator executor instances and across queries (the service
        # is database-owned), which is what lets a tripped breaker shed
        # load for every later query until a probe succeeds
        self._breakers: Dict[str, CircuitBreaker] = {}
        # front-door accounting: per-session dispatch counters and
        # per-tenant dispatched-call totals (fairness-ratio reporting),
        # plus the tombstone set of cancelled sessions (submits from a
        # cancelled session fail fast instead of re-queueing work)
        self._sessions: Dict[str, SessionCounters] = {}
        self._tenant_calls: Dict[str, int] = collections.defaultdict(int)
        self._cancelled_sessions: set = set()
        # optional adaptive StatisticsStore: every dispatched call records
        # its tokens + modeled latency under the request's stats_key
        self.stats_store = stats_store
        # optional PR 3 CostModel: drives smallest-expected-makespan-first
        # flush prioritization (falls back to a local estimate when absent)
        self.cost_model = cost_model

    # -- submission ------------------------------------------------------
    def open_group(self, workers: int = 16, rpm: float = 0.0) -> DispatchGroup:
        return DispatchGroup(max(1, int(workers)), float(rpm))

    def submit_one(self, request: InferenceRequest
                   ) -> Tuple[InferenceHandle, bool]:
        """Enqueue one request.  Returns (handle, owned): owned is False
        when the request joined an identical pending handle (in-flight
        dedup) — the joiner must not account the call's tokens."""
        with self._lock:
            if self._closed:
                raise RuntimeError("InferenceService is shut down")
            if request.session and request.session in self._cancelled_sessions:
                # the session's scope fired: nothing new may enter the
                # queues on its behalf (retries/fallbacks die fast here
                # instead of re-queueing work the client walked away from)
                raise QueryCancelled(
                    f"session {request.session!r} cancelled")
            self.stats.submitted += 1
            sess = self._session_counters(request.session)
            if sess is not None:
                sess.submitted += 1
            if request.dedup:
                h = self._inflight.get(request.dedup_key)
                # joinable while the entry lives (queued, or speculatively
                # dispatched and not yet retired by a flush) — even if the
                # speculative batch already finished, so dedup outcomes
                # never depend on worker timing.  A failed handle is never
                # joined (its error must not propagate to new submitters).
                if h is not None and h._error is None:
                    h.refs += 1
                    self.stats.inflight_dedup_hits += 1
                    if sess is not None:
                        sess.inflight_dedup_hits += 1
                    return h, False
            h = InferenceHandle(request, self)
            self._queues.setdefault(request.queue_key, []).append(h)
            if request.dedup:
                self._inflight[request.dedup_key] = h
            return h, True

    def submit(self, requests: Sequence[InferenceRequest]
               ) -> List[InferenceHandle]:
        return [self.submit_one(r)[0] for r in requests]

    # -- prioritization --------------------------------------------------
    def expected_queue_makespan(self, handles: Sequence[InferenceHandle]
                                ) -> float:
        """Expected makespan of dispatching `handles` as one queue: the
        PR 3 CostModel when available (observed mean per-call latency from
        the statistics store, greedy worker/rpm reduction), else the same
        computation with the default latency model over a prompt-length
        token estimate."""
        req = handles[0].request
        n = len(handles)
        in_t = sum(len(h.request.prompt) for h in handles) / (4.0 * n)
        fallback = default_latency_model(in_t, 4.0 * max(1, len(req.schema)))
        if self.cost_model is not None:
            return self.cost_model.queue_makespan(req.stats_key, n, fallback)
        per = None
        if self.stats_store is not None and req.stats_key:
            rec = self.stats_store.get(req.stats_key)
            if rec is not None and rec.calls:
                per = rec.mean_latency_s
        return makespan([fallback if per is None else per] * n, 16)

    def prioritized(self) -> List[Tuple]:
        """Queue keys in dispatch-priority order: ascending expected
        makespan, ties broken by submission order (stable), so every
        flush drains every queue — prioritization reorders, never
        starves."""
        with self._lock:
            return self._priority_order()

    def _priority_order(self) -> List[Tuple]:
        ranked = []
        for i, (qkey, handles) in enumerate(self._queues.items()):
            if handles:
                ranked.append((self.expected_queue_makespan(handles), i,
                               qkey))
        ranked.sort(key=lambda t: (t[0], t[1]))
        return [qkey for _, _, qkey in ranked]

    # -- dispatch --------------------------------------------------------
    def _take_slices(self, qkey: Tuple, *, speculative: bool = False
                     ) -> List[_DispatchTask]:
        """Pop dispatchable slices of one queue (caller holds the lock).
        Slice boundaries are a pure function of submission order and
        `max_dispatch` — identical whether taken by flush() or kick() —
        so batch composition never depends on dispatch timing.

        In-flight dedup keys are cleared here for flush() takes — flush IS
        the synchronous dispatch point, after which an identical submit
        must re-dispatch.  Speculative takes leave their keys joinable
        (and take only complete slices, a trailing partial stays queued):
        a duplicate submitted before the next flush joins the handle
        exactly as it would have joined the still-queued handle under
        synchronous dispatch, keeping dedup outcomes — hence ExecStats —
        a pure function of submission order, not of when kick() ran.  The
        keys are purged at the next flush (`_purge_dispatched`); a batch
        that failed cannot be joined either way, since `_error` marks its
        handles done."""
        handles = self._queues.get(qkey) or []
        step = self.max_dispatch if self.max_dispatch > 0 else len(handles)
        if step <= 0:
            return []
        n_take = (len(handles) // step) * step if speculative \
            else len(handles)
        if n_take == 0:
            return []
        take, rest = handles[:n_take], handles[n_take:]
        if rest:
            self._queues[qkey] = rest
        else:
            self._queues.pop(qkey, None)
        tasks = []
        for s in range(0, len(take), step):
            batch = take[s:s + step]
            if not speculative:
                for h in batch:
                    if h.request.dedup:
                        self._inflight.pop(h.request.dedup_key, None)
            tasks.append(_DispatchTask(batch, speculative=speculative))
        return tasks

    def _purge_dispatched(self) -> None:
        """Drop in-flight entries whose dispatch already started (left
        joinable by speculative kicks) — flush is the moment synchronous
        dispatch would have retired them (caller holds the lock)."""
        stale = [k for k, h in self._inflight.items()
                 if h.done or h._event is not None]
        for k in stale:
            del self._inflight[k]

    def _workers_for(self, task: _DispatchTask) -> int:
        return task.handles[0].request.executor.dispatch_workers()

    def flush(self) -> None:
        """Dispatch every queued request, smallest expected makespan
        first.  Each per-queue slice of at most `max_dispatch` requests is
        one dispatch batch: one `complete_many` executor call.  Batches
        for backends that declare dispatch concurrency are scheduled on
        their worker lanes (non-blocking) BEFORE the synchronous batches
        run inline, so background dispatch overlaps the inline work."""
        inline: List[_DispatchTask] = []
        background: List[_DispatchTask] = []
        with self._lock:
            self._purge_dispatched()
            for qkey in self._priority_order():
                for task in self._take_slices(qkey):
                    if self._workers_for(task) > 1:
                        background.append(task)
                    else:
                        inline.append(task)
            for task in background:
                self._schedule(task)
        # an executor failure marks its own batch's handles (they raise at
        # result()) but must not strand the other popped batches — dispatch
        # them all, then re-raise the first failure like the old
        # queue-at-a-time flush did
        first_err: Optional[BaseException] = None
        for task in inline:
            try:
                self._dispatch(task.handles)
            except BaseException as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err

    def drain_for(self, handles: Sequence[InferenceHandle]) -> None:
        """Dispatch until every given handle is dispatched or scheduled.
        Slices are taken in the same priority order and with the same
        prefix-of-the-queue composition as flush(), but the take stops at
        the slice containing the LAST target handle: requests queued
        behind the targets — later inflight windows, other sessions'
        work — stay queued for their own resolve.  That is what makes
        early-exit real: a Limit that closes its pipeline can still
        cancel the next window's requests before any flush dispatches
        them (with max_dispatch=0 a queue is a single slice, so this
        degenerates to flush's whole-queue dispatch and nothing changes).
        Batch membership remains a pure function of submission order."""
        first_err: Optional[BaseException] = None
        targets = set(handles)
        while True:
            inline: List[_DispatchTask] = []
            with self._lock:
                self._purge_dispatched()
                todo = {h.request.queue_key for h in targets
                        if not h.done and h._event is None}
                if not todo:
                    break
                progressed = False
                for qkey in self._priority_order():
                    if qkey not in todo:
                        continue
                    for task in self._take_slices_for(qkey, targets):
                        progressed = True
                        if self._workers_for(task) > 1:
                            self._schedule(task)
                        else:
                            inline.append(task)
                if not progressed:
                    break       # targets left the queues (cancelled)
            for task in inline:
                try:
                    self._dispatch(task.handles)
                except BaseException as e:
                    if first_err is None:
                        first_err = e
        if first_err is not None:
            raise first_err

    def _take_slices_for(self, qkey: Tuple, targets: set
                         ) -> List[_DispatchTask]:
        """Like `_take_slices` (non-speculative), but only the prefix of
        the queue through the last target handle, rounded up to a slice
        boundary (caller holds the lock)."""
        handles = self._queues.get(qkey) or []
        step = self.max_dispatch if self.max_dispatch > 0 else len(handles)
        if step <= 0:
            return []
        last = -1
        for i, h in enumerate(handles):
            if h in targets:
                last = i
        if last < 0:
            return []
        n_take = ((last // step) + 1) * step
        take, rest = handles[:n_take], handles[n_take:]
        if rest:
            self._queues[qkey] = rest
        else:
            self._queues.pop(qkey, None)
        tasks = []
        for s in range(0, len(take), step):
            batch = take[s:s + step]
            for h in batch:
                if h.request.dedup:
                    self._inflight.pop(h.request.dedup_key, None)
            tasks.append(_DispatchTask(batch))
        return tasks

    def kick(self) -> None:
        """Speculative flush of hot queues: start, in the background, the
        complete `max_dispatch`-sized slices that a later flush() would
        dispatch anyway, for backends with dispatch concurrency.  Called
        by operators after submitting a window so dispatch overlaps the
        production of the next window, before `inflight_windows` fills.
        A no-op when `max_dispatch` is 0 (an unbounded flush batches the
        whole queue in one call — dispatching early would change batch
        composition) or when the backend is synchronous."""
        if not self.speculative or self.max_dispatch <= 0:
            return
        with self._lock:
            if self._closed:
                return
            # no prioritization here: every eligible slice is handed to a
            # background lane anyway, and kick runs after every submitted
            # window — keep it O(queues), not O(pending requests)
            for qkey in list(self._queues):
                handles = self._queues.get(qkey)
                if not handles or len(handles) < self.max_dispatch:
                    continue
                if handles[0].request.executor.dispatch_workers() <= 1:
                    continue
                for task in self._take_slices(qkey, speculative=True):
                    self._schedule(task)

    # -- worker lanes ----------------------------------------------------
    def _schedule(self, task: _DispatchTask) -> None:
        """Hand one batch to its backend's lane (caller holds the lock)."""
        for h in task.handles:
            h._event = threading.Event()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.POOL_THREADS,
                thread_name_prefix="ipdb-dispatch")
        ex = task.handles[0].request.executor
        lane = self._lanes.get(id(ex))
        if lane is None:
            lane = self._lanes[id(ex)] = _Lane(self._workers_for(task))
        else:
            lane.workers = self._workers_for(task)
        self._outstanding += 1
        if task.speculative:
            self.stats.speculative_batches += 1
        lane.pending.append(task)
        self._pump(lane)

    def _pump(self, lane: _Lane) -> None:
        while lane.active < lane.workers and lane.pending:
            task = lane.pending.popleft()
            lane.active += 1
            self._pool.submit(self._run_task, lane, task)

    def _run_task(self, lane: _Lane, task: _DispatchTask) -> None:
        try:
            self._dispatch(task.handles, background=True)
        except Exception:
            pass                       # recorded on the handles already
        finally:
            with self._lock:
                lane.active -= 1
                self._outstanding -= 1
                if self._pool is not None:
                    self._pump(lane)
                if self._outstanding == 0:
                    self._idle.notify_all()

    # -- resilience ------------------------------------------------------
    def breaker_for(self, model_name: str) -> CircuitBreaker:
        """The (lazily created) circuit breaker guarding one backend."""
        with self._lock:
            b = self._breakers.get(model_name)
            if b is None:
                b = self._breakers[model_name] = CircuitBreaker(
                    model_name, failure_threshold=self.breaker_threshold,
                    probe_every=self.breaker_probe_every)
            return b

    def set_breaker_policy(self, threshold: int, probe_every: int) -> None:
        """Apply a (possibly changed) breaker policy to future AND already
        existing breakers — SET breaker_threshold must not be ignored just
        because a backend already saw traffic."""
        with self._lock:
            self.breaker_threshold = max(1, int(threshold))
            self.breaker_probe_every = max(1, int(probe_every))
            for b in self._breakers.values():
                b.failure_threshold = self.breaker_threshold
                b.probe_every = self.breaker_probe_every

    def breaker_open(self, model_name: str = "") -> bool:
        """True when the named breaker (or, with "", any breaker) is not
        closed — the front door's 503 admission signal."""
        with self._lock:
            if model_name:
                b = self._breakers.get(model_name)
                return b is not None and b.state != CLOSED
            return any(b.state != CLOSED for b in self._breakers.values())

    def breaker_snapshots(self) -> Dict[str, Dict[str, object]]:
        """Counters for every breaker that has seen a failure/rejection
        (EXPLAIN's -- resilience -- section; quiet breakers are elided)."""
        with self._lock:
            brs = list(self._breakers.items())
        return {name: b.snapshot() for name, b in brs
                if b.failures or b.rejections or b.state != CLOSED}

    def note_transient_retry(self, session: str = "", n: int = 1) -> None:
        """Operator hook: a resolve path re-submitted after a transient
        failure (counted here so the resilience section and per-session
        ExecStats see retries the executors never know about)."""
        with self._lock:
            self.stats.transient_retries += n
            sess = self._session_counters(session)
            if sess is not None:
                sess.transient_retries += n

    def note_deadline_drop(self, session: str = "", n: int = 1) -> None:
        """Operator hook: work abandoned because the deadline expired
        before it could even be submitted/retried."""
        with self._lock:
            self.stats.deadline_drops += n
            sess = self._session_counters(session)
            if sess is not None:
                sess.deadline_drops += n

    def _fail_batch(self, handles: List[InferenceHandle],
                    err: BaseException) -> None:
        with self._lock:
            for h in handles:
                h._error = err
                if h._event is not None:
                    h._event.set()

    def _call_executor(self, executor: Predictor,
                       reqs: List[InferenceRequest]) -> List[CallResult]:
        """One `complete_many` call, bounded by `call_timeout_s` when set.

        The bounded path runs the call on a daemon guard thread and joins
        it with the timeout: a hung backend strands only that zombie
        thread (its late result is discarded), while the lane worker
        returns `BackendTimeout` — so a wedged executor can no longer pin
        its lane, `drain()`, or `shutdown()` forever.  0 disables the
        guard and is byte-for-byte the old direct call."""
        args = ([r.prompt for r in reqs], list(reqs[0].schema),
                [r.num_rows for r in reqs])
        kwargs = dict(shared_prefix=reqs[0].shared_prefix,
                      rows_list=[r.rows for r in reqs],
                      instruction=reqs[0].instruction)
        timeout = float(self.call_timeout_s or 0.0)
        if timeout <= 0.0:
            return executor.complete_many(*args, **kwargs)
        box: Dict[str, object] = {}
        done = threading.Event()

        def _guard():
            try:
                box["res"] = executor.complete_many(*args, **kwargs)
            except BaseException as e:
                box["err"] = e
            finally:
                done.set()

        threading.Thread(target=_guard, daemon=True,
                         name="ipdb-call-guard").start()
        if not done.wait(timeout):
            raise BackendTimeout(
                f"{reqs[0].model_name}: dispatch batch of {len(reqs)} "
                f"exceeded call_timeout_s={timeout:g}; result discarded")
        if "err" in box:
            raise box["err"]  # type: ignore[misc]
        return box["res"]  # type: ignore[return-value]

    def _dispatch(self, handles: List[InferenceHandle],
                  background: bool = False) -> None:
        reqs = [h.request for h in handles]
        executor = reqs[0].executor
        # deadline propagation: expired work is dropped, not dispatched.
        # The whole batch shares one query's deadline (batches are
        # session-pure and deadline_ts is stamped once per query).
        dl = reqs[0].deadline_ts
        if dl and time.monotonic() >= dl:
            with self._lock:
                self.stats.deadline_drops += len(reqs)
                sess = self._session_counters(reqs[0].session)
                if sess is not None:
                    sess.deadline_drops += len(reqs)
            self._fail_batch(handles, DeadlineExceeded(
                f"deadline expired before dispatch "
                f"({len(reqs)} requests dropped)"))
            return
        breaker = self.breaker_for(reqs[0].model_name)
        if not breaker.allow():
            with self._lock:
                self.stats.breaker_rejections += len(reqs)
                sess = self._session_counters(reqs[0].session)
                if sess is not None:
                    sess.breaker_rejections += len(reqs)
            self._fail_batch(handles, CircuitOpenError(
                f"circuit open for backend {reqs[0].model_name!r}"))
            return
        try:
            results = self._call_executor(executor, reqs)
        except BaseException as e:
            if isinstance(e, BackendTimeout):
                with self._lock:
                    self.stats.backend_timeouts += 1
                    sess = self._session_counters(reqs[0].session)
                    if sess is not None:
                        sess.backend_timeouts += 1
            self._fail_batch(handles, e)
            # transient-class failures feed the breaker and are recorded
            # on the handles only — retry policy belongs to the resolving
            # operator, and one backend's hiccup must not propagate out of
            # flush()/drain_for() into an unrelated operator's resolve.
            # Non-transient errors bypass the breaker (they indicate a
            # caller bug, not backend health) and re-raise like before.
            if isinstance(e, TransientError):
                breaker.record_failure()
                return
            raise
        breaker.record_success()
        with self._lock:
            self.stats.dispatch_batches += 1
            self.stats.dispatched_calls += len(reqs)
            if background:
                self.stats.async_batches += 1
            # batches are session/tenant-homogeneous (tags are part of
            # queue_key), so whole-batch attribution is exact
            sess = self._session_counters(reqs[0].session)
            if sess is not None:
                sess.dispatch_batches += 1
                sess.dispatched_calls += len(reqs)
            if reqs[0].tenant:
                self._tenant_calls[reqs[0].tenant] += len(reqs)
            for h, res in zip(handles, results):
                h._result = res
                if h._event is not None:
                    h._event.set()
                # cascade batches degraded to proxy-only stamp the count
                # on their first merged CallResult (like the other
                # whole-batch cascade counters)
                dc = getattr(res, "degraded_calls", 0)
                if dc:
                    self.stats.degraded_calls += dc
        if self.stats_store is not None:
            for h, res in zip(handles, results):
                if h.request.stats_key:
                    self.stats_store.record_call(
                        staged_key(h.request.stats_key, h.request.stage),
                        res.in_tokens, res.out_tokens, res.sim_latency_s)

    # -- forcing / lifecycle ---------------------------------------------
    def _force(self, handle: InferenceHandle) -> None:
        """Block until `handle` is resolved: flush if it is still queued,
        then wait for its dispatch batch if one is running."""
        if not handle.done and handle._event is None:
            self.flush()               # still queued (or cancelled)
        ev = handle._event
        if ev is not None:
            ev.wait()

    def drain(self) -> None:
        """Flush until no request remains queued, then wait for every
        background dispatch batch to finish."""
        while True:
            with self._lock:
                if not any(self._queues.values()):
                    break
            self.flush()
        self.wait_idle()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Wait until no background dispatch is outstanding.  Returns
        False on timeout."""
        with self._idle:
            return self._idle.wait_for(lambda: self._outstanding == 0,
                                       timeout=timeout)

    def shutdown(self, *, cancel_pending: bool = False) -> None:
        """Stop the service and join every worker thread (idempotent).
        With `cancel_pending` still-queued requests are dropped (their
        handles raise on `result()`); otherwise they are drained first.
        Either way, batches already running complete — a flush that has
        started is never interrupted mid-executor-call."""
        if not cancel_pending:
            self.drain()
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for handles in self._queues.values():
                for h in handles:
                    if h.request.dedup:
                        self._inflight.pop(h.request.dedup_key, None)
            self._queues.clear()
            # lane backlogs (scheduled but not yet running) will never be
            # pumped once the pool is gone: resolve their handles to a
            # shutdown error and release their outstanding counts, or
            # wait_idle below would block forever
            err = RuntimeError("InferenceService shut down before dispatch")
            for lane in self._lanes.values():
                while lane.pending:
                    task = lane.pending.popleft()
                    self._outstanding -= 1
                    for h in task.handles:
                        h._error = err
                        if h._event is not None:
                            h._event.set()
            self._lanes.clear()
            pool, self._pool = self._pool, None
            if self._outstanding == 0:
                self._idle.notify_all()
        if pool is not None:
            pool.shutdown(wait=True)
        self.wait_idle()

    def cancel(self, handle: InferenceHandle) -> bool:
        """Release one submitter's interest in a still-queued handle
        (pipelined operator closed early, e.g. under an early-exit Limit).
        The request is removed from its queue only when the last
        submitter cancels — joined submitters keep it alive.  A handle
        whose dispatch batch already started (flush or speculative kick)
        cannot be recalled: cancel returns False and the running batch
        completes normally.

        Refcount edge (regression-tested): the count is floored at 0 so a
        cancel that arrives after the handle was force-failed (session
        cancel, shutdown) or double-cancelled through two unwinding
        pipelines can never underflow and strip a ref a still-waiting
        joiner is counting on."""
        with self._lock:
            if handle.done:
                return False
            handle.refs = max(0, handle.refs - 1)
            if handle.refs > 0:
                return False
            q = self._queues.get(handle.request.queue_key)
            if q and handle in q:
                q.remove(handle)
                if not q:
                    self._queues.pop(handle.request.queue_key, None)
                if handle.request.dedup:
                    self._inflight.pop(handle.request.dedup_key, None)
                sess = self._session_counters(handle.request.session)
                if sess is not None:
                    sess.cancelled_requests += 1
                return True
            return False

    # -- front-door sessions ---------------------------------------------
    def _session_counters(self, session: str) -> Optional[SessionCounters]:
        """Counters for a tagged session ("" = untagged → None).  Caller
        holds the lock."""
        if not session:
            return None
        sess = self._sessions.get(session)
        if sess is None:
            sess = self._sessions[session] = SessionCounters()
        return sess

    def session_stats(self, session: str) -> SessionCounters:
        with self._lock:
            return dataclasses.replace(
                self._sessions.get(session) or SessionCounters())

    def tenant_dispatched(self, tenant: str) -> int:
        """Executor calls dispatched so far on behalf of `tenant` — the
        fairness scheduler's post-paid cost signal."""
        with self._lock:
            return self._tenant_calls.get(tenant, 0)

    def session_pending(self, session: str) -> int:
        """Still-queued requests tagged with `session` (leak check)."""
        with self._lock:
            return sum(1 for handles in self._queues.values()
                       for h in handles if h.request.session == session)

    def cancel_session(self, session: str) -> int:
        """Cancel-scope hook: drop every still-queued request of one
        session NOW, from the cancelling thread, without waiting for the
        executing pipeline to unwind.  Dropped handles fail with
        `QueryCancelled` (waking any blocked `result()`), lane backlogs
        that were scheduled but have not started are dropped too, and
        further submits for the session are rejected.  Batches whose
        executor call already started complete normally — cancellation
        takes effect within one flush, never mid-call.  Returns the
        number of requests dropped."""
        if not session:
            return 0
        err = QueryCancelled(f"session {session!r} cancelled")
        dropped = 0
        with self._lock:
            self._cancelled_sessions.add(session)
            for qkey in list(self._queues):
                handles = self._queues[qkey]
                if not handles or handles[0].request.session != session:
                    continue                   # queues are session-pure
                del self._queues[qkey]
                for h in handles:
                    if h.request.dedup:
                        self._inflight.pop(h.request.dedup_key, None)
                    h.refs = 0
                    h._error = err
                    if h._event is not None:
                        h._event.set()
                    dropped += 1
            # scheduled-but-not-started lane tasks: same treatment as
            # shutdown's backlog release (outstanding count must drop or
            # wait_idle deadlocks)
            for lane in self._lanes.values():
                keep: Deque[_DispatchTask] = collections.deque()
                while lane.pending:
                    task = lane.pending.popleft()
                    if task.handles[0].request.session != session:
                        keep.append(task)
                        continue
                    self._outstanding -= 1
                    for h in task.handles:
                        if h.request.dedup:
                            self._inflight.pop(h.request.dedup_key, None)
                        h.refs = 0
                        h._error = err
                        if h._event is not None:
                            h._event.set()
                        dropped += 1
                lane.pending = keep
            sess = self._session_counters(session)
            if sess is not None:
                sess.cancelled_requests += dropped
            if self._outstanding == 0:
                self._idle.notify_all()
        return dropped

    def release_session(self, session: str) -> None:
        """Forget a finished session's tombstone + counters (the front
        door calls this when the session object is torn down, so the
        per-session maps stay bounded by live sessions)."""
        with self._lock:
            self._cancelled_sessions.discard(session)
            self._sessions.pop(session, None)

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._queues.values())

    @property
    def inflight_batches(self) -> int:
        with self._lock:
            return self._outstanding

    def describe(self) -> str:
        return (f"InferenceService queues={len(self._queues)} "
                f"pending={self.pending} max_dispatch="
                f"{self.max_dispatch or 'unbounded'} "
                f"speculative={self.speculative}")
