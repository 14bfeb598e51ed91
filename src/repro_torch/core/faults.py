"""Fault model, circuit breakers, and the deterministic chaos harness.

Three pieces live here, shared by the service, the predict operators,
the cascade, and the front door:

* An **error taxonomy** splitting retryable transport-level failures
  (``TransientError`` and subclasses) from non-retryable ones.  The
  ``InferenceService`` records transient-class errors on the affected
  handles instead of re-raising them out of ``flush``/``drain_for``, so
  one backend's hiccup cannot crash an unrelated operator's resolve.
* A per-backend **``CircuitBreaker``** (closed / open / half-open).
  Probe scheduling is *count-based*, not wall-clock-based: while open,
  every ``probe_every``-th attempted call is let through as a half-open
  probe.  This keeps breaker behavior deterministic under the scripted
  test harness (no sleeps, no clocks) while preserving the production
  semantics: a hung or dead backend is load-shed after
  ``failure_threshold`` consecutive failures and re-checked at a bounded
  rate.
* A seeded **``FaultInjector``** predictor wrapper.  Every injection
  decision is a pure function of ``(seed, prompt, occurrence)`` — the
  n-th time a given prompt is attempted it always gets the same fate,
  regardless of batch composition or dispatch-worker count.  Transient
  faults fire only on a prompt's *first* occurrence, so a retried call
  deterministically succeeds and chaos runs stay byte-identical to
  fault-free runs.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .executors import CallResult, Predictor


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class TransientError(RuntimeError):
    """Retryable transport/backend failure (timeout, 5xx, breaker)."""


class TransientBackendError(TransientError):
    """Injected or real transient backend exception (a 5xx analogue)."""


class BackendTimeout(TransientError):
    """A dispatch lane's per-call timeout expired; the call is a zombie."""


class CircuitOpenError(TransientError):
    """The backend's circuit breaker is open; the call was load-shed."""


class DeadlineExceeded(RuntimeError):
    """The query's end-to-end deadline expired; work dropped, not retried."""


def is_transient(exc: BaseException) -> bool:
    return isinstance(exc, TransientError)


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-backend breaker with deterministic count-based probing.

    State machine:

    * **closed** — calls pass.  ``failure_threshold`` *consecutive*
      failures trip the breaker to **open**.
    * **open** — calls are rejected with ``CircuitOpenError``; every
      ``probe_every``-th attempt instead passes as a **half-open** probe.
    * **half-open** — exactly one in-flight probe.  Success closes the
      breaker; failure re-opens it (resetting the probe countdown).

    All transitions are driven by call outcomes, never wall-clock time,
    so tests and replays see identical breaker histories.
    """

    def __init__(self, name: str, *, failure_threshold: int = 3,
                 probe_every: int = 4) -> None:
        self.name = name
        self.failure_threshold = max(1, int(failure_threshold))
        self.probe_every = max(1, int(probe_every))
        self.state = CLOSED
        self.consecutive_failures = 0
        self._rejected_since_probe = 0
        self._probe_inflight = False
        self.failures = 0
        self.successes = 0
        self.rejections = 0
        self.opens = 0
        self.probes = 0
        self._lock = threading.Lock()

    def allow(self) -> bool:
        """Admission check; counts a rejection when returning False."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == HALF_OPEN:
                # one probe at a time; everyone else is shed
                self.rejections += 1
                return False
            # open: let every probe_every-th attempt through as a probe
            self._rejected_since_probe += 1
            if (not self._probe_inflight
                    and self._rejected_since_probe >= self.probe_every):
                self.state = HALF_OPEN
                self._probe_inflight = True
                self._rejected_since_probe = 0
                self.probes += 1
                return True
            self.rejections += 1
            return False

    def record_success(self) -> None:
        with self._lock:
            self.successes += 1
            self.consecutive_failures = 0
            if self.state in (HALF_OPEN, OPEN):
                self.state = CLOSED
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            self.consecutive_failures += 1
            if self.state == HALF_OPEN:
                self.state = OPEN
                self._probe_inflight = False
                self._rejected_since_probe = 0
            elif (self.state == CLOSED
                    and self.consecutive_failures >= self.failure_threshold):
                self.state = OPEN
                self.opens += 1
                self._rejected_since_probe = 0

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "state": self.state,
                "failures": self.failures,
                "successes": self.successes,
                "rejections": self.rejections,
                "opens": self.opens,
                "probes": self.probes,
            }


# ---------------------------------------------------------------------------
# Fault injector
# ---------------------------------------------------------------------------

def _decide(seed: int, prompt: str, occurrence: int, salt: str) -> float:
    """Deterministic uniform [0,1) from (seed, prompt, occurrence, salt)."""
    h = hashlib.sha256(
        f"{seed}:{salt}:{occurrence}:{prompt}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultInjector(Predictor):
    """Deterministic chaos wrapper around any ``Predictor``.

    Fault classes (rates are independent probabilities per first-occurrence
    call; retries of the same prompt are deterministic successes):

    * ``transient_rate`` — raise ``TransientBackendError`` for the batch.
    * ``malform_rate``   — truncate the returned text mid-JSON.
    * ``latency_rate``   — multiply simulated latency by ``latency_spike``.
    * ``hang_s``         — with ``hang_rate``, block the call for up to
      ``hang_s`` wall seconds (releasable via :meth:`release_hangs` so
      tests never actually sleep that long).
    * ``outage`` — a ``(first_call, last_call)`` global call-index window
      during which *every* call raises ``TransientBackendError``
      irrespective of per-prompt decisions (a full-backend outage).

    The wrapper is registered like any custom predictor and is fully
    transparent when all rates are zero.
    """

    def __init__(self, inner: Predictor, *, seed: int = 0,
                 transient_rate: float = 0.0, malform_rate: float = 0.0,
                 latency_rate: float = 0.0, latency_spike: float = 8.0,
                 hang_rate: float = 0.0, hang_s: float = 30.0,
                 outage: Optional[Tuple[int, int]] = None) -> None:
        self.inner = inner
        self.seed = int(seed)
        self.transient_rate = float(transient_rate)
        self.malform_rate = float(malform_rate)
        self.latency_rate = float(latency_rate)
        self.latency_spike = float(latency_spike)
        self.hang_rate = float(hang_rate)
        self.hang_s = float(hang_s)
        self.outage = outage
        self.name = getattr(inner, "name", "faulty")
        self.options = getattr(inner, "options", {})
        self.max_concurrency = getattr(inner, "max_concurrency", 1)
        self._lock = threading.Lock()
        self._occurrence: Dict[str, int] = {}
        self._calls = 0
        self._hang_events: List[threading.Event] = []
        self.counters: Dict[str, int] = {
            "calls": 0, "transient": 0, "malformed": 0,
            "latency_spikes": 0, "hangs": 0, "outage_rejects": 0,
        }

    # -- Predictor plumbing delegates to the wrapped backend ------------
    def configure(self, options) -> None:
        self.inner.configure(options)
        self.options = getattr(self.inner, "options", options)

    def load(self) -> None:
        self.inner.load()

    def dispatch_workers(self) -> int:
        return self.inner.dispatch_workers()

    @property
    def stats_stage(self) -> str:
        return getattr(self.inner, "stats_stage", "")

    # -- chaos controls --------------------------------------------------
    def release_hangs(self) -> None:
        """Unblock every in-flight injected hang immediately."""
        with self._lock:
            evs, self._hang_events = self._hang_events, []
        for ev in evs:
            ev.set()

    def _occ(self, prompt: str) -> int:
        with self._lock:
            n = self._occurrence.get(prompt, 0)
            self._occurrence[prompt] = n + 1
            return n

    def _tick(self, n: int = 1) -> int:
        with self._lock:
            first = self._calls
            self._calls += n
            self.counters["calls"] += n
            return first

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    def _maybe_hang(self, prompt: str, occ: int) -> None:
        if self.hang_rate <= 0.0:
            return
        if _decide(self.seed, prompt, occ, "hang") < self.hang_rate:
            ev = threading.Event()
            with self._lock:
                self._hang_events.append(ev)
            self._bump("hangs")
            ev.wait(self.hang_s)

    def _mangle(self, res: CallResult, prompt: str, occ: int) -> CallResult:
        if (self.malform_rate > 0.0 and occ == 0
                and _decide(self.seed, prompt, occ, "malform")
                < self.malform_rate):
            self._bump("malformed")
            res.text = res.text[: max(1, len(res.text) // 2)].rstrip("}] \n")
        if (self.latency_rate > 0.0
                and _decide(self.seed, prompt, occ, "latency")
                < self.latency_rate):
            self._bump("latency_spikes")
            res.sim_latency_s *= self.latency_spike
        return res

    # -- the wrapped call ------------------------------------------------
    def complete(self, prompt, schema, num_rows, *, shared_prefix="",
                 rows=None, instruction=""):
        return self.complete_many(
            [prompt], schema, [num_rows], shared_prefix=shared_prefix,
            rows_list=[rows], instruction=instruction)[0]

    def complete_many(self, prompts, schema, num_rows_list, *,
                      shared_prefix="", rows_list=None, instruction=""):
        first = self._tick(len(prompts))
        if self.outage is not None:
            lo, hi = self.outage
            if any(lo <= first + i <= hi for i in range(len(prompts))):
                self._bump("outage_rejects", len(prompts))
                raise TransientBackendError(
                    f"{self.name}: injected outage window {self.outage}")
        occs = [self._occ(p) for p in prompts]
        for p, occ in zip(prompts, occs):
            if (self.transient_rate > 0.0 and occ == 0
                    and _decide(self.seed, p, occ, "transient")
                    < self.transient_rate):
                self._bump("transient")
                raise TransientBackendError(
                    f"{self.name}: injected transient failure")
            self._maybe_hang(p, occ)
        out = self.inner.complete_many(
            list(prompts), schema, list(num_rows_list),
            shared_prefix=shared_prefix, rows_list=rows_list,
            instruction=instruction)
        return [self._mangle(r, p, occ)
                for r, p, occ in zip(out, prompts, occs)]


# ---------------------------------------------------------------------------
# EXPLAIN helper
# ---------------------------------------------------------------------------

def resilience_section(service, options) -> str:
    """Render the body of the ``-- resilience --`` EXPLAIN section (the
    database adds the section header, like every other section)."""
    lines = []
    st = service.stats
    lines.append(
        "retries transient={t} deadline_drops={d} timeouts={o} "
        "degraded_calls={g}".format(
            t=st.transient_retries, d=st.deadline_drops,
            o=st.backend_timeouts, g=st.degraded_calls))
    brk = service.breaker_snapshots()
    if not brk:
        lines.append("breakers: none tripped")
    for name in sorted(brk):
        b = brk[name]
        lines.append(
            "breaker {n}: state={s} failures={f} rejections={r} "
            "opens={o} probes={p}".format(
                n=name, s=b["state"], f=b["failures"], r=b["rejections"],
                o=b["opens"], p=b["probes"]))
    lines.append(
        "policy: call_timeout_s={ct} retry_backoff_s={rb} "
        "breaker_threshold={bt} breaker_probe_every={pe}".format(
            ct=options.get("call_timeout_s", 0),
            rb=options.get("retry_backoff_s", 0),
            bt=options.get("breaker_threshold", 3),
            pe=options.get("breaker_probe_every", 4)))
    return "\n".join(lines)
