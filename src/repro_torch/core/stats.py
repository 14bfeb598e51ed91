"""Adaptive statistics + cost model for the semantic optimizer.

The paper's §6 reorderings (select ordering, select-vs-join, predict
pull-up) only pay off when the optimizer knows predicate selectivities and
per-call costs.  This module closes the loop:

  StatisticsStore   database-owned, persists across queries (exactly like
                    the cross-query PromptCache).  Per (model, instruction)
                    key it accumulates observed selectivity (rows in vs
                    rows passing the semantic predicate), input/output
                    token counts, per-call modeled latency, and retry/
                    fallback rates.  Fed by
                      * the physical layer — FilterOp-over-PredictOp and
                        SemanticJoinOp record predicate pass rates as
                        chunks/windows resolve;
                      * the InferenceService — every dispatched call
                        records its tokens and modeled latency;
                      * the PredictOperator — strict retries and per-tuple
                        fallbacks.

  CostModel         turns a store record (or, lacking one, the optimizer's
                    static hints) into a CostEstimate: expected calls ×
                    tokens × per-call latency, reduced through the same
                    greedy worker-pool + rate-limit makespan model the
                    executor reports (`service.makespan`).  The optimizer
                    ranks commuting semantic selects by the classic
                    cost/(1 - selectivity) rule, which minimizes expected
                    stack cost (and, at uniform per-call cost, expected
                    call count).

  PilotSampler      for predicates with NO history the optimizer dispatches
                    a small deterministic reservoir sample (default 16
                    rows) through the normal PredictOperator path at
                    optimize time.  Answers land in the cross-query
                    PromptCache, so pilot work is never wasted; pilot calls
                    are accounted separately (`ExecStats.pilot_calls`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import math
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.executors import default_latency_model
from repro_torch.core.service import makespan, staged_key

__all__ = ["stats_key", "staged_key", "PredicateStats", "CascadeStats",
           "CascadeCalibration", "StatisticsStore", "CostEstimate",
           "CostModel", "PilotSampler", "expected_stack_cost", "order_rank",
           "stats_section"]


def stats_key(info) -> Tuple[str, str]:
    """Store key for a PredictInfo: (model, raw instruction).  Uses the
    user-written instruction (not the fully rendered prompt preamble) so
    the key is stable across schema-preamble tweaks."""
    instr = info.prompt.instruction if info.prompt else \
        "predict " + ", ".join(n for n, _ in info.outputs)
    return (info.model_name, instr)


#: chunk-level predicate records kept in the sliding recency window
_RECENT_WINDOW = 32


@dataclasses.dataclass
class PredicateStats:
    """Accumulated observations for one (model, instruction) key."""
    rows_in: int = 0          # predicate inputs observed
    rows_passed: int = 0      # inputs that satisfied the predicate
    calls: int = 0            # executor calls dispatched
    in_tokens: int = 0
    out_tokens: int = 0
    latency_s: float = 0.0    # sum of per-call modeled latencies
    retries: int = 0
    fallbacks: int = 0
    pilot_calls: int = 0      # subset of `calls` made by pilot sampling
    pilot_rows: int = 0       # subset of `rows_in` observed by pilots
    # sliding window of the last `_RECENT_WINDOW` (rows_in, rows_passed)
    # chunk records: the decayed view the rewrite engine / mid-query
    # re-ranker consults so drifting data cannot pin a stale order.  The
    # lifetime `selectivity` stays the planner's deterministic default —
    # windowed reads are opt-in (window content depends on record order,
    # which concurrent sessions interleave).
    recent: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=_RECENT_WINDOW))

    @property
    def selectivity(self) -> Optional[float]:
        if self.rows_in <= 0:
            return None
        return self.rows_passed / self.rows_in

    @property
    def windowed_selectivity(self) -> Optional[float]:
        """Pass rate over the recency window only (None when empty)."""
        rin = sum(r for r, _ in self.recent)
        if rin <= 0:
            return None
        return sum(p for _, p in self.recent) / rin

    @property
    def mean_in_tokens(self) -> Optional[float]:
        return self.in_tokens / self.calls if self.calls else None

    @property
    def mean_out_tokens(self) -> Optional[float]:
        return self.out_tokens / self.calls if self.calls else None

    @property
    def mean_latency_s(self) -> Optional[float]:
        return self.latency_s / self.calls if self.calls else None

    @property
    def retry_rate(self) -> float:
        return self.retries / self.calls if self.calls else 0.0

    @property
    def fallback_rate(self) -> float:
        return self.fallbacks / self.calls if self.calls else 0.0


#: confidence-histogram resolution for cascade score sketches
_CASCADE_BINS = 20
#: held-out agreement reservoir capacity per (model, instruction) key
_CASCADE_RESERVOIR = 256


class CascadeStats:
    """Cascade calibration state for one (model, instruction) key:

      * a held-out AGREEMENT RESERVOIR — up to `_CASCADE_RESERVOIR`
        (row_hash → (proxy confidence, proxy verdict, proxy == expensive))
        records from escalated/audited rows, the ground truth behind
        threshold calibration.  Keyed by the deterministic row hash and
        evicted keep-smallest-hashes, the reservoir's final content is a
        pure set-union of everything recorded — independent of the order
        concurrent dispatch workers insert in (the store's determinism
        contract);
      * SCORE-DISTRIBUTION SKETCHES — per-verdict confidence histograms
        over every proxy-scored row, used to estimate the escalation rate
        a threshold pair implies;
      * routing counters (rows routed/escalated, per-stage calls, audit
        agreement), all order-independent sums.
    """
    __slots__ = ("reservoir", "_heap", "hist_pos", "hist_neg", "routed_rows",
                 "escalated_rows", "proxy_calls", "expensive_calls",
                 "audited", "audit_agree", "degraded_batches")

    def __init__(self):
        self.reservoir: Dict[int, Tuple[float, bool, bool]] = {}
        # max-heap over the reservoir keys (stored negated): capacity
        # eviction pops the current largest hash in O(log n) instead of
        # re-sorting the whole reservoir under the lock on every insert.
        # Invariant: _heap holds exactly the reservoir's keys, once each.
        self._heap: List[int] = []
        self.hist_pos = np.zeros(_CASCADE_BINS, np.int64)
        self.hist_neg = np.zeros(_CASCADE_BINS, np.int64)
        self.routed_rows = 0
        self.escalated_rows = 0
        self.proxy_calls = 0
        self.expensive_calls = 0
        self.audited = 0
        self.audit_agree = 0
        # batches whose expensive stage was skipped (breaker open /
        # transient outage): EXPLAIN surfaces contract status `degraded`
        self.degraded_batches = 0

    @property
    def n_records(self) -> int:
        return len(self.reservoir)


@dataclasses.dataclass
class CascadeCalibration:
    """A calibrated (threshold pair, contract estimate) snapshot for one
    cascade key.  `CascadePredictor.load()` takes ONE snapshot per query —
    evidence recorded while the query runs only affects future queries,
    which is what keeps routing deterministic under concurrent dispatch.

    tau_pos / tau_neg are the per-verdict acceptance thresholds: a
    proxy-positive row resolves immediately iff conf >= tau_pos (likewise
    negative/tau_neg); everything below either threshold escalates.  A
    threshold of 2.0 (> any confidence) means 'always escalate that
    verdict class'."""
    target: float
    tau_pos: float = 2.0
    tau_neg: float = 2.0
    escalation_rate: float = 1.0       # expected escalated-row fraction
    empirical_precision: Optional[float] = None
    n_records: int = 0                 # reservoir size behind the snapshot
    #: cold (not enough held-out evidence: escalate everything),
    #: ok (contract achievable at these thresholds),
    #: unachievable (no threshold meets the target: route direct),
    #: violated (audited precision fell below the target: route direct)
    status: str = "cold"


class StatisticsStore:
    """Cross-query observation store, owned by the database (a sibling of
    `IPDB.prompt_cache`).  All writers go through the record_* methods so
    a future persistent backend only has one surface to replace.

    Writers are lock-protected: with per-backend dispatch pools the
    InferenceService records calls from worker threads concurrently with
    the submitting thread's predicate probes, and the read-modify-write
    counter updates would otherwise lose increments under the GIL.  All
    recorded quantities are order-independent sums, so concurrent dispatch
    cannot change what the store converges to."""

    def __init__(self):
        self._d: Dict[Tuple[str, str], PredicateStats] = {}
        self._c: Dict[Tuple[str, str], CascadeStats] = {}
        self._lock = threading.Lock()

    def entry(self, key: Tuple[str, str]) -> PredicateStats:
        with self._lock:
            rec = self._d.get(key)
            if rec is None:
                rec = self._d[key] = PredicateStats()
            return rec

    def cascade_entry(self, key: Tuple[str, str]) -> CascadeStats:
        with self._lock:
            rec = self._c.get(key)
            if rec is None:
                rec = self._c[key] = CascadeStats()
            return rec

    def cascade_get(self, key: Tuple[str, str]) -> Optional[CascadeStats]:
        with self._lock:
            return self._c.get(key)

    def get(self, key: Tuple[str, str]) -> Optional[PredicateStats]:
        with self._lock:
            return self._d.get(key)

    def keys(self) -> Iterable[Tuple[str, str]]:
        with self._lock:
            return list(self._d.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
            self._c.clear()

    # -- warm-state snapshots (core/snapshot.py) -------------------------
    _PRED_FIELDS = ("rows_in", "rows_passed", "calls", "in_tokens",
                    "out_tokens", "latency_s", "retries", "fallbacks",
                    "pilot_calls", "pilot_rows")
    _CASC_FIELDS = ("routed_rows", "escalated_rows", "proxy_calls",
                    "expensive_calls", "audited", "audit_agree",
                    "degraded_batches")

    def export_state(self) -> Dict[str, object]:
        """Plain-python snapshot payload: every predicate record (with its
        recency window) and every cascade record (reservoir + sketches).
        numpy arrays become lists and the eviction heap is dropped — both
        are rebuilt on restore — so the payload pickles small and stays
        stable across numpy versions."""
        with self._lock:
            preds = {}
            for key, rec in self._d.items():
                d = {f: getattr(rec, f) for f in self._PRED_FIELDS}
                d["recent"] = list(rec.recent)
                preds[key] = d
            cascades = {}
            for key, rec in self._c.items():
                d = {f: getattr(rec, f) for f in self._CASC_FIELDS}
                d["reservoir"] = dict(rec.reservoir)
                d["hist_pos"] = rec.hist_pos.tolist()
                d["hist_neg"] = rec.hist_neg.tolist()
                cascades[key] = d
        return {"predicates": preds, "cascades": cascades}

    def restore_state(self, state: Dict[str, object]) -> int:
        """Rebuild records from an `export_state` payload (additive onto
        whatever the store already holds; fresh stores restore exactly)."""
        n = 0
        for key, d in (state.get("predicates") or {}).items():
            rec = self.entry(tuple(key))
            with self._lock:
                for f in self._PRED_FIELDS:
                    setattr(rec, f, d.get(f, 0))
                rec.recent = deque((tuple(t) for t in d.get("recent", [])),
                                   maxlen=_RECENT_WINDOW)
            n += 1
        for key, d in (state.get("cascades") or {}).items():
            rec = self.cascade_entry(tuple(key))
            with self._lock:
                for f in self._CASC_FIELDS:
                    setattr(rec, f, d.get(f, 0))
                rec.reservoir = {int(h): tuple(v)
                                 for h, v in d.get("reservoir", {}).items()}
                rec._heap = [-h for h in rec.reservoir]
                heapq.heapify(rec._heap)
                rec.hist_pos = np.asarray(
                    d.get("hist_pos", [0] * _CASCADE_BINS), np.int64)
                rec.hist_neg = np.asarray(
                    d.get("hist_neg", [0] * _CASCADE_BINS), np.int64)
            n += 1
        return n

    # -- writers ---------------------------------------------------------
    def record_call(self, key, in_tokens: int, out_tokens: int,
                    latency_s: float, *, pilot: bool = False) -> None:
        rec = self.entry(key)
        with self._lock:
            rec.calls += 1
            rec.in_tokens += int(in_tokens)
            rec.out_tokens += int(out_tokens)
            rec.latency_s += float(latency_s)
            if pilot:
                rec.pilot_calls += 1

    def record_predicate(self, key, rows_in: int, rows_passed: int, *,
                         pilot: bool = False) -> None:
        rec = self.entry(key)
        with self._lock:
            rec.rows_in += int(rows_in)
            rec.rows_passed += int(rows_passed)
            rec.recent.append((int(rows_in), int(rows_passed)))
            if pilot:
                rec.pilot_rows += int(rows_in)

    def record_retry(self, key) -> None:
        rec = self.entry(key)
        with self._lock:
            rec.retries += 1

    def record_fallback(self, key) -> None:
        rec = self.entry(key)
        with self._lock:
            rec.fallbacks += 1

    # -- cascade writers ---------------------------------------------------
    def record_cascade_scores(self, key, confs: Sequence[float],
                              verdicts: Sequence[bool]) -> None:
        """Fold one proxy-scored batch into the per-verdict confidence
        sketches (every routed row, not just escalated ones)."""
        rec = self.cascade_entry(key)
        with self._lock:
            for c, pos in zip(confs, verdicts):
                b = min(_CASCADE_BINS - 1,
                        max(0, int(float(c) * _CASCADE_BINS)))
                (rec.hist_pos if pos else rec.hist_neg)[b] += 1

    def record_cascade_agreement(self, key, row_hash: int, conf: float,
                                 verdict: bool, agree: bool, *,
                                 audited: bool = False) -> None:
        """One held-out observation: the proxy said `verdict` with `conf`
        and the expensive model (dis)agreed.  Deterministic capacity
        eviction keeps the `_CASCADE_RESERVOIR` smallest row hashes, so
        the reservoir converges to the same set regardless of the order
        concurrent workers record in."""
        rec = self.cascade_entry(key)
        h = int(row_hash)
        val = (float(conf), bool(verdict), bool(agree))
        with self._lock:
            if audited:
                rec.audited += 1
                rec.audit_agree += int(bool(agree))
            if h in rec.reservoir:
                rec.reservoir[h] = val          # update in place, heap keeps h
            elif len(rec.reservoir) < _CASCADE_RESERVOIR:
                rec.reservoir[h] = val
                heapq.heappush(rec._heap, -h)
            elif h < -rec._heap[0]:
                # smaller than the current max hash: the max is the record
                # the old sort-everything pass would have dropped
                evicted = -heapq.heapreplace(rec._heap, -h)
                del rec.reservoir[evicted]
                rec.reservoir[h] = val
            # else: h exceeds every retained hash — dropped on arrival,
            # exactly as insert-then-trim discarded it

    def record_cascade_batch(self, key, rows: int, escalated: int,
                             proxy_calls: int, expensive_calls: int, *,
                             degraded: int = 0) -> None:
        rec = self.cascade_entry(key)
        with self._lock:
            rec.routed_rows += int(rows)
            rec.escalated_rows += int(escalated)
            rec.proxy_calls += int(proxy_calls)
            rec.expensive_calls += int(expensive_calls)
            rec.degraded_batches += int(degraded)

    # -- cascade calibration ----------------------------------------------
    def calibrate_cascade(self, key, target_precision: float, *,
                          min_records: int = 8) -> CascadeCalibration:
        """Derive the acceptance-threshold pair meeting `target_precision`
        from the held-out reservoir.  Per verdict class, records are sorted
        by descending confidence (hash-tie-broken for a total order) and
        the threshold is the confidence of the LARGEST prefix whose
        agreement rate still meets the target — maximum coverage at the
        contracted precision.  A class with no qualifying prefix keeps
        tau=2.0 (always escalate).  The implied escalation rate comes from
        the score sketches (reservoir fallback), the empirical precision
        from audit records when present, else the accepted reservoir
        slice."""
        target = min(max(float(target_precision), 0.0), 1.0)
        rec = self.cascade_get(key)
        cal = CascadeCalibration(target=target)
        if rec is None:
            return cal
        with self._lock:
            records = [(c, pos, agree, h)
                       for h, (c, pos, agree) in rec.reservoir.items()]
            hist_pos = rec.hist_pos.copy()
            hist_neg = rec.hist_neg.copy()
            audited, audit_agree = rec.audited, rec.audit_agree
        cal.n_records = len(records)
        if cal.n_records < max(1, int(min_records)):
            return cal                 # cold: escalate everything

        def best_tau(cls_records) -> float:
            # cls_records: [(conf, agree, hash)] for one verdict class
            cls_records.sort(key=lambda t: (-t[0], t[2]))
            tau, good = 2.0, 0
            for k, (conf, agree, _) in enumerate(cls_records, start=1):
                good += int(agree)
                # a threshold is only well-defined at a confidence
                # boundary: tau = conf accepts EVERY record of a tie
                # group, so a prefix cutting inside one would promise a
                # precision its own acceptance set does not have
                if k < len(cls_records) and cls_records[k][0] == conf:
                    continue
                if good / k >= target:
                    tau = conf
            return tau

        cal.tau_pos = best_tau([(c, a, h) for c, p, a, h in records if p])
        cal.tau_neg = best_tau([(c, a, h) for c, p, a, h in records
                                if not p])
        if cal.tau_pos > 1.0 and cal.tau_neg > 1.0:
            cal.escalation_rate = 1.0
            cal.status = "unachievable"
            return cal

        # escalation rate a threshold implies: sketch mass whose bin
        # center falls below the class threshold
        centers = (np.arange(_CASCADE_BINS) + 0.5) / _CASCADE_BINS
        total = int(hist_pos.sum() + hist_neg.sum())
        if total > 0:
            esc = (int(hist_pos[centers < cal.tau_pos].sum())
                   + int(hist_neg[centers < cal.tau_neg].sum()))
            cal.escalation_rate = esc / total
        else:
            esc = sum(1 for c, p, a, h in records
                      if c < (cal.tau_pos if p else cal.tau_neg))
            cal.escalation_rate = esc / len(records)

        accepted = [a for c, p, a, h in records
                    if c >= (cal.tau_pos if p else cal.tau_neg)]
        if audited > 0:
            cal.empirical_precision = audit_agree / audited
        elif accepted:
            cal.empirical_precision = sum(accepted) / len(accepted)
        cal.status = "ok"
        if audited >= 16 and (audit_agree / audited) < target:
            cal.status = "violated"    # contract broken on audited rows
        return cal


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CostEstimate:
    selectivity: float
    sel_source: str           # observed | hint | default
    expected_calls: float
    per_call_s: float
    in_tokens: float          # expected total
    out_tokens: float
    makespan_s: float


def expected_stack_cost(n_rows: float,
                        units: Sequence[Tuple[float, float]]) -> float:
    """Expected cost of running a stack of commuting semantic selects in
    the given order: units = [(per_row_cost, selectivity), ...], unit 0
    executed first.  Each unit pays its per-row cost on the rows surviving
    the units before it."""
    total, rows = 0.0, float(n_rows)
    for cost, sel in units:
        total += rows * cost
        rows *= min(max(float(sel), 0.0), 1.0)
    return total


def order_rank(per_row_cost: float, selectivity: float) -> float:
    """Rank metric for ordering commuting selects: ascending
    cost/(1 - selectivity) minimizes `expected_stack_cost` (standard
    exchange argument); at uniform cost it reduces to ascending
    selectivity, which minimizes expected call count."""
    return per_row_cost / max(1e-6, 1.0 - min(max(selectivity, 0.0), 1.0))


class CostModel:
    """Unified cost model over a StatisticsStore.  Observed statistics win;
    static hints (`selectivity_hint`, caller-provided token estimates) are
    the fallback, so a cold store reproduces the old heuristics exactly."""

    #: below this many observed predicate inputs the store is not trusted
    MIN_OBS_ROWS = 1

    def __init__(self, store: Optional[StatisticsStore],
                 options: Optional[Dict[str, object]] = None):
        self.store = store if store is not None else StatisticsStore()
        self.opts = dict(options or {})

    # -- components ------------------------------------------------------
    def selectivity(self, info) -> Tuple[float, str]:
        rec = self.store.get(stats_key(info))
        if rec is not None and rec.rows_in >= self.MIN_OBS_ROWS:
            return float(rec.selectivity), "observed"
        hint = (info.options or {}).get("selectivity_hint")
        if hint is not None:
            return float(hint), "hint"
        return 0.5, "default"

    def per_call(self, info, fallback_in_tokens: Optional[float] = None
                 ) -> Tuple[float, float, float]:
        """(in_tokens, out_tokens, modeled latency) per executor call."""
        rec = self.store.get(stats_key(info))
        if rec is not None and rec.calls > 0:
            return (rec.mean_in_tokens, rec.mean_out_tokens,
                    rec.mean_latency_s)
        in_t = float(fallback_in_tokens) if fallback_in_tokens is not None \
            else 64.0
        out_t = 4.0 * max(1, len(info.outputs))
        return in_t, out_t, default_latency_model(in_t, out_t)

    def _calls_for(self, info, rows: float) -> float:
        bs = 1.0
        if bool(self.opts.get("use_batching", True)):
            bs = float((info.options or {}).get(
                "batch_size", self.opts.get("batch_size", 16)))
        rec = self.store.get(stats_key(info))
        inflate = 1.0 + (rec.retry_rate + rec.fallback_rate
                         if rec is not None and rec.calls else 0.0)
        return math.ceil(max(0.0, rows) / max(1.0, bs)) * inflate

    def _makespan(self, n_calls: float, per_call_s: float) -> float:
        workers = max(1, int(self.opts.get("n_threads", 16)))
        rpm = float(self.opts.get("rate_limit_rpm", 0.0) or 0.0)
        n = int(math.ceil(n_calls))
        if n <= 0:
            return 0.0
        cap = 10_000
        if n <= cap:
            return makespan([per_call_s] * n, workers, rpm)
        # identical latencies → makespan scales linearly past the cap
        return makespan([per_call_s] * cap, workers, rpm) * (n / cap)

    # -- API -------------------------------------------------------------
    def estimate(self, info, est_in_rows: float,
                 fallback_in_tokens: Optional[float] = None) -> CostEstimate:
        sel, src = self.selectivity(info)
        in_t, out_t, lat = self.per_call(info, fallback_in_tokens)
        calls = self._calls_for(info, est_in_rows)
        return CostEstimate(
            selectivity=sel, sel_source=src, expected_calls=calls,
            per_call_s=lat, in_tokens=calls * in_t, out_tokens=calls * out_t,
            makespan_s=self._makespan(calls, lat))

    def queue_makespan(self, key: Optional[Tuple[str, str]], n_calls: int,
                       fallback_per_call_s: Optional[float] = None) -> float:
        """Expected makespan of one InferenceService queue of `n_calls`
        requests under this model: the store's observed mean per-call
        latency for `key` when it has history, else the caller's fallback
        (else the default latency model), reduced through the same greedy
        worker/rpm schedule as `estimate()`.  Drives the service's
        smallest-expected-makespan-first flush prioritization."""
        per = None
        if key is not None:
            rec = self.store.get(key)
            if rec is not None and rec.calls:
                per = rec.mean_latency_s
        if per is None:
            per = (float(fallback_per_call_s)
                   if fallback_per_call_s is not None
                   else default_latency_model(64.0, 8.0))
        return self._makespan(float(n_calls), per)

    def rank(self, info, fallback_in_tokens: Optional[float] = None
             ) -> Tuple[float, float, float]:
        """Sort key for commuting semantic selects (ascending = run
        first).  Primary: cost/(1-selectivity); ties broken by the static
        token estimate then selectivity.  On a cold store with no
        selectivity hints every unit gets sel=0.5, so the primary key is
        monotone in the token estimate and the ordering matches the old
        size heuristic; an explicit selectivity_hint now (correctly)
        participates in the cost rank instead of only breaking ties."""
        sel, _ = self.selectivity(info)
        _, _, lat = self.per_call(info, fallback_in_tokens)
        fb = float(fallback_in_tokens) if fallback_in_tokens is not None \
            else 64.0
        return (order_rank(lat, sel), fb, sel)


# ---------------------------------------------------------------------------
class PilotSampler:
    """Optimize-time selectivity calibration for predicates with no
    history.  Runs a deterministic reservoir sample of the predicate's
    input through the normal PredictOperator path (same InferenceService,
    same PromptCache — sampled answers are re-used by the real execution),
    then records the observed pass rate in the store."""

    def __init__(self, predict_factory, store: StatisticsStore, *,
                 sample_rows: int = 16, min_table_rows: Optional[int] = None):
        self.predict_factory = predict_factory
        self.store = store
        self.sample_rows = max(1, int(sample_rows))
        # a pilot over most of the input defeats its purpose: only sample
        # when the table is several times larger than the sample
        self.min_table_rows = (4 * self.sample_rows if min_table_rows is None
                               else int(min_table_rows))
        self.calls = 0
        self.in_tokens = 0
        self.out_tokens = 0
        self.sim_latency_s = 0.0

    def _sample_idx(self, n: int, key) -> np.ndarray:
        h = hashlib.sha256(("pilot:" + repr(key)).encode()).digest()
        rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
        return np.sort(rng.choice(n, size=self.sample_rows, replace=False))

    def wants(self, info) -> bool:
        """True when a pilot could teach us something about `info`: no
        predicate history in the store yet."""
        if self.predict_factory is None:
            return False
        rec = self.store.get(stats_key(info))
        return rec is None or rec.rows_in == 0

    def calibrate(self, predicate, info, base_table) -> bool:
        """Sample `base_table`, run `info`'s predict over the sample,
        evaluate `predicate` on the result and record the pass rate.
        Returns True when a pilot actually ran."""
        if not self.wants(info):
            return False               # history exists — nothing to learn
        key = stats_key(info)
        n = len(base_table)
        if n <= max(self.min_table_rows, self.sample_rows):
            return False               # cannot amortize the pilot cost
        sample = base_table.take(self._sample_idx(n, key))
        op = self.predict_factory(info)
        out = op(sample)
        mask = np.asarray(predicate.evaluate(out), bool)
        self.store.record_predicate(key, len(out), int(mask.sum()),
                                    pilot=True)
        self.store.entry(key).pilot_calls += op.stats.calls
        self.calls += op.stats.calls
        self.in_tokens += op.stats.in_tokens
        self.out_tokens += op.stats.out_tokens
        self.sim_latency_s += op.stats.sim_latency_s
        return True


# ---------------------------------------------------------------------------
def stats_section(plan, store: StatisticsStore,
                  cost_model: CostModel) -> str:
    """EXPLAIN `-- stats --` body: one line per Predict/SemanticJoin node,
    estimated selectivity/cost next to the store's observations."""
    from repro_torch.relational.plan import Predict, SemanticJoin, walk_plan

    def fmt(v, spec="{:.3f}"):
        return spec.format(v) if v is not None else "n/a"

    lines: List[str] = []
    for node in walk_plan(plan):
        if not isinstance(node, (Predict, SemanticJoin)):
            continue
        info = node.info
        key = stats_key(info)
        rows = float(info.options.get(
            "est_cross_rows", info.options.get("est_in_rows", 0.0)) or 0.0)
        est = cost_model.estimate(info, rows)
        # prefer the selectivity the optimizer actually stamped on the plan
        # (it may predate observations added by later queries)
        if "est_selectivity" in info.options:
            est = dataclasses.replace(
                est, selectivity=float(info.options["est_selectivity"]),
                sel_source=str(info.options.get("sel_source",
                                                est.sel_source)))
        rec = store.get(key)
        kind = type(node).__name__
        instr = key[1] if len(key[1]) <= 48 else key[1][:45] + "..."
        obs = "none"
        if rec is not None:
            obs = (f"sel={fmt(rec.selectivity)} calls={rec.calls} "
                   f"mean_lat_s={fmt(rec.mean_latency_s, '{:.2f}')} "
                   f"tokens={fmt(rec.mean_in_tokens, '{:.0f}')}in/"
                   f"{fmt(rec.mean_out_tokens, '{:.0f}')}out "
                   f"retry_rate={rec.retry_rate:.2f} "
                   f"pilot_calls={rec.pilot_calls}")
        lines.append(
            f"{kind}[{info.model_name}] '{instr}'\n"
            f"  est: sel={est.selectivity:.3f} ({est.sel_source}) "
            f"rows={rows:.0f} calls={est.expected_calls:.0f} "
            f"makespan_s={est.makespan_s:.2f}\n"
            f"  obs: {obs}")
    return "\n".join(lines) if lines else "(no semantic operators)"
