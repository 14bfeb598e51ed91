"""Physical operator pipeline (chunked, streaming).

The logical plan (`repro.relational.plan.Node`) is *lowered* into a tree of
physical operators that produce/consume `Table` chunks through an
`open() / next_chunk() / close()` protocol (a `chunks()` generator wrapper
is provided for convenience).  The executor drains the root operator; no
operator other than the declared pipeline breakers (sort, group-by, hash
join build side) materializes its whole input.

Operator inventory:

  ScanOp                    chunk_size slices of a catalog table
  FilterOp / ProjectOp      chunk-at-a-time, vectorized expression eval
  LimitOp                   early exit: stops pulling its child once
                            `n` rows have been emitted
  OrderByOp                 pipeline breaker (stable multi-key sort)
  HashJoinOp                vectorized build+probe via numpy factorization
                            (argsort + searchsorted, no per-row dict loops)
  CrossJoinOp               index-arithmetic windows over |L|x|R|
  GroupByOp                 pipeline breaker; grouping via stable argsort +
                            ufunc.reduceat (no per-row Python loops)
  PredictOp                 one PredictOperator instance fed one chunk at a
                            time (the operator batches/dedups internally);
                            keeps up to `inflight_windows` chunks submitted
                            to the inference service ahead of resolution
  PredictScanOp             table generation (rho^s, LLM-as-scan)
  SemanticSelectStackOp     >=2 reorderable semantic selects executed as
                            one operator: after every chunk the remaining
                            units are re-ranked on the pass rates observed
                            *inside this query*, so drifting data cannot
                            pin the optimizer's stale static order
  SemanticJoinOp            STREAMING block-nested-loop semantic join: the
                            cross product is produced window-by-window
                            (peak intermediate <= window rows, never
                            |L|x|R|), each window fed to one shared predict
                            operator so dedup/caching span all windows

Stats flow: operators that own a PredictOperator report it exactly once to
the `absorber` (the PlanExecutor) when they are closed.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cancel import CancelScope
from repro_torch.relational.plan import (Filter, GroupBy, Join, Limit, Node,
                                   OrderBy, Predict, PredictInfo, Project,
                                   Scan, SemanticJoin)
from repro_torch.relational.table import Table, _coerce, _np_for

#: chunk-size floor applied under a streaming LIMIT: small enough that an
#: early exit wastes at most ~a window of inference, large enough that
#: multi-row marshaling (batch_size rows per call) still fills batches
LIMIT_CHUNK_FLOOR = 64


def empty_table(schema: Dict[str, str]) -> Table:
    return Table.from_rows([], dict(schema))


# ---------------------------------------------------------------------------
# factorization helpers (shared by HashJoinOp and GroupByOp)
# ---------------------------------------------------------------------------
def _needs_object_codes(*arrs: np.ndarray) -> bool:
    for a in arrs:
        if a.dtype == object:
            return True
        # NaN keys must keep the dict semantics of the row-at-a-time engine
        # (NaN never equals NaN), which np.unique(equal_nan=True) would break
        if np.issubdtype(a.dtype, np.floating) and np.isnan(a).any():
            return True
    return False


def _dict_codes(arrs: Sequence[np.ndarray]) -> Tuple[List[np.ndarray], int]:
    mapping: Dict[object, int] = {}
    out = []
    for a in arrs:
        codes = np.empty(len(a), np.int64)
        for i, v in enumerate(a.tolist()):
            codes[i] = mapping.setdefault(v, len(mapping))
        out.append(codes)
    return out, max(1, len(mapping))


def joint_codes(column_sets: Sequence[Sequence[np.ndarray]]
                ) -> List[np.ndarray]:
    """Factorize rows of one or more aligned column lists into shared int64
    codes: rows (across all sets) with equal key tuples get equal codes.
    `column_sets[s][c]` is key column c of input s."""
    n_cols = len(column_sets[0])
    lens = [len(cs[0]) if cs else 0 for cs in column_sets]
    combined = [np.zeros(l, np.int64) for l in lens]
    for c in range(n_cols):
        cols = [cs[c] for cs in column_sets]
        if _needs_object_codes(*cols):
            codes, card = _dict_codes(cols)
        else:
            allv = np.concatenate(cols) if sum(lens) else \
                np.array([], np.int64)
            uniq, inv = np.unique(allv, return_inverse=True)
            codes, off = [], 0
            for l in lens:
                codes.append(inv[off:off + l].astype(np.int64))
                off += l
            card = max(1, len(uniq))
        combined = [cmb * card + cd for cmb, cd in zip(combined, codes)]
        # re-compress so the running product can never overflow int64
        allc = np.concatenate(combined) if sum(lens) else \
            np.array([], np.int64)
        _, inv = np.unique(allc, return_inverse=True)
        out, off = [], 0
        for l in lens:
            out.append(inv[off:off + l].astype(np.int64))
            off += l
        combined = out
    return combined


# ---------------------------------------------------------------------------
class PhysicalOp:
    """Base chunk producer. Subclasses implement `_produce()` (a generator
    of Tables); the base class provides the open/next_chunk/close protocol
    and guarantees at least one (possibly empty) chunk so downstream
    operators always see the output schema."""

    name = "op"
    children: List["PhysicalOp"] = []
    #: per-session CancelScope (None outside front-door streams).  Checked
    #: at EVERY chunk boundary at every level — pipeline breakers drain
    #: their children through next_chunk too, so a cancel lands mid-sort /
    #: mid-build as fast as mid-stream.  The raised QueryCancelled unwinds
    #: the generator stack, running each operator's `finally:` (pipelined
    #: predicts cancel their pending chunks → still-queued service
    #: requests are dropped).
    scope: Optional[CancelScope] = None

    def __init__(self, out_schema: Dict[str, str]):
        self.out_schema = dict(out_schema)
        self._gen = None
        self._emitted = False

    # -- protocol ----------------------------------------------------------
    def open(self) -> None:
        self._gen = self._produce()
        self._emitted = False

    def next_chunk(self) -> Optional[Table]:
        if self.scope is not None:
            self.scope.raise_if_cancelled()
        if self._gen is None:
            self.open()
        chunk = next(self._gen, None)
        if chunk is None:
            if not self._emitted:
                self._emitted = True
                return empty_table(self.out_schema)
            return None
        self._emitted = True
        return chunk

    def close(self) -> None:
        if self._gen is not None:
            self._gen.close()
            self._gen = None

    def chunks(self):
        self.open()
        try:
            while True:
                c = self.next_chunk()
                if c is None:
                    break
                yield c
        finally:
            self.close()

    # -- impl --------------------------------------------------------------
    def _produce(self):
        raise NotImplementedError

    def _drain(self, child: "PhysicalOp") -> Table:
        """Materialize a child (pipeline breakers only)."""
        parts = list(child.chunks())
        out = parts[0]
        for p in parts[1:]:
            out = out.concat(p)
        return out

    def describe(self) -> str:
        return self.name


# ---------------------------------------------------------------------------
class ScanOp(PhysicalOp):
    name = "Scan"

    def __init__(self, table: Table, table_name: str, chunk_size: int,
                 out_schema):
        super().__init__(out_schema)
        self.table = table
        self.table_name = table_name
        self.chunk_size = max(1, int(chunk_size))
        self.children = []

    def _produce(self):
        for s in range(0, len(self.table), self.chunk_size):
            yield self.table.slice(s, min(s + self.chunk_size,
                                          len(self.table)))

    def describe(self):
        return (f"Scan[{self.table_name}] rows={len(self.table)} "
                f"chunk={self.chunk_size}")


class FilterOp(PhysicalOp):
    name = "Filter"

    def __init__(self, child: PhysicalOp, predicate, out_schema,
                 stats_probe=None):
        super().__init__(out_schema)
        self.child = child
        self.predicate = predicate
        # (StatisticsStore, key) when this filter realizes a semantic
        # select: observed pass rates feed the adaptive cost model
        self.stats_probe = stats_probe
        self.children = [child]

    def _produce(self):
        for c in self.child.chunks():
            mask = np.asarray(self.predicate.evaluate(c), bool)
            if self.stats_probe is not None and len(c):
                store, key = self.stats_probe
                store.record_predicate(key, len(c), int(mask.sum()))
            out = c.mask(mask)
            if len(out):
                yield out

    def describe(self):
        return f"Filter {self.predicate!r}"


class ProjectOp(PhysicalOp):
    name = "Project"

    def __init__(self, child: PhysicalOp, exprs, out_schema):
        super().__init__(out_schema)
        self.child = child
        self.exprs = exprs
        self.children = [child]

    def _produce(self):
        for c in self.child.chunks():
            cols, sch = {}, {}
            for name, e in self.exprs:
                cols[name] = e.evaluate(c)
                sch[name] = e.sql_type(c.schema)
            yield Table(cols, sch)

    def describe(self):
        return f"Project {[n for n, _ in self.exprs]}"


class LimitOp(PhysicalOp):
    name = "Limit"

    def __init__(self, child: PhysicalOp, n: int, out_schema):
        super().__init__(out_schema)
        self.child = child
        self.n = n
        self.children = [child]

    def _produce(self):
        remaining = self.n
        self.child.open()
        try:
            while remaining > 0:           # early exit: never over-pull
                c = self.child.next_chunk()
                if c is None:
                    break
                if len(c) > remaining:
                    c = c.slice(0, remaining)
                remaining -= len(c)
                if len(c):
                    yield c
        finally:
            self.child.close()

    def describe(self):
        return f"Limit {self.n} (early-exit)"


class OrderByOp(PhysicalOp):
    name = "OrderBy"

    def __init__(self, child: PhysicalOp, keys, chunk_size: int, out_schema):
        super().__init__(out_schema)
        self.child = child
        self.keys = keys
        self.chunk_size = max(1, int(chunk_size))
        self.children = [child]

    def _produce(self):
        t = self._drain(self.child)
        if len(t) == 0:
            return
        order = np.arange(len(t))
        for e, asc in reversed(self.keys):
            v = e.evaluate(t)[order]
            if v.dtype == object:
                v = np.array([("" if x is None else str(x)) for x in v])
            idx = np.argsort(v, kind="stable")
            if not asc:
                idx = idx[::-1]
            order = order[idx]
        t = t.take(order)
        for s in range(0, len(t), self.chunk_size):
            yield t.slice(s, min(s + self.chunk_size, len(t)))

    def describe(self):
        return f"OrderBy [{len(self.keys)} keys] (blocking sort)"


# ---------------------------------------------------------------------------
def _merge_sides(lt: Table, rt: Table) -> Table:
    cols = dict(lt.cols)
    sch = dict(lt.schema)
    for k, v in rt.cols.items():
        if k in cols:                      # drop duplicate right columns
            continue
        cols[k] = v
        sch[k] = rt.schema[k]
    return Table(cols, sch)


class HashJoinOp(PhysicalOp):
    """Equi-join via numpy factorization: both key sides are mapped into a
    shared code space, the probe is one argsort + two searchsorted calls.
    Output order matches the row-at-a-time reference (left order, matching
    right rows ascending)."""
    name = "HashJoin"

    def __init__(self, left: PhysicalOp, right: PhysicalOp,
                 left_keys, right_keys, extra, chunk_size: int, out_schema):
        super().__init__(out_schema)
        self.left = left
        self.right = right
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.extra = extra
        self.chunk_size = max(1, int(chunk_size))
        self.children = [left, right]

    def _produce(self):
        l = self._drain(self.left)
        r = self._drain(self.right)
        if len(l) == 0 or len(r) == 0:
            return
        lk = [l.column(k) for k in self.left_keys]
        rk = [r.column(k) for k in self.right_keys]
        code_l, code_r = joint_codes([lk, rk])
        order = np.argsort(code_r, kind="stable")
        rs = code_r[order]
        starts = np.searchsorted(rs, code_l, "left")
        ends = np.searchsorted(rs, code_l, "right")
        counts = ends - starts
        total = int(counts.sum())
        if total == 0:
            return
        li = np.repeat(np.arange(len(l)), counts)
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
        within = np.arange(total) - np.repeat(offs, counts)
        ri = order[np.repeat(starts, counts) + within]
        for s in range(0, total, self.chunk_size):
            e = min(s + self.chunk_size, total)
            out = _merge_sides(l.take(li[s:e]), r.take(ri[s:e]))
            if self.extra is not None:
                out = out.mask(np.asarray(self.extra.evaluate(out), bool))
            if len(out):
                yield out

    def describe(self):
        return (f"HashJoin keys={list(zip(self.left_keys, self.right_keys))} "
                f"(vectorized build+probe)")


class CrossJoinOp(PhysicalOp):
    name = "CrossJoin"

    def __init__(self, left: PhysicalOp, right: PhysicalOp, extra,
                 chunk_size: int, out_schema):
        super().__init__(out_schema)
        self.left = left
        self.right = right
        self.extra = extra
        self.chunk_size = max(1, int(chunk_size))
        self.children = [left, right]

    def _produce(self):
        l = self._drain(self.left)
        r = self._drain(self.right)
        total = len(l) * len(r)
        for s in range(0, total, self.chunk_size):
            idx = np.arange(s, min(s + self.chunk_size, total))
            out = _merge_sides(l.take(idx // len(r)), r.take(idx % len(r)))
            if self.extra is not None:
                out = out.mask(np.asarray(self.extra.evaluate(out), bool))
            if len(out):
                yield out

    def describe(self):
        return f"CrossJoin window={self.chunk_size}"


# ---------------------------------------------------------------------------
class GroupByOp(PhysicalOp):
    """Pipeline breaker. Groups via stable argsort over factorized key codes
    and aggregates with ufunc.reduceat; groups are emitted in first-
    occurrence order (matching the dict-based reference)."""
    name = "GroupBy"

    def __init__(self, child: PhysicalOp, keys, aggs, llm_agg_infos,
                 predict_factory, absorber, out_schema):
        super().__init__(out_schema)
        self.child = child
        self.keys = keys
        self.aggs = aggs
        self.llm_agg_infos = llm_agg_infos or {}
        self.predict_factory = predict_factory
        self.absorber = absorber
        self.children = [child]

    def _group_layout(self, t: Table):
        """Returns (order, starts, sizes, emit) — rows of group g (in emit
        order) are order[starts[emit[g]] : starts[emit[g]] + sizes[emit[g]]]."""
        n = len(t)
        if not self.keys:
            return (np.arange(n), np.array([0], np.int64),
                    np.array([n], np.int64), np.array([0], np.int64))
        if n == 0:
            z = np.array([], np.int64)
            return z, z, z, z
        cols = [t.column(k) for k in self.keys]
        codes = joint_codes([cols])[0]
        order = np.argsort(codes, kind="stable")
        sc = codes[order]
        starts = np.nonzero(np.r_[True, sc[1:] != sc[:-1]])[0]
        sizes = np.diff(np.r_[starts, n])
        first_pos = order[starts]          # stable → first occurrence
        emit = np.argsort(first_pos, kind="stable")
        return order, starts, sizes, emit

    def _produce(self):
        t = self._drain(self.child)
        order, starts, sizes, emit = self._group_layout(t)
        n_groups = len(emit)

        cols: Dict[str, np.ndarray] = {}
        sch: Dict[str, str] = {}
        if self.keys and n_groups:
            first_pos = order[starts][emit]
            for k in self.keys:
                cols[k] = t.column(k)[first_pos]
                sch[k] = t.schema[k]
        else:
            for k in self.keys:
                cols[k] = np.array([], dtype=_np_for(t.schema[k]))
                sch[k] = t.schema[k]

        for name, fn, arg in self.aggs:
            typ = "INTEGER" if fn == "count" else (
                "VARCHAR" if fn == "llm_agg" else "DOUBLE")
            if fn == "llm_agg":
                cols[name] = _coerce(self._llm_agg(name, t, order, starts,
                                                   sizes, emit), typ)
            elif fn == "count":
                cols[name] = _coerce([int(x) for x in sizes[emit]], typ)
            else:
                cols[name] = _coerce(self._numeric_agg(fn, arg, t, order,
                                                       starts, sizes, emit),
                                     typ)
            sch[name] = typ
        yield Table(cols, sch)

    def _numeric_agg(self, fn, arg, t, order, starts, sizes, emit):
        n_groups = len(emit)
        if n_groups == 0:
            return []
        v = np.asarray(arg.evaluate(t) if arg is not None
                       else np.ones(len(t)), np.float64)
        vs = v[order]
        if len(vs) == 0:                   # single keyless group, no rows
            return [0.0 if fn == "sum" else float("nan")] * n_groups
        nanm = np.isnan(vs)
        nn = np.add.reduceat(np.where(nanm, 0.0, 1.0), starts)
        if fn in ("sum", "avg"):
            s = np.add.reduceat(np.where(nanm, 0.0, vs), starts)
            with np.errstate(invalid="ignore", divide="ignore"):
                res = s if fn == "sum" else s / nn
        elif fn == "min":
            res = np.minimum.reduceat(np.where(nanm, np.inf, vs), starts)
            res = np.where(nn == 0, np.nan, res)
        else:                              # max
            res = np.maximum.reduceat(np.where(nanm, -np.inf, vs), starts)
            res = np.where(nn == 0, np.nan, res)
        return [float(x) for x in res[emit]]

    def _llm_agg(self, name, t, order, starts, sizes, emit):
        info = self.llm_agg_infos[name]
        op = self.predict_factory(info)
        group_rows = []
        for g in emit:
            idx = order[starts[g]:starts[g] + sizes[g]]
            group_rows.append([{c: t.row(int(i))[c] for c in info.inputs}
                               for i in idx])
        out = op.aggregate(group_rows)
        if self.absorber is not None:
            self.absorber._absorb(op)
        return out

    def describe(self):
        fns = [fn for _, fn, _ in self.aggs]
        return (f"GroupBy keys={self.keys} aggs={fns} "
                f"(vectorized argsort+reduceat)")


# ---------------------------------------------------------------------------
def _inflight_windows(op) -> int:
    return max(1, int(op.opts.get("inflight_windows", 1)))


def _cascade_note(info: PredictInfo) -> str:
    """Physical-plan annotation for a cascaded predict: the route the
    optimizer chose and the proxy it scores with."""
    route = info.options.get("cascade_route")
    if not route:
        return ""
    proxy = info.options.get("cascade_proxy", "?")
    return f" cascade={route}(proxy={proxy})"


class PredictOp(PhysicalOp):
    """Scalar/table inference: one shared PredictOperator consumes upstream
    chunks as they arrive, so batching/dedup/prompt-cache state spans the
    whole input stream.

    With `inflight_windows` > 1 the op keeps that many chunks *submitted*
    to the inference service before resolving the oldest, so chunk N+1's
    requests dispatch in the same service batch as chunk N's and overlap
    its downstream processing.  The default of 1 is the synchronous
    degenerate case (submit, resolve, emit)."""
    name = "Predict"

    def __init__(self, child: PhysicalOp, info: PredictInfo, predict_factory,
                 absorber, out_schema):
        super().__init__(out_schema)
        self.child = child
        self.info = info
        self.predict_factory = predict_factory
        self.absorber = absorber
        self.children = [child]

    def _produce(self):
        op = self.predict_factory(self.info)
        inflight = _inflight_windows(op)
        pending = []
        try:
            for c in self.child.chunks():
                pending.append(op.submit(c))
                # speculative background dispatch of hot queues (any
                # backend's): inference overlaps pulling the next chunk
                # instead of waiting for the first resolve
                op.kick()
                while len(pending) >= inflight:
                    yield op.resolve(pending.pop(0))
            while pending:
                yield op.resolve(pending.pop(0))
        finally:
            for pc in pending:             # closed early (e.g. Limit)
                op.cancel(pc)
            if self.absorber is not None:
                self.absorber._absorb(op)

    def describe(self):
        est = self.info.options.get("est_in_rows")
        e = f" est_in={est:.0f}" if est is not None else ""
        e += _cascade_note(self.info)
        return f"Predict[{self.info.model_name}] out={self.info.out_cols}{e}"


#: chunks of per-unit (rows_in, rows_passed) records the stack operator
#: ranks from — a recency window, not lifetime sums, so a selectivity that
#: DRIFTS mid-stream overturns the stale order within a few chunks
#: (mirrors PredicateStats.recent in the shared store)
_REOPT_WINDOW = 4


class _StackUnit:
    """One semantic-select unit inside a SemanticSelectStackOp."""

    __slots__ = ("info", "predicate", "key", "cost", "init_sel", "recent")

    def __init__(self, info: PredictInfo, predicate, key):
        self.info = info
        self.predicate = predicate
        self.key = key                  # stats-store key (None = no store)
        self.cost = float(info.options.get("reopt_cost", 1.0))
        self.init_sel = float(info.options.get("reopt_sel", 0.5))
        self.recent: List[Tuple[int, int]] = []   # (rows_in, rows_passed)

    def label(self) -> str:
        return f"{self.info.model_name}:{self.info.out_cols[0]}"

    def observe(self, rows_in: int, rows_passed: int) -> None:
        self.recent.append((rows_in, rows_passed))
        if len(self.recent) > _REOPT_WINDOW:
            del self.recent[0]

    def observed_sel(self) -> float:
        rin = sum(r for r, _ in self.recent)
        if rin > 0:
            return sum(p for _, p in self.recent) / rin
        return self.init_sel


class SemanticSelectStackOp(PhysicalOp):
    """Mid-query re-optimization of a commuting semantic-select stack.

    The optimizer stamps stacks whose legality it has proven (every unit's
    predicate depends only on its own predict outputs plus base columns)
    with `reopt` markers; lowering collapses such a stack into this single
    operator.  Each input chunk flows through the units in the CURRENT
    order; after the chunk, the order is re-ranked by cost/(1 - sel) using
    the pass rates observed over the last `_REOPT_WINDOW` chunks (falling
    back to the planner's estimate for units with no local observations
    yet) — windowed, not cumulative, so a drift mid-stream overturns the
    stale order within a few chunks.  Only local observations feed the
    ranking — shared-store reads mid-query would make results depend on
    concurrent queries.

    Reordering commutes (conjunctive selects over the same base rows) and
    output columns are re-projected to the declared schema, so emitted
    rows are byte-identical to any fixed order.  Units run synchronously
    per chunk: a unit's pass mask must resolve before the next unit sees
    its survivors, and the chunk's observations feed the next re-rank."""
    name = "SemanticSelectStack"

    def __init__(self, child: PhysicalOp, units: List[_StackUnit],
                 predict_factory, absorber, stats_store, out_schema):
        super().__init__(out_schema)
        self.child = child
        self.units = units              # execution order: innermost first
        self.predict_factory = predict_factory
        self.absorber = absorber
        self.stats_store = stats_store
        self.children = [child]
        self.reranks = 0
        self.rerank_log: List[str] = []

    def _rank_order(self) -> List[int]:
        from repro_torch.core.stats import order_rank
        return sorted(
            range(len(self.units)),
            key=lambda i: (order_rank(self.units[i].cost,
                                      self.units[i].observed_sel()), i))

    def _produce(self):
        ops = [self.predict_factory(u.info) for u in self.units]
        order = list(range(len(self.units)))
        chunk_no = 0
        try:
            for c in self.child.chunks():
                chunk_no += 1
                cur = c
                for i in order:
                    if len(cur) == 0:
                        break
                    u, op = self.units[i], ops[i]
                    out = op.resolve(op.submit(cur))
                    mask = np.asarray(u.predicate.evaluate(out), bool)
                    passed = int(mask.sum())
                    if self.stats_store is not None and u.key is not None \
                            and len(out):
                        self.stats_store.record_predicate(
                            u.key, len(out), passed)
                    if len(out):
                        u.observe(len(out), passed)
                    cur = out.mask(mask)
                if len(cur):
                    # later units append their columns in execution order;
                    # re-project to the declared schema so emitted rows are
                    # identical no matter how the stack was ranked
                    yield cur.select(list(self.out_schema))
                new_order = self._rank_order()
                if new_order != order:
                    self.reranks += 1
                    sels = ", ".join(
                        f"{self.units[i].label()}="
                        f"{self.units[i].observed_sel():.3f}"
                        for i in new_order)
                    self.rerank_log.append(
                        f"chunk {chunk_no}: re-ranked to "
                        f"[{' -> '.join(self.units[i].label() for i in new_order)}]"
                        f" (observed {sels})")
                    order = new_order
        finally:
            if self.absorber is not None:
                for op in ops:
                    self.absorber._absorb(op)
                note = getattr(self.absorber, "_note_reranks", None)
                if note is not None:
                    note(self.reranks, list(self.rerank_log))

    def describe(self):
        labels = ", ".join(u.label() for u in self.units)
        return (f"SemanticSelectStack[{labels}] "
                f"(chunk-level re-rank on observed selectivity)")


class PredictScanOp(PhysicalOp):
    """Table generation (rho^s): the model IS the scan."""
    name = "PredictScan"

    def __init__(self, info: PredictInfo, predict_factory, absorber,
                 out_schema):
        super().__init__(out_schema)
        self.info = info
        self.predict_factory = predict_factory
        self.absorber = absorber
        self.children = []

    def _produce(self):
        op = self.predict_factory(self.info)
        try:
            yield op.scan()
        finally:
            if self.absorber is not None:
                self.absorber._absorb(op)

    def describe(self):
        return f"PredictScan[{self.info.model_name}] out={self.info.out_cols}"


class SemanticJoinOp(PhysicalOp):
    """Streaming block-nested-loop semantic join (R x S -> predicate).

    The inputs are drained (O(|L| + |R|)), but the cross product never
    exists: windows of at most `window` cross rows are constructed by index
    arithmetic, pushed through the shared predict operator, filtered on the
    boolean output, and emitted. Peak intermediate size is `window`, not
    |L| x |R|."""
    name = "SemanticJoin"

    def __init__(self, left: PhysicalOp, right: PhysicalOp,
                 info: PredictInfo, predict_factory, absorber,
                 window: int, out_schema, stats_probe=None):
        super().__init__(out_schema)
        self.left = left
        self.right = right
        self.info = info
        self.predict_factory = predict_factory
        self.absorber = absorber
        self.window = max(1, int(window))
        self.stats_probe = stats_probe
        self.children = [left, right]

    def _produce(self):
        l = self._drain(self.left)
        r = self._drain(self.right)
        total = len(l) * len(r)
        if total == 0:
            return
        op = self.predict_factory(self.info)
        inflight = _inflight_windows(op)
        drop = set(self.info.out_cols)

        def emit(pc):
            out = op.resolve(pc)
            flag = out.column(self.info.out_cols[0])
            kept = out.mask(np.array([bool(x) for x in flag]))
            if self.stats_probe is not None and len(out):
                store, key = self.stats_probe
                store.record_predicate(key, len(out), len(kept))
            # semantic-join output schema = input schemas only (§3.3)
            return kept.select([c for c in kept.column_names
                                if c not in drop])

        pending = []
        try:
            # window N+1's inference is submitted (and batch-dispatched)
            # while window N's survivors flow downstream
            for s in range(0, total, self.window):
                idx = np.arange(s, min(s + self.window, total))
                chunk = _merge_sides(l.take(idx // len(r)),
                                     r.take(idx % len(r)))
                pending.append(op.submit(chunk))
                op.kick()              # overlap dispatch with window build
                while len(pending) >= inflight:
                    kept = emit(pending.pop(0))
                    if len(kept):
                        yield kept
            while pending:
                kept = emit(pending.pop(0))
                if len(kept):
                    yield kept
        finally:
            for pc in pending:             # closed early (e.g. Limit)
                op.cancel(pc)
            if self.absorber is not None:
                self.absorber._absorb(op)

    def describe(self):
        est = self.info.options.get("est_cross_rows")
        e = f" est_cross={est:.0f}" if est is not None else ""
        e += _cascade_note(self.info)
        return (f"StreamingSemanticJoin[{self.info.model_name}] "
                f"window={self.window}{e}")


# ---------------------------------------------------------------------------
# lowering: logical Node -> PhysicalOp tree
# ---------------------------------------------------------------------------
def lower(node: Node, cat, predict_factory: Callable, chunk_size: int,
          absorber=None, stats_store=None,
          cancel_scope: Optional[CancelScope] = None) -> PhysicalOp:
    """Lowering pass. `absorber` (usually the PlanExecutor) receives every
    PredictOperator's stats exactly once, when its owning op closes.
    Chunk/window sizes are capped by the optimizer's cardinality
    annotations (est_* in PredictInfo.options) where available.  When a
    `stats_store` is given, semantic-select filters and semantic joins get
    probes that record observed predicate selectivity into it.

    Early-exit Limit: a Limit caps the chunk/window size of its STREAMING
    subtree (Scan chunks, SemanticJoin windows) to
    `min(chunk_size, max(LIMIT_CHUNK_FLOOR, n))`, so the pipeline under a
    `LIMIT n` produces (and the predict operators dispatch) work in
    limit-sized windows instead of full 2048-row chunks — once the limit
    is satisfied the close() unwinds and the still-queued windows are
    cancelled before any flush dispatches them.  The cap stops at
    pipeline breakers (sort/group-by/join build sides drain their input
    regardless, so fragmenting their children would only shrink dispatch
    batches without saving a call).

    `cancel_scope` (front-door sessions) is stamped on every operator so
    a cancel is observed at the next chunk boundary anywhere in the
    tree."""
    from repro_torch.core.stats import stats_key
    from repro_torch.relational.expr import find_predicts

    def _semantic_probe(n: Filter):
        """(store, key) when this Filter realizes the semantic select of
        the Predict directly below it."""
        if stats_store is None or not isinstance(n.child, Predict):
            return None
        cols = set()
        for e in [n.predicate]:
            cols |= set(e.columns())
            cols |= {p.resolved_col for p in find_predicts(e)
                     if p.resolved_col}
        if cols & set(n.child.info.out_cols):
            return (stats_store, stats_key(n.child.info))
        return None

    def _reopt_stack(n: Filter):
        """([(Filter, Predict), ...] outermost-first, base) when `n` heads
        a stack of >=2 semantic-select units the optimizer stamped as
        reorderable (`reopt` marker); None otherwise."""
        units = []
        cur: Node = n
        while (isinstance(cur, Filter) and isinstance(cur.child, Predict)
               and cur.child.child is not None
               and bool(cur.child.info.options.get("reopt"))):
            units.append((cur, cur.child))
            cur = cur.child.child
        if len(units) < 2:
            return None
        return units, cur

    def _eff_chunk(cap: Optional[int]) -> int:
        if cap is None:
            return chunk_size
        return max(1, min(chunk_size, max(LIMIT_CHUNK_FLOOR, cap)))

    def rec(n: Node, cap: Optional[int] = None) -> PhysicalOp:
        op = build(n, cap)
        op.scope = cancel_scope
        return op

    def build(n: Node, cap: Optional[int]) -> PhysicalOp:
        sch = n.schema(cat)
        if isinstance(n, Scan):
            return ScanOp(cat.table(n.table), n.table, _eff_chunk(cap), sch)
        if isinstance(n, Filter):
            stack = _reopt_stack(n)
            if stack is not None:
                units, base = stack
                return SemanticSelectStackOp(
                    rec(base, cap),
                    [_StackUnit(p.info, f.predicate, stats_key(p.info))
                     for f, p in reversed(units)],   # innermost runs first
                    predict_factory, absorber, stats_store, sch)
            return FilterOp(rec(n.child, cap), n.predicate, sch,
                            stats_probe=_semantic_probe(n))
        if isinstance(n, Project):
            return ProjectOp(rec(n.child, cap), n.exprs, sch)
        if isinstance(n, Join):
            if n.kind == "cross" or not n.left_keys:
                return CrossJoinOp(rec(n.left), rec(n.right), n.extra,
                                   chunk_size, sch)
            return HashJoinOp(rec(n.left), rec(n.right), n.left_keys,
                              n.right_keys, n.extra, chunk_size, sch)
        if isinstance(n, GroupBy):
            return GroupByOp(rec(n.child), n.keys, n.aggs,
                             getattr(n, "llm_agg_infos", {}),
                             predict_factory, absorber, sch)
        if isinstance(n, OrderBy):
            return OrderByOp(rec(n.child), n.keys, chunk_size, sch)
        if isinstance(n, Limit):
            tighter = n.n if cap is None else min(cap, n.n)
            return LimitOp(rec(n.child, tighter), n.n, sch)
        if isinstance(n, Predict):
            if n.child is None:
                return PredictScanOp(n.info, predict_factory, absorber, sch)
            return PredictOp(rec(n.child, cap), n.info, predict_factory,
                             absorber, sch)
        if isinstance(n, SemanticJoin):
            window = _eff_chunk(cap)
            est = n.info.options.get("est_cross_rows")
            if est is not None and np.isfinite(est):
                # never fragment below a useful floor; only shrink the
                # window when the estimate says the cross product is small
                window = min(window, max(256, int(math.ceil(est))))
            probe = (stats_store, stats_key(n.info)) \
                if stats_store is not None else None
            return SemanticJoinOp(rec(n.left), rec(n.right), n.info,
                                  predict_factory, absorber, window, sch,
                                  stats_probe=probe)
        raise TypeError(f"cannot lower {type(n).__name__}")
    return rec(node)


def physical_repr(op: PhysicalOp, indent: int = 0) -> str:
    lines = ["  " * indent + op.describe()]
    for c in op.children:
        lines.append(physical_repr(c, indent + 1))
    return "\n".join(lines)
