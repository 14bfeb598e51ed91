"""Semantic query optimizer (paper §6.4–§6.6 + §7.10 guidance).

Rules (each individually switchable for the ablation benchmarks):

  pullup      (§6.4) — predict pull-up, implemented as its dual: cheap
                (zero-cost) predicates are pushed BELOW Predict nodes, so
                expensive inference runs after traditional filtering. The
                engine's guardrail "inference is not zero-cost" is
                structural: no rule ever moves a Predict downward.
  join_order  (§6.5) — semantic select vs join ordering: a semantic select
                above a join is pushed to its input side only when the
                side's distinct input count is LOWER than the deduplicated
                distinct count seen above the join (cost-aware, using real
                distinct-value statistics collected from the cheap
                relational prefix of the plan).
  merge       (§6.6) — adjacent Predict nodes with the same model over the
                same child are fused into one multi-output call.
  order       (§7.10) — stacks of semantic selects are ordered by input
                size, then selectivity estimate, then quality hint.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.stats import CostModel, PilotSampler, StatisticsStore
from repro_torch.relational.catalog import Catalog
from repro_torch.relational.expr import (BinOp, Col, Expr, PredictExpr,
                                   PromptTemplate, find_predicts)
from repro_torch.relational.plan import (Filter, GroupBy, Join, Limit, Node,
                                   OrderBy, Predict, PredictInfo, Project,
                                   Scan, SemanticJoin)

DEFAULT_FLAGS = {
    "enable_pullup": True,
    "enable_join_order": True,
    "enable_merge": True,
    "enable_select_order": True,
    "enable_cascade": True,
    "enable_rewrites": True,    # learned rewrite-pattern engine
    "enable_reopt": True,       # mid-query re-ranking of select stacks
}


def _is_cheap(e: Expr) -> bool:
    return not find_predicts(e)


def _split_and(e: Expr) -> List[Expr]:
    if isinstance(e, BinOp) and e.op == "AND":
        return _split_and(e.left) + _split_and(e.right)
    return [e]


def _and_all(es: List[Expr]) -> Optional[Expr]:
    out = None
    for e in es:
        out = e if out is None else BinOp("AND", out, e)
    return out


def _cols_of(e: Expr) -> set:
    return set(e.columns()) | {
        p.resolved_col for p in find_predicts(e) if p.resolved_col}


class Optimizer:
    def __init__(self, catalog: Catalog, flags: Dict[str, bool] = None, *,
                 stats: Optional[StatisticsStore] = None,
                 cost_model: Optional[CostModel] = None,
                 pilot: Optional[PilotSampler] = None):
        self.cat = catalog
        self.session = dict(flags or {})
        self.flags = dict(DEFAULT_FLAGS)
        if flags:
            self.flags.update({k: v for k, v in flags.items()
                               if k in DEFAULT_FLAGS})
        self.stats = stats if stats is not None else StatisticsStore()
        self.cost = cost_model if cost_model is not None else \
            CostModel(self.stats, self.session)
        self.pilot = pilot
        self._filter_used = set()
        self.rewrite_events = []    # RewriteEvents from the last optimize()

    # ------------------------------------------------------------------
    def optimize(self, plan: Node) -> Node:
        self.rewrite_events = []
        plan = self._split_filters(plan)
        # outputs referenced by Filters = selective predicts.  Computed for
        # EVERY rule pass (merge uses it to avoid fusing two highly
        # selective selects, §6.6 caveat) — not only when merge is enabled.
        self._filter_used = set()
        for x in _walk(plan):
            if isinstance(x, Filter):
                self._filter_used |= _cols_of(x.predicate)
        if self.flags["enable_merge"]:
            plan = self._merge_predicts(plan)
        if self.flags["enable_pullup"]:
            for _ in range(8):                    # to fixpoint (bounded)
                new = self._pushdown_cheap(plan)
                if new is plan:
                    break
                plan = new
        if self.flags["enable_rewrites"]:
            # learned rewrite patterns (subsumption, duplicate-predict
            # consolidation, select-vs-join placement) run after pushdown
            # has formed the interleaved select units; every application
            # passes the engine's validation gate and is recorded for
            # EXPLAIN's `-- rewrites --` section
            from repro_torch.core.rewrite import RewriteEngine
            eng = RewriteEngine(self.cat, self.cost, ctx=self)
            plan = eng.rewrite(plan)
            self.rewrite_events = eng.events
        if self.flags["enable_join_order"]:
            plan = self._semantic_select_vs_join(plan)
        if self.flags["enable_select_order"]:
            plan = self._order_semantic_selects(plan)
        plan = self._annotate_selectivities(plan)
        plan = self._annotate_cardinalities(plan)
        if self.flags["enable_cascade"]:
            plan = self._choose_cascade_routes(plan)
        return plan

    # -- helpers --------------------------------------------------------
    def _map_children(self, n: Node, fn) -> Node:
        if isinstance(n, Filter):
            return Filter(fn(n.child), n.predicate, n.selectivity)
        if isinstance(n, Project):
            return Project(fn(n.child), n.exprs)
        if isinstance(n, Join):
            return Join(fn(n.left), fn(n.right), n.kind, n.left_keys,
                        n.right_keys, n.extra)
        if isinstance(n, GroupBy):
            g = GroupBy(fn(n.child), n.keys, n.aggs)
            g.llm_agg_infos = getattr(n, "llm_agg_infos", {})
            return g
        if isinstance(n, OrderBy):
            return OrderBy(fn(n.child), n.keys)
        if isinstance(n, Limit):
            return Limit(fn(n.child), n.n)
        if isinstance(n, Predict):
            return Predict(fn(n.child) if n.child else None, n.info)
        if isinstance(n, SemanticJoin):
            return SemanticJoin(fn(n.left), fn(n.right), n.info)
        return n

    # -- rule: split conjunctive filters ---------------------------------
    def _split_filters(self, n: Node) -> Node:
        n = self._map_children(n, self._split_filters)
        if isinstance(n, Filter):
            parts = _split_and(n.predicate)
            if len(parts) > 1:
                child = n.child
                # cheap parts innermost so they can keep sinking
                for p in sorted(parts, key=lambda e: 0 if _is_cheap(e) else 1,
                                reverse=True):
                    child = Filter(child, p)
                return child
        return n

    # -- rule: cheap predicate pushdown (= predict pull-up, §6.4) ---------
    def _pushdown_cheap(self, n: Node) -> Node:
        n2 = self._map_children(n, self._pushdown_cheap)
        n = n2
        if not isinstance(n, Filter):
            return n
        cols = _cols_of(n.predicate)
        c = n.child
        # ANY filter (cheap or semantic) sinks below a Predict it doesn't
        # depend on — this both realizes predict pull-up (§6.4) and forms
        # the interleaved Filter(Predict(...)) units that §7.10 reorders
        if isinstance(c, Predict) and c.child is not None and \
                not (cols & set(c.info.out_cols)):
            return self._pushdown_cheap(
                Predict(Filter(c.child, n.predicate), c.info))
        if not _is_cheap(n.predicate):
            return n
        # below the matching side of a Join
        if isinstance(c, Join):
            lsch = set(c.left.schema(self.cat))
            rsch = set(c.right.schema(self.cat))
            if cols <= lsch:
                return Join(Filter(c.left, n.predicate), c.right, c.kind,
                            c.left_keys, c.right_keys, c.extra)
            if cols <= rsch:
                return Join(c.left, Filter(c.right, n.predicate), c.kind,
                            c.left_keys, c.right_keys, c.extra)
        # below a SemanticJoin side
        if isinstance(c, SemanticJoin):
            lsch = set(c.left.schema(self.cat))
            rsch = set(c.right.schema(self.cat))
            if cols <= lsch:
                return SemanticJoin(Filter(c.left, n.predicate), c.right,
                                    c.info)
            if cols <= rsch:
                return SemanticJoin(c.left, Filter(c.right, n.predicate),
                                    c.info)
        # through another (cheap or semantic) Filter: reorder cheap-first
        if isinstance(c, Filter) and not _is_cheap(c.predicate):
            return Filter(Filter(c.child, n.predicate), c.predicate,
                          c.selectivity)
        return n

    # -- rule: predicate merging (§6.6) -----------------------------------
    def _merge_predicts(self, n: Node) -> Node:
        n = self._map_children(n, self._merge_predicts)
        if isinstance(n, Predict) and isinstance(n.child, Predict):
            a, b = n.info, n.child.info
            a_sel = bool(set(a.out_cols) & getattr(self, "_filter_used", set()))
            b_sel = bool(set(b.out_cols) & getattr(self, "_filter_used", set()))
            if (a.model_name == b.model_name and not a.agg and not b.agg
                    and a.prompt is not None and b.prompt is not None
                    and n.child.child is not None
                    and not (a_sel and b_sel)):
                merged_prompt = PromptTemplate(
                    raw=b.prompt.raw + " ; " + a.prompt.raw,
                    instruction=b.prompt.instruction + " AND ALSO: "
                    + a.prompt.instruction,
                    inputs=list(dict.fromkeys(b.prompt.inputs + a.prompt.inputs)),
                    outputs=b.prompt.outputs + a.prompt.outputs)
                info = PredictInfo(
                    model_name=a.model_name, prompt=merged_prompt,
                    inputs=list(dict.fromkeys(b.inputs + a.inputs)),
                    outputs=b.outputs + a.outputs,
                    options={**b.options, **a.options},
                    out_cols_override=b.out_cols + a.out_cols)
                return Predict(n.child.child, info)
        return n

    # -- rule: semantic select vs join ordering (§6.5) ---------------------
    def _cheap_table(self, plan: Node):
        """Execute a subplan containing no inference (cheap relational
        prefix) and return its Table; None when the subplan is not cheap
        or fails."""
        for x in _walk(plan):
            if isinstance(x, (Predict, SemanticJoin)):
                return None
            if isinstance(x, Filter) and not _is_cheap(x.predicate):
                return None
        try:
            from repro_torch.relational.executor import PlanExecutor
            ex = PlanExecutor(self.cat, predict_factory=None)
            return ex.run(plan)
        except Exception:
            return None

    def _distinct_count(self, plan: Node, cols: List[str]) -> Optional[float]:
        """Real distinct-value statistics when the subplan is cheap-only."""
        t = self._cheap_table(plan)
        if t is None:
            return None
        if len(t) == 0:
            return 0.0
        arrs = [t.column(c) for c in cols if c in t.cols]
        if not arrs:
            return None
        vals = set()
        for i in range(len(t)):
            vals.add(tuple(a[i] for a in arrs))
        return float(len(vals))

    def _semantic_select_vs_join(self, n: Node) -> Node:
        n = self._map_children(n, self._semantic_select_vs_join)
        # pattern: Filter_sem(Predict(Join(A, B))) with inputs from one side
        if (isinstance(n, Filter) and not _is_cheap(n.predicate)
                and isinstance(n.child, Predict)
                and n.child.child is not None
                and isinstance(n.child.child, Join)):
            pred_node = n.child
            join = pred_node.child
            inputs = set(pred_node.info.inputs)
            lsch = set(join.left.schema(self.cat))
            rsch = set(join.right.schema(self.cat))
            side = "left" if inputs <= lsch else \
                "right" if inputs <= rsch else None
            if side:
                side_plan = join.left if side == "left" else join.right
                d_side = self._distinct_count(side_plan, list(inputs))
                d_join = self._distinct_count(join, list(inputs))
                if d_side is not None and d_join is not None \
                        and self._placement_cost(pred_node, d_side) \
                        < self._placement_cost(pred_node, d_join):
                    # push: cheaper expected cost below the join (dedup makes
                    # the above-join placement cost d_join distinct calls)
                    sub = Filter(Predict(side_plan, pred_node.info),
                                 n.predicate, n.selectivity)
                    if side == "left":
                        return Join(sub, join.right, join.kind,
                                    join.left_keys, join.right_keys,
                                    join.extra)
                    return Join(join.left, sub, join.kind, join.left_keys,
                                join.right_keys, join.extra)
        return n

    # -- pass: cardinality annotation for lowering -------------------------
    def _annotate_cardinalities(self, n: Node) -> Node:
        """Stamp Predict/SemanticJoin nodes with estimated per-chunk input
        cardinalities (est_in_rows / est_cross_rows in info.options) so the
        physical lowering pass can size chunks/windows. Estimation only —
        never changes plan shape or results."""
        n = self._map_children(n, self._annotate_cardinalities)
        if isinstance(n, Predict):
            try:
                est = n.child.est_rows(self.cat) if n.child else 32.0
            except Exception:
                return n                    # unknown stats → no annotation
            info = dataclasses.replace(
                n.info, options={**n.info.options,
                                 "est_in_rows": float(est)})
            return Predict(n.child, info)
        if isinstance(n, SemanticJoin):
            try:
                est = n.left.est_rows(self.cat) * n.right.est_rows(self.cat)
            except Exception:
                return n
            info = dataclasses.replace(
                n.info, options={**n.info.options,
                                 "est_in_rows": float(est),
                                 "est_cross_rows": float(est)})
            return SemanticJoin(n.left, n.right, info)
        return n

    # -- pass: cascade-vs-direct route choice (PR 7) ------------------------
    def _choose_cascade_routes(self, n: Node) -> Node:
        """For every semantic operator with a configured cascade proxy,
        choose cascade vs direct through the cost model and stamp the
        calibration snapshot (thresholds, escalation rate, contract
        status) on the node's options — the CascadePredictor executes
        exactly the stamped snapshot and EXPLAIN's `-- cascade --` section
        renders it.  Runs after cardinality annotation so est_in_rows is
        available.  Decision rule:

          unachievable/violated  contract cannot be (or was not) met →
                                 route direct, cascade disabled;
          ok                     cascade iff proxy-stage + escalated-band
                                 call cost (expected calls x per-call
                                 latency — the metered resource) beats
                                 the direct route's under the observed
                                 escalation rate.  Total cost, not
                                 makespan: with a large worker pool
                                 direct's few calls all run in parallel,
                                 which would hide the cascade's actual
                                 win (fewer expensive calls);
          cold                   cascade (escalate-everything bootstrap:
                                 full direct cost + proxy scoring, buys
                                 the held-out evidence future queries
                                 calibrate from).
        """
        n = self._map_children(n, self._choose_cascade_routes)
        if not isinstance(n, (Predict, SemanticJoin)):
            return n
        info = n.info
        opts = {**self.session, **(info.options or {})}
        proxy = opts.get("cascade_proxy")
        if not proxy or info.agg or \
                (isinstance(n, Predict) and n.child is None):
            return n
        from repro_torch.core.stats import stats_key
        target = float(opts.get("cascade_target_precision", 0.9))
        cal = self.stats.calibrate_cascade(
            stats_key(info), target,
            min_records=int(opts.get("cascade_min_records", 8)))
        route = "cascade"
        if cal.status in ("unachievable", "violated"):
            route = "direct"
        elif cal.status == "ok":
            rows = float(opts.get("est_cross_rows",
                                  opts.get("est_in_rows", 32.0)) or 32.0)
            direct = self.cost.estimate(info, rows)
            esc = self.cost.estimate(info, rows * cal.escalation_rate)
            pinfo = dataclasses.replace(info, model_name=str(proxy))
            prox = self.cost.estimate(pinfo, rows)

            def call_cost(est):
                return est.expected_calls * est.per_call_s

            if call_cost(prox) + call_cost(esc) >= call_cost(direct):
                route = "direct"
        info = dataclasses.replace(info, options={
            **info.options, "cascade_route": route,
            "cascade_proxy": str(proxy),
            "cascade_target_precision": target,
            "cascade_tau_pos": cal.tau_pos,
            "cascade_tau_neg": cal.tau_neg,
            "cascade_esc_rate": cal.escalation_rate,
            "cascade_status": cal.status})
        if isinstance(n, SemanticJoin):
            return SemanticJoin(n.left, n.right, info)
        return Predict(n.child, info)

    def _placement_cost(self, pred_node: Predict,
                        rows: float) -> Tuple[float, float, float]:
        """Cost of running a semantic select over `rows` distinct inputs,
        via the unified cost model: (expected calls, modeled makespan,
        rows).  Rows break ties so marshaling (which quantizes calls by
        batch_size) never hides a strictly smaller input — fewer distinct
        rows always means fewer prompt tokens."""
        est = self.cost.estimate(pred_node.info, rows,
                                 self._fallback_tokens(pred_node))
        return (est.expected_calls, est.makespan_s, rows)

    # -- rule: semantic select ordering (§7.10) ----------------------------
    def _fallback_tokens(self, p: Predict) -> float:
        """Static per-call input-size estimate (instruction chars + sampled
        column widths) — the cost model's fallback when the statistics
        store has no observations for the predicate."""
        instr = len(p.info.prompt.raw) if p.info.prompt else 64
        sizes = []
        for c in p.info.inputs:
            base = _find_base_column(p.child, c, self.cat)
            if base is not None:
                vals = base[:256]
                sizes.append(float(np.mean([len(str(v)) for v in vals]))
                             if len(vals) else 8.0)
            else:
                sizes.append(16.0)
        return instr + sum(sizes)

    def _order_semantic_selects(self, n: Node) -> Node:
        n = self._map_children(n, self._order_semantic_selects)
        # collect a maximal stack Filter_sem(Predict(Filter_sem(Predict(X))))
        units = []
        cur = n
        while (isinstance(cur, Filter) and not _is_cheap(cur.predicate)
               and isinstance(cur.child, Predict)
               and cur.child.child is not None):
            units.append((cur, cur.child))
            cur = cur.child.child
        if len(units) < 2:
            return n
        # only reorder when each unit's predicate depends solely on its own
        # predict outputs and base columns below the whole stack
        base_schema = set(cur.schema(self.cat))
        for f, p in units:
            need = _cols_of(f.predicate) - set(p.info.out_cols)
            if not need <= base_schema:
                return n
            if not set(p.info.inputs) <= base_schema:
                return n
        if self.pilot is not None:
            # calibrate units with no history on a reservoir sample of the
            # (cheap) stack input before committing to an order; the stack
            # input is only materialized when some unit actually needs it
            need = [(f, p) for f, p in units if self.pilot.wants(p.info)]
            base_t = self._cheap_table(cur) if need else None
            if base_t is not None and len(base_t):
                for f, p in need:
                    self.pilot.calibrate(f.predicate, p.info, base_t)
        ranked = sorted(units, key=lambda fp: self.cost.rank(
            fp[1].info, self._fallback_tokens(fp[1])))
        # the legality conditions above (predicates self-contained, inputs
        # from the base schema) are exactly what mid-query re-ranking needs,
        # so stamp each unit with its modeled per-call cost and the planner's
        # selectivity estimate; lowering turns a stamped stack into one
        # SemanticSelectStackOp that re-ranks on observed chunk pass rates
        reopt = bool(self.flags.get("enable_reopt", True))
        plan = cur
        for f, p in ranked:                 # cheapest wraps first → innermost
            info = p.info
            if reopt:
                sel, _ = self.cost.selectivity(info)
                _, _, lat = self.cost.per_call(
                    info, self._fallback_tokens(p))
                info = dataclasses.replace(info, options={
                    **info.options, "reopt": True,
                    "reopt_cost": float(lat), "reopt_sel": float(sel)})
            plan = Filter(Predict(plan, info), f.predicate, f.selectivity)
        return plan

    # -- pass: stats-informed selectivity annotation -----------------------
    def _annotate_selectivities(self, n: Node) -> Node:
        """Stamp semantic select units with the cost model's selectivity:
        the Filter's planner estimate feeds est_rows propagation (and so
        the est_in_rows/est_cross_rows cardinality annotations below),
        and the Predict carries est_selectivity/sel_source for EXPLAIN.
        Estimation only — never changes plan shape or results."""
        n = self._map_children(n, self._annotate_selectivities)
        if (isinstance(n, Filter) and not _is_cheap(n.predicate)
                and isinstance(n.child, Predict)
                and _cols_of(n.predicate) & set(n.child.info.out_cols)):
            p = n.child
            sel, src = self.cost.selectivity(p.info)
            info = dataclasses.replace(
                p.info, options={**p.info.options, "est_selectivity": sel,
                                 "sel_source": src})
            return Filter(Predict(p.child, info), n.predicate, sel)
        return n


def _walk(n: Node):
    yield n
    for c in n.children:
        yield from _walk(c)


def _find_base_column(plan: Node, col: str, cat) -> Optional[np.ndarray]:
    """Column values from the unique base table carrying `col`.  Under a
    join of tables that share a column name, the owner is ambiguous from
    the logical plan alone — return None (callers fall back to a default
    width) instead of sizing prompts from whichever Scan happens to walk
    first.  A self-join (same table twice) is not ambiguous."""
    owners: Dict[str, np.ndarray] = {}
    for x in _walk(plan):
        if isinstance(x, Scan) and x.table not in owners:
            t = cat.table(x.table)
            if col in t.cols:
                owners[x.table] = t.column(col)
    if len(owners) == 1:
        return next(iter(owners.values()))
    return None
