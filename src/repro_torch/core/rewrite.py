"""Learned rewrite-pattern engine over logical plans.

querytorque-style loop brought in-process (ROADMAP "learned rewrite
engine"): a small registry of rewrite PATTERNS, an AST scanner that
detects where each applies, stats-store-driven benefit estimates through
the shared CostModel, and a validation gate that only lets a pattern fire
when its legality conditions hold on the rewritten plan.

Rules (applied in order, each to fixpoint):

  subsume_implied_select           two semantic selects whose predicts are
                                   signature-identical and whose predicates
                                   satisfy A => B: the weaker (implied)
                                   unit is redundant — drop its Filter and,
                                   when unreferenced elsewhere, its Predict.
  consolidate_duplicate_predicts   a Predict whose (model, prompt, inputs,
                                   outputs, answer-shaping options) signature
                                   duplicates one further down its input
                                   chain is replaced by a passthrough
                                   Project aliasing the earlier outputs —
                                   one inference pass instead of two.
  push_semantic_select_through_join  a semantic select above a join whose
                                   inputs come from one side runs below the
                                   join when the side's distinct input
                                   count beats the deduplicated above-join
                                   count (delegates the distinct-count
                                   machinery to the optimizer context).

Legality rests on referential transparency of signature-identical semantic
expressions — the same assumption the cross-query PromptCache and the
service's in-flight dedup already bake in: same (model, instruction,
answer-shaping options, input row) => same answer.

Every match is recorded as a RewriteEvent (fired / rejected / kept), the
raw material of EXPLAIN's `-- rewrites --` section.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional, Set, Tuple

from repro_torch.relational.expr import (BinOp, Col, Expr, Lit, Not, PredictExpr,
                                   find_predicts)
from repro_torch.relational.plan import (Filter, GroupBy, Join, Limit, Node,
                                   OrderBy, Predict, Project, SemanticJoin,
                                   walk_plan)

__all__ = ["RewriteEvent", "RewriteEngine", "predict_signature",
           "predicate_implies", "rewrites_section"]

#: options that change the *answer* of a semantic call, with their
#: defaults — mirrors the PromptCache namespace in `core.predict`.  Two
#: PredictInfos are duplicates only when these agree (dispatch-shaping
#: options like batch_size deliberately stay out).
_ANSWER_OPTS = (("n_samples", 1), ("temperature", 0.7),
                ("max_tokens", 4096), ("max_str", 24), ("gen_rows", 4))


def predict_signature(info) -> Tuple:
    """Answer-identity signature of a PredictInfo: two nodes with equal
    signatures compute the same values for the same input rows."""
    opts = info.options or {}
    shaping = tuple((k, repr(opts.get(k, d))) for k, d in _ANSWER_OPTS
                    if opts.get(k, d) != d)
    return (info.model_name,
            info.prompt.raw if info.prompt else None,
            tuple(info.inputs),
            tuple((n, t) for n, t in info.outputs),
            bool(info.agg), shaping)


@dataclasses.dataclass
class RewriteEvent:
    rule: str
    site: str
    action: str        # fired | rejected | kept
    detail: str        # why / estimated benefit


# ---------------------------------------------------------------------------
# plan / expression helpers
# ---------------------------------------------------------------------------
def _rebuild_replace(n: Node, target: Node, repl: Node) -> Node:
    """Rebuild `n` with the node instance `target` replaced by `repl`."""
    if n is target:
        return repl
    kw = {}
    changed = False
    for f in dataclasses.fields(n):
        v = getattr(n, f.name)
        if isinstance(v, Node):
            nv = _rebuild_replace(v, target, repl)
            changed |= nv is not v
            kw[f.name] = nv
        else:
            kw[f.name] = v
    if not changed:
        return n
    out = type(n)(**kw)
    if isinstance(n, GroupBy):
        out.llm_agg_infos = getattr(n, "llm_agg_infos", {})
    return out


def _expr_cols(e: Expr) -> Set[str]:
    return set(e.columns()) | {p.resolved_col for p in find_predicts(e)
                               if p.resolved_col}


def _referenced_cols(plan: Node, exclude: Tuple[Node, ...] = ()) -> Set[str]:
    """Every column name any node in `plan` consumes (filters, projections,
    sort/group/join keys, predict inputs), skipping the `exclude` node
    instances."""
    skip = {id(x) for x in exclude}
    cols: Set[str] = set()
    for x in walk_plan(plan):
        if id(x) in skip:
            continue
        if isinstance(x, Filter):
            cols |= _expr_cols(x.predicate)
        elif isinstance(x, Project):
            for _, e in x.exprs:
                cols |= _expr_cols(e)
        elif isinstance(x, OrderBy):
            for e, _ in x.keys:
                cols |= _expr_cols(e)
        elif isinstance(x, Join):
            cols |= set(x.left_keys) | set(x.right_keys)
            if x.extra is not None:
                cols |= _expr_cols(x.extra)
        elif isinstance(x, GroupBy):
            cols |= set(x.keys)
            for _, _, arg in x.aggs:
                if arg is not None:
                    cols |= _expr_cols(arg)
            for info in getattr(x, "llm_agg_infos", {}).values():
                cols |= set(info.inputs)
        elif isinstance(x, Predict):
            cols |= set(x.info.inputs)
        elif isinstance(x, SemanticJoin):
            cols |= set(x.info.inputs)
    return cols


# -- predicate normalization + implication ----------------------------------
_FLIP = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "=", "!=": "!="}
_CMP_OPS = {"=", "!=", "<", ">", "<=", ">="}


def _normalize_pred(pred: Expr, out_cols: Set[str]
                    ) -> Optional[Tuple[str, str, object]]:
    """(col, op, literal) for predicates of shape <out col> <cmp> <literal>
    over one of `out_cols`; bare boolean references normalize to (=, True)
    and their negation to (=, False).  None for anything more complex."""
    def as_col(e: Expr) -> Optional[str]:
        if isinstance(e, Col) and e.name in out_cols:
            return e.name
        if isinstance(e, PredictExpr) and e.resolved_col in out_cols:
            return e.resolved_col
        return None

    if isinstance(pred, BinOp) and pred.op in _CMP_OPS:
        c = as_col(pred.left)
        if c is not None and isinstance(pred.right, Lit):
            return (c, pred.op, pred.right.value)
        c = as_col(pred.right)
        if c is not None and isinstance(pred.left, Lit):
            return (c, _FLIP[pred.op], pred.left.value)
        return None
    c = as_col(pred)
    if c is not None:
        return (c, "=", True)
    if isinstance(pred, Not):
        c = as_col(pred.child)
        if c is not None:
            return (c, "=", False)
    return None


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _value_sat(v, op: str, lit) -> bool:
    """Does the single value `v` satisfy `x op lit`?"""
    try:
        if op == "=":
            return bool(v == lit)
        if op == "!=":
            return bool(v != lit)
        if not (_is_num(v) and _is_num(lit)):
            return False
        return {"<": v < lit, ">": v > lit,
                "<=": v <= lit, ">=": v >= lit}[op]
    except TypeError:
        return False


def predicate_implies(op_a: str, va, op_b: str, vb) -> bool:
    """True when `x op_a va` implies `x op_b vb` for every non-NULL x
    (NULL rows fail both sides under the engine's comparison semantics).
    Interval containment on numeric literals; equality on anything."""
    if op_a == "=":
        return _value_sat(va, op_b, vb)
    if op_a == "!=":
        return op_b == "!=" and type(va) is type(vb) and va == vb
    if not (_is_num(va) and _is_num(vb)):
        return False
    strict = op_a in ("<", ">")
    if op_a in (">", ">="):
        if op_b == ">":
            return va > vb or (strict and va >= vb)
        if op_b == ">=":
            return va >= vb
        if op_b == "!=":
            return va > vb or (strict and va >= vb)
        return False
    if op_a in ("<", "<="):
        if op_b == "<":
            return va < vb or (strict and va <= vb)
        if op_b == "<=":
            return va <= vb
        if op_b == "!=":
            return va < vb or (strict and va <= vb)
        return False
    return False


# ---------------------------------------------------------------------------
class RewriteEngine:
    """Pattern registry + scanner + validation gate over one logical plan.

    `ctx` is the owning Optimizer (duck-typed): the join rule borrows its
    distinct-count statistics and placement costing, and reads its rule
    flags so ablation switches keep working through the engine."""

    MAX_PASSES = 8

    def __init__(self, catalog, cost_model, ctx=None):
        self.cat = catalog
        self.cost = cost_model
        self.ctx = ctx
        self.events: List[RewriteEvent] = []
        self._noted: Set[Tuple[str, str]] = set()

    # -- registry ---------------------------------------------------------
    def _rules(self):
        return (
            ("subsume_implied_select", self._subsume_implied, True),
            ("consolidate_duplicate_predicts", self._consolidate, True),
            ("push_semantic_select_through_join", self._push_through_join,
             False),
        )

    # -- driver -----------------------------------------------------------
    def rewrite(self, plan: Node) -> Node:
        for name, rule, order_sensitive in self._rules():
            for _ in range(self.MAX_PASSES):
                cand = rule(plan)
                if cand is None:
                    break
                new_plan, site, detail = cand
                ok, why = self._validate(plan, new_plan, order_sensitive)
                if ok:
                    self.events.append(
                        RewriteEvent(name, site, "fired", detail))
                    plan = new_plan
                else:
                    self.events.append(
                        RewriteEvent(name, site, "rejected", why))
                    break
        return plan

    def scan(self, plan: Node) -> List[Tuple[str, str, str]]:
        """Detection only: (rule, site, detail) for every pattern that
        currently applies, without rewriting anything."""
        out = []
        for name, rule, _ in self._rules():
            cand = rule(plan)
            if cand is not None:
                out.append((name, cand[1], cand[2]))
        return out

    # -- validation gate --------------------------------------------------
    def _validate(self, old: Node, new: Node,
                  order_sensitive: bool) -> Tuple[bool, str]:
        try:
            so, sn = old.schema(self.cat), new.schema(self.cat)
        except Exception:
            return False, "schema computation failed on rewritten plan"
        if order_sensitive and list(so.items()) != list(sn.items()):
            return False, "output schema changed"
        if not order_sensitive and dict(so) != dict(sn):
            return False, "output schema changed"
        def sigs(p):
            return Counter(predict_signature(x.info) for x in walk_plan(p)
                           if isinstance(x, (Predict, SemanticJoin)))
        if sigs(new) - sigs(old):
            return False, "rewrite introduced new semantic work"
        return True, ""

    def _note(self, rule: str, site: str, detail: str) -> None:
        """Record a matched-but-not-fired pattern once per site."""
        if (rule, site) not in self._noted:
            self._noted.add((rule, site))
            self.events.append(RewriteEvent(rule, site, "kept", detail))

    def _est_rows(self, n: Node) -> float:
        try:
            return float(n.est_rows(self.cat))
        except Exception:
            return 32.0

    # -- rule: duplicate-subexpression consolidation -----------------------
    def _dup_below(self, upper: Predict) -> Optional[Predict]:
        """A signature-identical Predict on `upper`'s input chain whose
        outputs are still row-aligned with (and visible at) `upper`'s
        position: the chain may only pass through Filter / OrderBy / Limit
        (row subsets, never value changes) and other Predicts that do not
        overwrite `upper`'s input columns."""
        sig = predict_signature(upper.info)
        inputs = set(upper.info.inputs)
        cur = upper.child
        while cur is not None:
            if isinstance(cur, Predict):
                if cur.child is None:
                    return None
                if predict_signature(cur.info) == sig:
                    return cur
                if set(cur.info.out_cols) & inputs:
                    return None
                cur = cur.child
            elif isinstance(cur, (Filter, OrderBy, Limit)):
                cur = cur.child
            else:
                return None
        return None

    def _consolidate(self, plan: Node):
        for upper in walk_plan(plan):
            if not (isinstance(upper, Predict) and upper.child is not None
                    and not upper.info.agg):
                continue
            lower = self._dup_below(upper)
            if lower is None:
                continue
            try:
                child_schema = list(upper.child.schema(self.cat))
            except Exception:
                continue
            if any(c in child_schema for c in upper.info.out_cols):
                continue
            exprs = [(c, Col(c)) for c in child_schema]
            exprs += [(uc, Col(lc)) for uc, lc
                      in zip(upper.info.out_cols, lower.info.out_cols)]
            repl = Project(upper.child, exprs)
            rows = self._est_rows(upper.child)
            est = self.cost.estimate(upper.info, rows)
            site = (f"Predict[{upper.info.model_name}] "
                    f"out={upper.info.out_cols}")
            detail = (f"duplicate of out={lower.info.out_cols}; aliases "
                      f"shared answers, saves ~{est.expected_calls:.0f} "
                      f"calls over ~{rows:.0f} rows")
            return _rebuild_replace(plan, upper, repl), site, detail
        return None

    # -- rule: predicate implication / subsumption -------------------------
    def _subsume_implied(self, plan: Node):
        for head in walk_plan(plan):
            if not isinstance(head, Filter):
                continue
            # linear Filter/Predict region below (and including) `head`
            chain: List[Node] = []
            cur: Optional[Node] = head
            while isinstance(cur, (Filter, Predict)):
                if isinstance(cur, Predict) and cur.child is None:
                    break
                chain.append(cur)
                cur = cur.child
            base = cur
            if base is None or len(chain) < 3:
                continue
            cand = self._find_subsumption(plan, chain)
            if cand is None:
                continue
            drop, site, detail = cand
            dropped = {id(x) for x in drop}
            new_chain: Node = base
            for node in reversed(chain):
                if id(node) in dropped:
                    continue
                if isinstance(node, Filter):
                    new_chain = Filter(new_chain, node.predicate,
                                       node.selectivity)
                else:
                    new_chain = Predict(new_chain, node.info)
            return _rebuild_replace(plan, head, new_chain), site, detail
        return None

    def _find_subsumption(self, plan: Node, chain: List[Node]):
        """One (dropped nodes, site, detail) candidate in a linear region,
        or None.  A filter B is subsumed when some filter A in the region
        normalizes over a signature-identical predict at the same output
        position and A's predicate implies B's."""
        predicts = [x for x in chain if isinstance(x, Predict)]
        normed = []            # (filter, predict, out_idx, op, lit)
        for f in chain:
            if not isinstance(f, Filter):
                continue
            for p in predicts:
                norm = _normalize_pred(f.predicate, set(p.info.out_cols))
                if norm is not None:
                    col, op, lit = norm
                    normed.append((f, p, p.info.out_cols.index(col), op,
                                   lit))
                    break
        for fa, pa, ia, opa, va in normed:
            for fb, pb, ib, opb, vb in normed:
                if fb is fa or ia != ib:
                    continue
                if predict_signature(pa.info) != predict_signature(pb.info):
                    continue
                if not predicate_implies(opa, va, opb, vb):
                    continue
                drop: List[Node] = [fb]
                if pb is not pa:
                    # dropping the predict too: its outputs must be dead
                    # outside fb, and every predict executing after it in
                    # the region must share its signature (so removal can
                    # only shed calls, never inflate another unit's input)
                    if set(pb.info.out_cols) & _referenced_cols(
                            plan, exclude=(fb,)):
                        continue
                    above = chain[:chain.index(pb)]
                    sig = predict_signature(pb.info)
                    if any(isinstance(q, Predict)
                           and predict_signature(q.info) != sig
                           for q in above):
                        continue
                    drop.append(pb)
                rows = self._est_rows(pb.child if pb.child else pb)
                est = self.cost.estimate(pb.info, rows)
                saved = (f"saves ~{est.expected_calls:.0f} calls"
                         if pb is not pa else "drops a redundant filter")
                site = (f"Filter[{opb}{vb!r}] over "
                        f"Predict[{pb.info.model_name}]")
                detail = (f"implied by [{opa}{va!r}] on an identical "
                          f"predict; {saved}")
                return drop, site, detail
        return None

    # -- rule: semantic select vs join placement ---------------------------
    def _push_through_join(self, plan: Node):
        ctx = self.ctx
        if ctx is None or not ctx.flags.get("enable_join_order", True):
            return None
        for n in walk_plan(plan):
            if not (isinstance(n, Filter) and find_predicts(n.predicate)
                    and isinstance(n.child, Predict)
                    and n.child.child is not None
                    and isinstance(n.child.child, Join)):
                continue
            pred_node = n.child
            join = pred_node.child
            inputs = set(pred_node.info.inputs)
            lsch = set(join.left.schema(self.cat))
            rsch = set(join.right.schema(self.cat))
            side = "left" if inputs <= lsch else \
                "right" if inputs <= rsch else None
            site = (f"Filter over Predict[{pred_node.info.model_name}] "
                    f"over Join")
            if side is None:
                self._note("push_semantic_select_through_join", site,
                           "inputs straddle both join sides")
                continue
            side_plan = join.left if side == "left" else join.right
            d_side = ctx._distinct_count(side_plan, list(inputs))
            d_join = ctx._distinct_count(join, list(inputs))
            if d_side is None or d_join is None:
                self._note("push_semantic_select_through_join", site,
                           "no distinct-count statistics (non-cheap input)")
                continue
            c_side = ctx._placement_cost(pred_node, d_side)
            c_join = ctx._placement_cost(pred_node, d_join)
            if not c_side < c_join:
                self._note(
                    "push_semantic_select_through_join", site,
                    f"kept above join: {side} side distinct={d_side:.0f} "
                    f"not cheaper than above-join distinct={d_join:.0f}")
                continue
            sub = Filter(Predict(side_plan, pred_node.info), n.predicate,
                         n.selectivity)
            if side == "left":
                repl = Join(sub, join.right, join.kind, join.left_keys,
                            join.right_keys, join.extra)
            else:
                repl = Join(join.left, sub, join.kind, join.left_keys,
                            join.right_keys, join.extra)
            detail = (f"pushed to {side} side: distinct={d_side:.0f} < "
                      f"above-join distinct={d_join:.0f} "
                      f"(calls {c_side[0]:.0f} vs {c_join[0]:.0f})")
            return _rebuild_replace(plan, n, repl), site, detail
        return None


# ---------------------------------------------------------------------------
def rewrites_section(events: List[RewriteEvent],
                     rerank_lines: Optional[List[str]] = None) -> str:
    """EXPLAIN `-- rewrites --` body: one line per pattern match (fired /
    rejected / kept with the benefit estimate or legality reason), then one
    line per mid-query re-rank the executor performed."""
    lines = [f"{ev.rule} @ {ev.site}: {ev.action} ({ev.detail})"
             for ev in events]
    for r in rerank_lines or []:
        lines.append("reopt: " + r)
    return "\n".join(lines) if lines else "(no rewrites fired)"
