"""Binder/planner: AST → logical plan (paper Fig. 2 pipeline stages).

Responsibilities (paper §4.2/§4.3):
  * resolve relations and aliases; qualify `alias.col` references into the
    flat column namespace (alias prefixes are materialized as renames)
  * validate model references against the model catalog; resolve prompt
    placeholders into typed inputs/outputs
  * turn every PredictExpr into a LogicalPredict at the right place:
      - FROM LLM(...)            → Predict over source (table inference)
        or Predict over nothing  → table generation
      - scalar inference in WHERE/SELECT/ORDER/GROUP → Predict inserted
        above the current plan, expression rewritten to the predicted col
      - JOIN ... ON LLM(...)     → SemanticJoin
      - LLM AGG                  → GroupBy llm_agg aggregate
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.relational import parser as PS
from repro_torch.relational.catalog import Catalog
from repro_torch.relational.expr import (BinOp, Col, Expr, Lit, Not, PredictExpr,
                                   PromptTemplate, find_predicts, replace_expr)
from repro_torch.relational.parser import FuncCall
from repro_torch.relational.plan import (Filter, GroupBy, Join, Limit, Node,
                                   OrderBy, Predict, PredictInfo, Project,
                                   Scan, SemanticJoin, fresh_col)


class BindError(Exception):
    pass


def _qualify(e: Expr, scope: Dict[str, str]) -> Expr:
    """Rewrite alias.col / bare col via the scope map (alias.col → concrete)."""
    if isinstance(e, Col):
        if e.name in scope:
            return Col(scope[e.name])
        base = e.name.split(".")[-1]
        if base in scope:
            return Col(scope[base])
        return Col(base)
    if isinstance(e, PredictExpr) and e.prompt:
        new_inputs = []
        for c in e.prompt.inputs:
            new_inputs.append(scope.get(c, scope.get(c.split(".")[-1],
                                                     c.split(".")[-1])))
        pt = PromptTemplate(e.prompt.raw, e.prompt.instruction, new_inputs,
                            e.prompt.outputs)
        return PredictExpr(e.model_name, pt, e.source, e.agg, e.resolved_col,
                           e.options)
    if dataclasses.is_dataclass(e) and isinstance(e, Expr):
        kw = {}
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, Expr):
                kw[f.name] = _qualify(v, scope)
            elif isinstance(v, list) and v and isinstance(v[0], Expr):
                kw[f.name] = [_qualify(x, scope) for x in v]
            else:
                kw[f.name] = v
        return type(e)(**kw)
    return e


class Binder:
    def __init__(self, catalog: Catalog, session_options: Dict[str, object]):
        self.cat = catalog
        self.opts = session_options

    # ------------------------------------------------------------------
    def bind_select(self, stmt: PS.SelectStmt) -> Node:
        plan: Optional[Node] = None
        scope: Dict[str, str] = {}

        if stmt.from_rel is not None:
            plan, scope = self._bind_rel(stmt.from_rel)
            for jc in stmt.joins:
                rplan, rscope = self._bind_rel(jc.rel)
                plan, scope = self._bind_join(plan, scope, rplan, rscope, jc)

        # WHERE
        if stmt.where is not None:
            pred = _qualify(stmt.where, scope)
            plan = self._plant_scalar_predicts(plan, pred, scope)
            pred = self._rewrite_resolved(pred)
            plan = Filter(plan, pred)

        # GROUP BY + aggregates (incl. LLM AGG)
        sel_exprs: List[Tuple[str, Expr]] = []
        agg_specs: List[Tuple[str, str, Optional[Expr]]] = []
        has_agg = False
        for alias, e in stmt.select:
            eq = _qualify(e, scope)
            if isinstance(eq, FuncCall) and eq.name in ("count", "sum", "avg",
                                                        "min", "max"):
                has_agg = True
            if isinstance(eq, PredictExpr) and eq.agg:
                has_agg = True
            sel_exprs.append((alias, eq))

        if stmt.group_by or has_agg:
            plan = self._bind_groupby(plan, scope, stmt, sel_exprs)
            if stmt.order_by:
                keys = []
                for e, asc in stmt.order_by:
                    eq = _qualify(e, scope)
                    plan = self._plant_scalar_predicts(plan, eq, scope)
                    keys.append((eq, asc))
                plan = OrderBy(plan, keys)
        else:
            # scalar predicts in the projection list
            for i, (alias, e) in enumerate(sel_exprs):
                plan = self._plant_scalar_predicts(plan, e, scope)
                sel_exprs[i] = (alias, self._rewrite_resolved(e))
            # ORDER BY binds BEFORE projection: its (possibly semantic)
            # keys may need input columns the projection drops
            if stmt.order_by:
                keys = []
                for e, asc in stmt.order_by:
                    eq = _qualify(e, scope)
                    plan = self._plant_scalar_predicts(plan, eq, scope)
                    keys.append((eq, asc))
                plan = OrderBy(plan, keys)
            if not stmt.star:
                named = []
                used = set()
                for alias, e in sel_exprs:
                    name = alias or (e.name if isinstance(e, Col)
                                     else fresh_col("expr"))
                    base = name.split(".")[-1].split("__")[-1]
                    out_name = base if base not in used else \
                        name.split(".")[-1]
                    used.add(out_name)
                    named.append((out_name, e))
                plan = Project(plan, named)

        if stmt.limit is not None:
            plan = Limit(plan, stmt.limit)
        return plan

    # ------------------------------------------------------------------
    def _bind_rel(self, rel: PS.RelRef) -> Tuple[Node, Dict[str, str]]:
        if rel.kind == "table":
            t = self.cat.table(rel.name)
            scope = {}
            if rel.alias:
                # alias-qualified internal names make self-joins sound
                ren = {c: f"{rel.alias}__{c}" for c in t.column_names}
                plan: Node = Project(Scan(rel.name, rel.alias),
                                     [(ren[c], Col(c))
                                      for c in t.column_names])
                for c in t.column_names:
                    scope[f"{rel.alias}.{c}"] = ren[c]
                    scope.setdefault(c, ren[c])
                return plan, scope
            alias = rel.name
            for c in t.column_names:
                scope[f"{alias}.{c}"] = c
                scope.setdefault(c, c)
            return Scan(rel.name, rel.alias), scope

        # LLM / PREDICT relation (table inference or generation)
        entry = self.cat.model(rel.name)
        if rel.prompt is not None:
            pt = PromptTemplate.parse(rel.prompt)
        elif entry.output_set:
            pt = None
        else:
            raise BindError(f"model {rel.name} needs a PROMPT or catalog outputs")

        child: Optional[Node] = None
        scope: Dict[str, str] = {}
        if rel.source is not None:
            child, scope = self._bind_rel(rel.source)
        elif entry.relation:
            child, scope = self._bind_rel(PS.RelRef("table", entry.relation))

        if pt is not None:
            inputs = [scope.get(c, scope.get(c.split(".")[-1],
                                             c.split(".")[-1]))
                      for c in pt.inputs]
            outputs = pt.outputs
        else:
            inputs = entry.input_set or []
            outputs = entry.output_set or []

        # §5.3 precedence: per-expression WITH options over model OPTIONS
        info = PredictInfo(model_name=rel.name, prompt=pt, inputs=inputs,
                           outputs=outputs,
                           options={**entry.options, **(rel.options or {})})
        plan = Predict(child, info)
        out_scope = dict(scope)
        alias = rel.alias
        for (n, _), c in zip(outputs, info.out_cols):
            out_scope[n] = c
            if alias:
                out_scope[f"{alias}.{n}"] = c
        return plan, out_scope

    # ------------------------------------------------------------------
    def _bind_join(self, lplan, lscope, rplan, rscope, jc: PS.JoinClause):
        scope = dict(lscope)
        scope.update(rscope)
        if jc.natural:
            shared = sorted((set(lscope) & set(rscope)) -
                            {k for k in lscope if "." in k})
            shared = [c for c in shared if "." not in c]
            if not shared:
                raise BindError("NATURAL JOIN with no shared columns")
            # rename right-side shared columns to avoid collision
            ren = {rscope[c]: fresh_col(c) for c in shared}
            rplan = Project(rplan, [(ren.get(v, v), Col(v)) for k, v in
                                    sorted(set((k, v) for k, v in rscope.items()
                                               if "." not in k))])
            join = Join(lplan, rplan, "inner",
                        [lscope[c] for c in shared],
                        [ren[rscope[c]] for c in shared])
            return join, scope
        if jc.on is None:
            return Join(lplan, rplan, "cross"), scope

        on = _qualify(jc.on, scope)
        preds = find_predicts(on)
        if preds:
            if len(preds) == 1 and on is preds[0]:
                # pure semantic join
                p = preds[0]
                info = self._predict_info(p, boolean=True)
                return SemanticJoin(lplan, rplan, info), scope
            # mixed condition: cross join + predicts + residual filter
            plan = Join(lplan, rplan, "cross")
            plan = self._plant_scalar_predicts(plan, on, scope)
            return Filter(plan, self._rewrite_resolved(on)), scope

        lk, rk, residual = self._split_equi(on, lscope, rscope)
        if lk:
            return Join(lplan, rplan, "inner", lk, rk, residual), scope
        return Filter(Join(lplan, rplan, "cross"), on), scope

    def _split_equi(self, on: Expr, lscope, rscope):
        lcols = set(lscope.values())
        rcols = set(rscope.values())
        lk, rk, residual = [], [], []

        def collect(e):
            if isinstance(e, BinOp) and e.op == "AND":
                collect(e.left)
                collect(e.right)
                return
            if (isinstance(e, BinOp) and e.op == "=" and
                    isinstance(e.left, Col) and isinstance(e.right, Col)):
                l, r = e.left.name, e.right.name
                if l in lcols and r in rcols:
                    lk.append(l)
                    rk.append(r)
                    return
                if l in rcols and r in lcols:
                    lk.append(r)
                    rk.append(l)
                    return
            residual.append(e)

        collect(on)
        res = None
        for e in residual:
            res = e if res is None else BinOp("AND", res, e)
        return lk, rk, res

    # ------------------------------------------------------------------
    def _predict_info(self, p: PredictExpr, *, boolean: bool = False
                      ) -> PredictInfo:
        entry = self.cat.model(p.model_name)
        outputs = list(p.prompt.outputs) if p.prompt else \
            list(entry.output_set or [])
        if boolean and not outputs:
            outputs = [("match", "BOOLEAN")]
        if not outputs:
            raise BindError(f"predict on {p.model_name} has no output columns")
        # §5.3 precedence: per-expression WITH options over model OPTIONS
        info = PredictInfo(model_name=p.model_name, prompt=p.prompt,
                           inputs=list(p.prompt.inputs) if p.prompt
                           else list(entry.input_set or []),
                           outputs=outputs, out_prefix=fresh_col("p") + "_",
                           agg=p.agg,
                           options={**entry.options, **(p.options or {})})
        return info

    def _plant_scalar_predicts(self, plan: Node, e: Expr, scope) -> Node:
        """Insert a Predict node for every unresolved PredictExpr inside e;
        mutates the PredictExpr.resolved_col in place (the expr objects are
        shared with the caller's tree)."""
        for p in find_predicts(e):
            if p.resolved_col is not None or p.agg:
                continue
            info = self._predict_info(p)
            plan = Predict(plan, info)
            # scalar inference exposes its FIRST output column
            p.resolved_col = info.out_cols[0]
        return plan

    def _rewrite_resolved(self, e: Expr) -> Expr:
        """PredictExpr(resolved) compares like its predicted column; handled
        by PredictExpr.evaluate via resolved_col, so nothing to do — kept
        for symmetry/clarity."""
        return e

    # ------------------------------------------------------------------
    def _bind_groupby(self, plan, scope, stmt: PS.SelectStmt, sel_exprs):
        keys = [scope.get(k, scope.get(k.split(".")[-1], k.split(".")[-1]))
                for k in stmt.group_by]
        aggs: List[Tuple[str, str, Optional[Expr]]] = []
        out_names: List[Tuple[str, Expr]] = []
        for alias, e in sel_exprs:
            if isinstance(e, FuncCall) and e.name in ("count", "sum", "avg",
                                                      "min", "max"):
                name = alias or fresh_col(e.name)
                arg = e.args[0] if e.args and not isinstance(e.args[0], Lit) \
                    else (None if not e.args or isinstance(e.args[0], Lit)
                          else e.args[0])
                aggs.append((name, e.name, arg))
                out_names.append((name, Col(name)))
            elif isinstance(e, PredictExpr) and e.agg:
                name = alias or fresh_col("llm_agg")
                plan_info = self._predict_info(e)
                aggs.append((name, "llm_agg", None))
                # stash info on the agg tuple via closure-side table
                aggs[-1] = (name, "llm_agg", None)
                self._llm_agg_infos = getattr(self, "_llm_agg_infos", {})
                self._llm_agg_infos[name] = plan_info
                out_names.append((name, Col(name)))
            elif isinstance(e, Col):
                out_names.append((alias or e.name.split(".")[-1], e))
            else:
                # scalar predicts before grouping
                plan = self._plant_scalar_predicts(plan, e, scope)
                name = alias or fresh_col("expr")
                out_names.append((name, e))
        gb = GroupBy(plan, keys, aggs)
        gb.llm_agg_infos = getattr(self, "_llm_agg_infos", {})
        self._llm_agg_infos = {}
        return Project(gb, out_names)
