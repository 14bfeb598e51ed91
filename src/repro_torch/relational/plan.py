"""Logical plan nodes + schema/cardinality propagation.

`Predict` is the paper's LogicalPredict: one node regardless of where the
inference clause appeared (FROM table-inference, scalar WHERE/SELECT/etc.,
table generation, semantic join condition, LLM AGG). PredictInfo carries
everything the physical operator needs (§4.3).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.relational.expr import Expr, PredictExpr, PromptTemplate

_counter = itertools.count()


def fresh_col(prefix: str) -> str:
    return f"__{prefix}_{next(_counter)}"


@dataclasses.dataclass
class PredictInfo:
    model_name: str
    prompt: Optional[PromptTemplate]
    inputs: List[str]
    outputs: List[Tuple[str, str]]          # (column, SQL type)
    out_prefix: str = ""                    # disambiguation prefix
    agg: bool = False
    options: Dict[str, object] = dataclasses.field(default_factory=dict)
    out_cols_override: Optional[List[str]] = None   # set by predicate merging

    @property
    def out_cols(self) -> List[str]:
        if self.out_cols_override is not None:
            return list(self.out_cols_override)
        return [self.out_prefix + n for n, _ in self.outputs]


class Node:
    children: List["Node"] = []

    def schema(self, cat) -> Dict[str, str]:
        raise NotImplementedError

    def est_rows(self, cat) -> float:
        raise NotImplementedError


@dataclasses.dataclass
class Scan(Node):
    table: str
    alias: Optional[str] = None

    @property
    def children(self):
        return []

    def schema(self, cat):
        return dict(cat.table(self.table).schema)

    def est_rows(self, cat):
        return float(len(cat.table(self.table)))


@dataclasses.dataclass
class Filter(Node):
    child: Node
    predicate: Expr
    selectivity: float = 0.5               # planner estimate

    @property
    def children(self):
        return [self.child]

    def schema(self, cat):
        return self.child.schema(cat)

    def est_rows(self, cat):
        return self.child.est_rows(cat) * self.selectivity


@dataclasses.dataclass
class Project(Node):
    child: Node
    exprs: List[Tuple[str, Expr]]          # (output name, expression)

    @property
    def children(self):
        return [self.child]

    def schema(self, cat):
        base = self.child.schema(cat)
        return {n: e.sql_type(base) for n, e in self.exprs}

    def est_rows(self, cat):
        return self.child.est_rows(cat)


@dataclasses.dataclass
class Join(Node):
    left: Node
    right: Node
    kind: str = "inner"                    # inner | cross
    left_keys: List[str] = dataclasses.field(default_factory=list)
    right_keys: List[str] = dataclasses.field(default_factory=list)
    extra: Optional[Expr] = None           # residual non-equi condition

    @property
    def children(self):
        return [self.left, self.right]

    def schema(self, cat):
        s = dict(self.left.schema(cat))
        s.update(self.right.schema(cat))
        return s

    def est_rows(self, cat):
        l, r = self.left.est_rows(cat), self.right.est_rows(cat)
        if self.kind == "cross" or not self.left_keys:
            return l * r
        return max(l, r)                   # FK-join heuristic


@dataclasses.dataclass
class GroupBy(Node):
    child: Node
    keys: List[str]
    aggs: List[Tuple[str, str, Optional[Expr]]]   # (out, fn, arg)

    @property
    def children(self):
        return [self.child]

    def schema(self, cat):
        base = self.child.schema(cat)
        out = {k: base[k] for k in self.keys}
        for name, fn, arg in self.aggs:
            if fn in ("count",):
                out[name] = "INTEGER"
            elif fn in ("avg", "sum", "min", "max"):
                out[name] = "DOUBLE" if fn in ("avg", "sum") else \
                    (arg.sql_type(base) if arg else "DOUBLE")
            else:
                out[name] = "VARCHAR"      # llm_agg
        return out

    def est_rows(self, cat):
        return max(1.0, self.child.est_rows(cat) / 10.0)


@dataclasses.dataclass
class OrderBy(Node):
    child: Node
    keys: List[Tuple[Expr, bool]]          # (expr, ascending)

    @property
    def children(self):
        return [self.child]

    def schema(self, cat):
        return self.child.schema(cat)

    def est_rows(self, cat):
        return self.child.est_rows(cat)


@dataclasses.dataclass
class Limit(Node):
    child: Node
    n: int

    @property
    def children(self):
        return [self.child]

    def schema(self, cat):
        return self.child.schema(cat)

    def est_rows(self, cat):
        return min(self.n, self.child.est_rows(cat))


@dataclasses.dataclass
class Predict(Node):
    """LogicalPredict: adds info.out_cols to the child's schema.
    child=None → table generation (ρ^s, LLM-as-scan)."""
    child: Optional[Node]
    info: PredictInfo

    @property
    def children(self):
        return [self.child] if self.child else []

    def schema(self, cat):
        base = dict(self.child.schema(cat)) if self.child else {}
        for (n, t), c in zip(self.info.outputs, self.info.out_cols):
            base[c] = t
        return base

    def est_rows(self, cat):
        return self.child.est_rows(cat) if self.child else 32.0


@dataclasses.dataclass
class SemanticJoin(Node):
    """R ⋈^s_P S — boolean LLM predicate over the cross product (§3.3).
    Physically: cross join (chunked) → Predict(BOOLEAN) → Filter."""
    left: Node
    right: Node
    info: PredictInfo

    @property
    def children(self):
        return [self.left, self.right]

    def schema(self, cat):
        s = dict(self.left.schema(cat))
        s.update(self.right.schema(cat))
        return s

    def est_rows(self, cat):
        return self.left.est_rows(cat) * self.right.est_rows(cat) * 0.1


def walk_plan(n: Node):
    yield n
    for c in n.children:
        yield from walk_plan(c)


def plan_repr(n: Node, indent: int = 0) -> str:
    pad = "  " * indent
    label = type(n).__name__
    extra = ""
    if isinstance(n, Scan):
        extra = f" {n.table}" + (f" as {n.alias}" if n.alias else "")
    if isinstance(n, Filter):
        extra = f" {n.predicate!r}"
    if isinstance(n, Predict):
        extra = f" {n.info.model_name} out={n.info.out_cols}"
    if isinstance(n, SemanticJoin):
        extra = f" {n.info.model_name}"
    if isinstance(n, Join):
        extra = f" {n.kind} {list(zip(n.left_keys, n.right_keys))}"
    lines = [f"{pad}{label}{extra}"]
    for c in n.children:
        lines.append(plan_repr(c, indent + 1))
    return "\n".join(lines)
