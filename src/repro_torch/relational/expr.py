"""Expression AST + vectorized evaluation over Tables.

`PredictExpr` is the unified PGPredictExpr node of the paper (§4.2): it
appears wherever an expression may (WHERE / SELECT / GROUP BY / ORDER BY /
JOIN ON) and wherever a relation may (FROM → table inference / generation).
Its evaluation is NOT done here — the planner turns it into a
Logical/Physical Predict operator; by execution time the predicted column
already exists and the expression has been rewritten to a Col reference.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.relational.table import Table


class Expr:
    def columns(self) -> List[str]:
        raise NotImplementedError

    def evaluate(self, t: Table) -> np.ndarray:
        raise NotImplementedError

    def sql_type(self, schema: Dict[str, str]) -> str:
        return "VARCHAR"


@dataclasses.dataclass
class Col(Expr):
    name: str

    def columns(self):
        return [self.name]

    def evaluate(self, t: Table):
        return t.column(self.name)

    def sql_type(self, schema):
        return schema.get(self.name, "VARCHAR")

    def __repr__(self):
        return f"Col({self.name})"


@dataclasses.dataclass
class Lit(Expr):
    value: object

    def columns(self):
        return []

    def evaluate(self, t: Table):
        return np.full(len(t), self.value,
                       dtype=object if isinstance(self.value, str) else None)

    def sql_type(self, schema):
        if isinstance(self.value, bool):
            return "BOOLEAN"
        if isinstance(self.value, int):
            return "INTEGER"
        if isinstance(self.value, float):
            return "DOUBLE"
        return "VARCHAR"

    def __repr__(self):
        return f"Lit({self.value!r})"


@dataclasses.dataclass
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def columns(self):
        return self.left.columns() + self.right.columns()

    def evaluate(self, t: Table):
        l = self.left.evaluate(t)
        r = self.right.evaluate(t)
        op = self.op
        if op in ("AND", "OR"):
            l = np.asarray(l, bool)
            r = np.asarray(r, bool)
            return l & r if op == "AND" else l | r
        if op == "LIKE":
            pat = re.escape(str(self.right.value)).replace("%", ".*") \
                .replace(r"\%", ".*").replace("_", ".")
            rx = re.compile(f"^{pat}$", re.IGNORECASE)
            return np.array([bool(rx.match(str(x))) if x is not None else False
                             for x in l])
        if l.dtype == object or (hasattr(r, "dtype") and r.dtype == object):
            lc = np.array([None if x is None else str(x) for x in l], object)
            rc = np.array([None if x is None else str(x) for x in
                           (r if hasattr(r, "__len__") else [r] * len(l))],
                          object)
            cmp = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
                   "<": lambda a, b: a < b, ">": lambda a, b: a > b,
                   "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b}[op]
            return np.array([False if (a is None or b is None) else cmp(a, b)
                             for a, b in zip(lc, rc)])
        fn = {"=": np.equal, "!=": np.not_equal, "<": np.less,
              ">": np.greater, "<=": np.less_equal, ">=": np.greater_equal,
              "+": np.add, "-": np.subtract, "*": np.multiply,
              "/": np.divide}[op]
        return fn(l, r)

    def sql_type(self, schema):
        if self.op in ("AND", "OR", "=", "!=", "<", ">", "<=", ">=", "LIKE"):
            return "BOOLEAN"
        lt = self.left.sql_type(schema)
        rt = self.right.sql_type(schema)
        return "DOUBLE" if "DOUBLE" in (lt, rt) or self.op == "/" else lt

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclasses.dataclass
class Not(Expr):
    child: Expr

    def columns(self):
        return self.child.columns()

    def evaluate(self, t: Table):
        return ~np.asarray(self.child.evaluate(t), bool)

    def sql_type(self, schema):
        return "BOOLEAN"


# ------------------------------ prompts --------------------------------------
_IN_RE = re.compile(r"\{\{\s*([\w.]+)\s*\}\}")
_OUT_RE = re.compile(r"\{\s*(\w+)\s+(VARCHAR|INTEGER|INT|DOUBLE|FLOAT|BOOLEAN|"
                     r"BOOL|DATETIME|DATE)\s*\}", re.IGNORECASE)


@dataclasses.dataclass
class PromptTemplate:
    """Parsed prompt: instruction text + {{input cols}} + {out TYPE} cols
    (paper §3.2/§4.2 placeholder resolution)."""
    raw: str
    instruction: str
    inputs: List[str]
    outputs: List[Tuple[str, str]]        # (name, SQL type)

    @staticmethod
    def parse(raw: str) -> "PromptTemplate":
        inputs = _IN_RE.findall(raw)
        outputs = [(m.group(1), _norm_type(m.group(2)))
                   for m in _OUT_RE.finditer(raw)]
        instr = _IN_RE.sub(lambda m: f"<{m.group(1)}>", raw)
        instr = _OUT_RE.sub(lambda m: m.group(1), instr)
        return PromptTemplate(raw, instr, inputs, outputs)


def _norm_type(t: str) -> str:
    t = t.upper()
    return {"INT": "INTEGER", "FLOAT": "DOUBLE", "BOOL": "BOOLEAN",
            "DATE": "DATETIME"}.get(t, t)


@dataclasses.dataclass
class PredictExpr(Expr):
    """Unified inference node (paper's PGPredictExpr): resolved into a
    Predict plan operator during planning. model_name references the model
    catalog; source is the optional input relation (table inference);
    agg marks LLM AGG."""
    model_name: str
    prompt: Optional[PromptTemplate]
    source: Optional[str] = None
    agg: bool = False
    # name assigned by the planner once materialized into a column:
    resolved_col: Optional[str] = None
    # per-expression options (WITH (k=v, ...)); highest precedence in the
    # §5.3 chain: defaults < session SET < model OPTIONS < expression WITH
    options: Dict[str, object] = dataclasses.field(default_factory=dict)

    def columns(self):
        # input columns needed from the child relation
        return list(self.prompt.inputs) if self.prompt else []

    def evaluate(self, t: Table):
        if self.resolved_col is None:
            raise RuntimeError(
                "PredictExpr evaluated before planning resolved it into a "
                "predict operator — planner bug")
        return t.column(self.resolved_col)

    def sql_type(self, schema):
        if self.prompt and len(self.prompt.outputs) == 1:
            return self.prompt.outputs[0][1]
        return "VARCHAR"

    def __repr__(self):
        outs = [o for o, _ in self.prompt.outputs] if self.prompt else []
        return f"PredictExpr({self.model_name}, in={self.prompt.inputs if self.prompt else []}, out={outs})"


def walk(e: Expr):
    yield e
    for f in dataclasses.fields(e) if dataclasses.is_dataclass(e) else []:
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            yield from walk(v)


def find_predicts(e: Expr) -> List[PredictExpr]:
    return [x for x in walk(e) if isinstance(x, PredictExpr)]


def replace_expr(e: Expr, old: Expr, new: Expr) -> Expr:
    if e is old:
        return new
    if dataclasses.is_dataclass(e):
        kw = {}
        changed = False
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, Expr):
                nv = replace_expr(v, old, new)
                changed |= nv is not v
                kw[f.name] = nv
            else:
                kw[f.name] = v
        if changed:
            return type(e)(**kw)
    return e
