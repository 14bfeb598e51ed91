"""Recursive-descent parser for iPDB's extended SQL (paper §3).

Supported statements:
  CREATE LLM MODEL name PATH 'id' [ON PROMPT] [API 'url'] [OPTIONS {..}]
  CREATE TABULAR MODEL name PATH 'p' ON TABLE t FEATURES (c,..) OUTPUT (c T,..)
  CREATE TABLE name AS <select>
  SET key = value
  SELECT <exprs> FROM <relation> [JOIN <relation> ON <cond>]*
      [WHERE <cond>] [GROUP BY cols] [ORDER BY expr [ASC|DESC],..] [LIMIT n]

Relations: table [AS alias] | LLM model (PROMPT '...'[, table]) [AS alias]
           | PREDICT model (table) [AS alias]
Expressions may contain LLM model (PROMPT '...') scalar-inference calls and
LLM AGG model (PROMPT '...') semantic aggregates (§3.2).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.relational.expr import (BinOp, Col, Expr, Lit, Not, PredictExpr,
                                   PromptTemplate)

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<str>'(?:[^']|'')*')
    | (?P<num>-?\d+\.\d+|-?\d+)
    | (?P<op><=|>=|!=|<>|=|<|>|\{|\}|\(|\)|,|\.|\*|\+|-|/|;|:)
    | (?P<word>[A-Za-z_][A-Za-z_0-9]*)
    )""", re.VERBOSE)

KEYWORDS = {"SELECT", "FROM", "WHERE", "GROUP", "ORDER", "BY", "LIMIT", "AS",
            "JOIN", "ON", "AND", "OR", "NOT", "LIKE", "CREATE", "TABLE",
            "MODEL", "LLM", "TABULAR", "PREDICT", "PROMPT", "PATH", "API",
            "OPTIONS", "FEATURES", "OUTPUT", "SET", "ASC", "DESC", "NATURAL",
            "AGG", "TRUE", "FALSE", "DISTINCT", "DROP", "EMBED", "INSERT",
            "WITH"}


@dataclasses.dataclass
class Tok:
    kind: str      # str | num | op | word
    text: str


def tokenize(sql: str) -> List[Tok]:
    out, i = [], 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            if sql[i:].strip() == "":
                break
            raise SyntaxError(f"cannot tokenize at: {sql[i:i+30]!r}")
        i = m.end()
        for kind in ("str", "num", "op", "word"):
            t = m.group(kind)
            if t is not None:
                out.append(Tok(kind, t))
                break
    return out


# -------------------------------- AST ----------------------------------------
@dataclasses.dataclass
class RelRef:
    kind: str                         # table | llm | predict
    name: str = ""                    # table name or model name
    alias: Optional[str] = None
    prompt: Optional[str] = None
    source: Optional["RelRef"] = None  # input relation for llm/predict
    # per-expression options (WITH (k=v, ...)); merged over model OPTIONS
    options: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class JoinClause:
    rel: RelRef
    natural: bool = False
    on: Optional[Expr] = None


@dataclasses.dataclass
class SelectStmt:
    select: List[Tuple[Optional[str], Expr]]   # (alias, expr); ('*', None)
    star: bool = False
    from_rel: Optional[RelRef] = None
    joins: List[JoinClause] = dataclasses.field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[str] = dataclasses.field(default_factory=list)
    order_by: List[Tuple[Expr, bool]] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None


@dataclasses.dataclass
class CreateModel:
    name: str
    model_type: str                   # LLM | TABULAR
    path: str
    on_prompt: bool = True
    api: Optional[str] = None
    relation: Optional[str] = None
    features: Optional[List[str]] = None
    output: Optional[List[Tuple[str, str]]] = None
    options: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CreateTableAs:
    name: str
    select: SelectStmt


@dataclasses.dataclass
class SetStmt:
    key: str
    value: object


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- helpers ------------------------------------------------------------
    def peek(self, k: int = 0) -> Optional[Tok]:
        return self.toks[self.i + k] if self.i + k < len(self.toks) else None

    def at_word(self, *words: str) -> bool:
        t = self.peek()
        return t is not None and t.kind == "word" and t.text.upper() in words

    def eat(self) -> Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_word(self, w: str) -> None:
        t = self.eat()
        if t.kind != "word" or t.text.upper() != w:
            raise SyntaxError(f"expected {w}, got {t.text!r}")

    def expect_op(self, op: str) -> None:
        t = self.eat()
        if t.kind != "op" or t.text != op:
            raise SyntaxError(f"expected {op!r}, got {t.text!r}")

    def try_op(self, op: str) -> bool:
        t = self.peek()
        if t and t.kind == "op" and t.text == op:
            self.i += 1
            return True
        return False

    def ident(self) -> str:
        t = self.eat()
        if t.kind != "word":
            raise SyntaxError(f"expected identifier, got {t.text!r}")
        name = t.text
        while self.try_op("."):
            name += "." + self.eat().text
        return name

    def string(self) -> str:
        t = self.eat()
        if t.kind != "str":
            raise SyntaxError(f"expected string, got {t.text!r}")
        return t.text[1:-1].replace("''", "'")

    def _with_options(self) -> Dict[str, object]:
        """Optional per-expression options: WITH (k = v, ...).  Values:
        numbers, strings, TRUE/FALSE, bare identifiers (e.g. model
        names).  Used for e.g. PREDICT ... WITH
        (cascade_target_precision = 0.95)."""
        opts: Dict[str, object] = {}
        if not self.at_word("WITH"):
            return opts
        self.eat()
        self.expect_op("(")
        while not self.try_op(")"):
            k = self.ident()
            self.expect_op("=")
            t = self.eat()
            v: object
            if t.kind == "num":
                v = float(t.text) if "." in t.text else int(t.text)
            elif t.kind == "str":
                v = t.text[1:-1]
            elif t.kind == "word" and t.text.upper() in ("TRUE", "FALSE"):
                v = t.text.upper() == "TRUE"
            else:
                v = t.text
            opts[k] = v
            self.try_op(",")
        return opts

    # -- statements ----------------------------------------------------------
    def parse(self):
        if self.at_word("CREATE"):
            return self._create()
        if self.at_word("SET"):
            return self._set()
        if self.at_word("SELECT"):
            return self._select()
        raise SyntaxError(f"unsupported statement start: {self.peek().text!r}")

    def _set(self) -> SetStmt:
        self.expect_word("SET")
        key = self.ident()
        self.expect_op("=")
        t = self.eat()
        val: object
        if t.kind == "num":
            val = float(t.text) if "." in t.text else int(t.text)
        elif t.kind == "str":
            val = t.text[1:-1]
        else:
            val = t.text
        return SetStmt(key, val)

    def _create(self):
        self.expect_word("CREATE")
        if self.at_word("TABLE"):
            self.eat()
            name = self.ident()
            self.expect_word("AS")
            return CreateTableAs(name, self._select())
        mtype = self.eat().text.upper()           # LLM | TABULAR | EMBED
        self.expect_word("MODEL")
        name = self.ident()
        cm = CreateModel(name=name, model_type=mtype, path="")
        while self.peek() is not None and not (self.peek().kind == "op"
                                               and self.peek().text == ";"):
            if self.at_word("PATH"):
                self.eat()
                cm.path = self.string()
            elif self.at_word("ON"):
                self.eat()
                if self.at_word("PROMPT"):
                    self.eat()
                    cm.on_prompt = True
                    if self.at_word("API"):
                        self.eat()
                        cm.api = self.string()
                elif self.at_word("TABLE"):
                    self.eat()
                    cm.relation = self.ident()
                    cm.on_prompt = False
            elif self.at_word("API"):
                self.eat()
                cm.api = self.string()
            elif self.at_word("FEATURES"):
                self.eat()
                self.expect_op("(")
                cm.features = []
                while True:
                    cm.features.append(self.ident())
                    if not self.try_op(","):
                        break
                self.expect_op(")")
                cm.on_prompt = False
            elif self.at_word("OUTPUT"):
                self.eat()
                self.expect_op("(")
                cm.output = []
                while True:
                    n = self.ident()
                    ty = self.eat().text.upper()
                    cm.output.append((n, ty))
                    if not self.try_op(","):
                        break
                self.expect_op(")")
            elif self.at_word("OPTIONS"):
                self.eat()
                self.expect_op("{")
                while not self.try_op("}"):
                    k = self.string() if self.peek().kind == "str" else self.ident()
                    self.expect_op(":")
                    t = self.eat()
                    v: object
                    if t.kind == "num":
                        v = float(t.text) if "." in t.text else int(t.text)
                    elif t.kind == "str":
                        v = t.text[1:-1]
                    else:
                        v = t.text
                    cm.options[k] = v
                    self.try_op(",")
            else:
                raise SyntaxError(f"unexpected token {self.peek().text!r} in CREATE MODEL")
        return cm

    # -- SELECT ----------------------------------------------------------------
    def _select(self) -> SelectStmt:
        self.expect_word("SELECT")
        stmt = SelectStmt(select=[])
        if self.try_op("*"):
            stmt.star = True
        else:
            while True:
                e = self._expr()
                alias = None
                if self.at_word("AS"):
                    self.eat()
                    alias = self.ident()
                stmt.select.append((alias, e))
                if not self.try_op(","):
                    break
        if self.at_word("FROM"):
            self.eat()
            stmt.from_rel = self._relref()
            while self.at_word("JOIN", "NATURAL"):
                natural = False
                if self.at_word("NATURAL"):
                    self.eat()
                    natural = True
                self.expect_word("JOIN")
                rel = self._relref()
                on = None
                if self.at_word("ON"):
                    self.eat()
                    on = self._expr()
                stmt.joins.append(JoinClause(rel, natural, on))
        if self.at_word("WHERE"):
            self.eat()
            stmt.where = self._expr()
        if self.at_word("GROUP"):
            self.eat()
            self.expect_word("BY")
            while True:
                stmt.group_by.append(self.ident())
                if not self.try_op(","):
                    break
        if self.at_word("ORDER"):
            self.eat()
            self.expect_word("BY")
            while True:
                e = self._expr()
                asc = True
                if self.at_word("ASC", "DESC"):
                    asc = self.eat().text.upper() == "ASC"
                stmt.order_by.append((e, asc))
                if not self.try_op(","):
                    break
        if self.at_word("LIMIT"):
            self.eat()
            stmt.limit = int(self.eat().text)
        return stmt

    def _relref(self) -> RelRef:
        if self.at_word("LLM", "PREDICT"):
            kind = self.eat().text.lower()
            model = self.ident()
            self.expect_op("(")
            prompt = None
            source = None
            if self.at_word("PROMPT"):
                self.eat()
                prompt = self.string()
                if self.try_op(","):
                    source = self._relref()
            else:
                source = self._relref()
            self.expect_op(")")
            opts = self._with_options()
            alias = None
            if self.at_word("AS"):
                self.eat()
                alias = self.ident()
            return RelRef(kind="llm" if kind == "llm" else "predict",
                          name=model, alias=alias, prompt=prompt,
                          source=source, options=opts)
        name = self.ident()
        alias = None
        if self.at_word("AS"):
            self.eat()
            alias = self.ident()
        elif self.peek() and self.peek().kind == "word" and \
                self.peek().text.upper() not in KEYWORDS:
            alias = self.eat().text
        return RelRef(kind="table", name=name, alias=alias)

    # -- expressions -------------------------------------------------------------
    def _expr(self) -> Expr:
        return self._or()

    def _or(self) -> Expr:
        e = self._and()
        while self.at_word("OR"):
            self.eat()
            e = BinOp("OR", e, self._and())
        return e

    def _and(self) -> Expr:
        e = self._not()
        while self.at_word("AND"):
            self.eat()
            e = BinOp("AND", e, self._not())
        return e

    def _not(self) -> Expr:
        if self.at_word("NOT"):
            self.eat()
            return Not(self._not())
        return self._cmp()

    def _cmp(self) -> Expr:
        e = self._add()
        t = self.peek()
        if t and t.kind == "op" and t.text in ("=", "!=", "<>", "<", ">", "<=", ">="):
            op = self.eat().text
            if op == "<>":
                op = "!="
            return BinOp(op, e, self._add())
        if self.at_word("LIKE"):
            self.eat()
            return BinOp("LIKE", e, self._add())
        return e

    def _add(self) -> Expr:
        e = self._mul()
        while True:
            t = self.peek()
            if t and t.kind == "op" and t.text in ("+", "-"):
                op = self.eat().text
                e = BinOp(op, e, self._mul())
            else:
                return e

    def _mul(self) -> Expr:
        e = self._atom()
        while True:
            t = self.peek()
            if t and t.kind == "op" and t.text in ("*", "/"):
                op = self.eat().text
                e = BinOp(op, e, self._atom())
            else:
                return e

    def _atom(self) -> Expr:
        t = self.peek()
        if t is None:
            raise SyntaxError("unexpected end of input")
        if t.kind == "op" and t.text == "(":
            self.eat()
            e = self._expr()
            self.expect_op(")")
            return e
        if t.kind == "str":
            return Lit(self.string())
        if t.kind == "num":
            self.eat()
            return Lit(float(t.text) if "." in t.text else int(t.text))
        if self.at_word("TRUE"):
            self.eat()
            return Lit(True)
        if self.at_word("FALSE"):
            self.eat()
            return Lit(False)
        if self.at_word("LLM", "PREDICT"):
            self.eat()
            agg = False
            if self.at_word("AGG"):
                self.eat()
                agg = True
            model = self.ident()
            self.expect_op("(")
            prompt = None
            if self.at_word("PROMPT"):
                self.eat()
                prompt = self.string()
            self.expect_op(")")
            opts = self._with_options()
            pt = PromptTemplate.parse(prompt) if prompt else None
            return PredictExpr(model_name=model, prompt=pt, agg=agg,
                               options=opts)
        # function call or column
        name = self.ident()
        if self.try_op("("):
            args = []
            if not self.try_op(")"):
                if self.try_op("*"):
                    args.append(Lit("*"))
                else:
                    while True:
                        args.append(self._expr())
                        if not self.try_op(","):
                            break
                self.expect_op(")")
            return FuncCall(name.lower(), args)
        return Col(name)


@dataclasses.dataclass
class FuncCall(Expr):
    """Aggregate or scalar function reference (resolved by the planner)."""
    name: str
    args: List[Expr]

    def columns(self):
        out = []
        for a in self.args:
            out.extend(a.columns())
        return out

    def evaluate(self, t):
        raise RuntimeError(f"unresolved function {self.name} at execution")

    def sql_type(self, schema):
        if self.name in ("count",):
            return "INTEGER"
        if self.name in ("sum", "avg"):
            return "DOUBLE"
        if self.args:
            return self.args[0].sql_type(schema)
        return "VARCHAR"


def parse_sql(sql: str):
    """Parse one statement (trailing ';' tolerated)."""
    p = Parser(sql)
    stmt = p.parse()
    if p.peek() is not None and not (p.peek().kind == "op"
                                     and p.peek().text == ";"):
        raise SyntaxError(f"trailing tokens: {p.peek().text!r}")
    return stmt
