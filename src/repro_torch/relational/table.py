"""Columnar in-memory tables (DuckDB-analog storage layer).

Columns are numpy arrays: numeric dtypes for INTEGER/DOUBLE/BOOLEAN, object
arrays of python str (or None) for VARCHAR/DATETIME. NULL = None (object
cols) / np.nan (DOUBLE) / sentinel-masked (INTEGER uses a parallel validity
convention: NULL stored as the masked `None` in object form only when the
column was produced by a failed prediction — predict outputs promote
INTEGER→float with nan for missing).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

SQL_TYPES = ("VARCHAR", "INTEGER", "DOUBLE", "BOOLEAN", "DATETIME")


def _np_for(sql_type: str):
    t = sql_type.upper()
    if t == "INTEGER":
        return np.int64
    if t == "DOUBLE":
        return np.float64
    if t == "BOOLEAN":
        return np.bool_
    return object              # VARCHAR / DATETIME


@dataclasses.dataclass
class Column:
    name: str
    type: str


class Table:
    def __init__(self, columns: Dict[str, np.ndarray],
                 schema: Optional[Dict[str, str]] = None):
        self.cols: Dict[str, np.ndarray] = {}
        self.schema: Dict[str, str] = {}
        n = None
        for k, v in columns.items():
            a = np.asarray(v)
            if n is None:
                n = len(a)
            assert len(a) == n, f"ragged column {k}"
            self.cols[k] = a
            if schema and k in schema:
                self.schema[k] = schema[k].upper()
            else:
                self.schema[k] = _infer_type(a)
        self._n = n or 0

    # -- construction -----------------------------------------------------
    @staticmethod
    def from_rows(rows: Sequence[dict], schema: Optional[Dict[str, str]] = None
                  ) -> "Table":
        if not rows:
            return Table({k: np.array([], dtype=_np_for(t))
                          for k, t in (schema or {}).items()}, schema)
        keys = list(rows[0].keys())
        cols = {}
        for k in keys:
            vals = [r.get(k) for r in rows]
            t = (schema or {}).get(k) or _infer_type_vals(vals)
            cols[k] = _coerce(vals, t)
        return Table(cols, schema or {k: _infer_type_vals([r.get(k) for r in rows])
                                      for k in keys})

    # -- basics -------------------------------------------------------------
    def __len__(self) -> int:
        return self._n

    @property
    def num_rows(self) -> int:
        return self._n

    @property
    def column_names(self) -> List[str]:
        return list(self.cols.keys())

    def column(self, name: str) -> np.ndarray:
        return self.cols[name]

    def row(self, i: int) -> dict:
        return {k: _pyval(v[i]) for k, v in self.cols.items()}

    def rows(self) -> List[dict]:
        return [self.row(i) for i in range(self._n)]

    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.cols[n] for n in names},
                     {n: self.schema[n] for n in names})

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self.cols.items()},
                     {mapping.get(k, k): t for k, t in self.schema.items()})

    def take(self, idx: np.ndarray) -> "Table":
        return Table({k: v[idx] for k, v in self.cols.items()}, dict(self.schema))

    def mask(self, m: np.ndarray) -> "Table":
        return self.take(np.nonzero(np.asarray(m, bool))[0])

    def with_column(self, name: str, values: np.ndarray, sql_type: str) -> "Table":
        cols = dict(self.cols)
        sch = dict(self.schema)
        cols[name] = _coerce(list(values), sql_type) \
            if not isinstance(values, np.ndarray) else values
        sch[name] = sql_type.upper()
        return Table(cols, sch)

    def concat(self, other: "Table") -> "Table":
        assert self.column_names == other.column_names
        return Table({k: np.concatenate([self.cols[k], other.cols[k]])
                      for k in self.cols}, dict(self.schema))

    def slice(self, start: int, stop: int) -> "Table":
        return Table({k: v[start:stop] for k, v in self.cols.items()},
                     dict(self.schema))

    def head_repr(self, n: int = 8) -> str:
        names = self.column_names
        lines = [" | ".join(names)]
        for i in range(min(n, self._n)):
            lines.append(" | ".join(str(_pyval(self.cols[c][i]))[:40]
                                    for c in names))
        lines.append(f"({self._n} rows)")
        return "\n".join(lines)

    def __repr__(self):
        return f"Table({self.column_names}, rows={self._n})"


def _pyval(x):
    if isinstance(x, np.generic):
        return x.item()
    return x


def _infer_type(a: np.ndarray) -> str:
    if a.dtype == np.bool_:
        return "BOOLEAN"
    if np.issubdtype(a.dtype, np.integer):
        return "INTEGER"
    if np.issubdtype(a.dtype, np.floating):
        return "DOUBLE"
    return "VARCHAR"


def _infer_type_vals(vals) -> str:
    for v in vals:
        if v is None:
            continue
        if isinstance(v, bool):
            return "BOOLEAN"
        if isinstance(v, int):
            return "INTEGER"
        if isinstance(v, float):
            return "DOUBLE"
        return "VARCHAR"
    return "VARCHAR"


def _coerce(vals: list, sql_type: str) -> np.ndarray:
    t = sql_type.upper()
    if t == "INTEGER":
        if any(v is None for v in vals):
            return np.array([np.nan if v is None else float(v) for v in vals])
        return np.array([int(v) for v in vals], np.int64)
    if t == "DOUBLE":
        return np.array([np.nan if v is None else float(v) for v in vals],
                        np.float64)
    if t == "BOOLEAN":
        return np.array([bool(v) for v in vals], np.bool_)
    return np.array([None if v is None else str(v) for v in vals], object)
