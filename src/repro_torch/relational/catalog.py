"""System catalogs: tables, models (paper Table 2), secrets."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.relational.table import Table


@dataclasses.dataclass
class ModelEntry:
    """One row of the model catalog (paper §4.1, Table 2)."""
    name: str
    path: str
    type: str                       # LLM | TABULAR | EMBED
    on_prompt: bool = True
    base_api: Optional[str] = None
    secret: Optional[str] = None
    relation: Optional[str] = None
    input_set: Optional[List[str]] = None
    output_set: Optional[List[Tuple[str, str]]] = None
    options: Dict[str, object] = dataclasses.field(default_factory=dict)


class Catalog:
    def __init__(self):
        self._tables: Dict[str, Table] = {}
        self._models: Dict[str, ModelEntry] = {}
        self._secrets: Dict[str, str] = {}

    # -- tables -------------------------------------------------------------
    def register_table(self, name: str, t: Table) -> None:
        self._tables[name.lower()] = t

    def table(self, name: str) -> Table:
        key = name.lower()
        if key not in self._tables:
            raise KeyError(f"unknown table {name!r}")
        return self._tables[key]

    def has_table(self, name: str) -> bool:
        return name.lower() in self._tables

    def drop_table(self, name: str) -> None:
        self._tables.pop(name.lower(), None)

    @property
    def tables(self) -> List[str]:
        return list(self._tables)

    # -- models -------------------------------------------------------------
    def register_model(self, entry: ModelEntry) -> None:
        self._models[entry.name.lower()] = entry

    def model(self, name: str) -> ModelEntry:
        key = name.lower()
        if key not in self._models:
            raise KeyError(
                f"unknown model {name!r} — run CREATE LLM MODEL first")
        return self._models[key]

    def has_model(self, name: str) -> bool:
        return name.lower() in self._models

    @property
    def models(self) -> List[str]:
        return list(self._models)

    # -- secrets ------------------------------------------------------------
    def register_secret(self, name: str, value: str) -> None:
        self._secrets[name.lower()] = value

    def secret(self, name: str) -> Optional[str]:
        return self._secrets.get(name.lower())
