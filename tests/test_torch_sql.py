"""One semantic SQL query through the JAX package and through repro_torch.

The same query runs through ``repro.core.database.IPDB`` with a ``custom:``
JaxExecutor and through ``repro_torch.core.database.IPDB`` with a ``custom:``
TorchExecutor, on the same float32 weights (``params_from_jax``) and the
same sampling seed.  Result rows and every ExecStats counter must be equal;
only the wall-clock fields (wall_s, sim_latency_s, serial_latency_s — the
JAX/Torch executors report wall time as latency) are left out.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.core.database import IPDB as JaxIPDB
from repro.core.executors import JaxExecutor
from repro.relational.table import Table as JaxTable
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.core.database import IPDB as TorchIPDB
from repro_torch.core.executors import TorchExecutor
from repro_torch.models.params import params_from_jax
from repro_torch.relational.table import Table as TorchTable
from repro_torch.serving.engine import InferenceEngine as TorchEngine
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

WALL = ("wall_s", "sim_latency_s", "serial_latency_s")
ROWS = [{"name": f"item {i:02d}", "kind": ("bolt", "nut", "gear")[i % 3]}
        for i in range(10)]
QUERY = ("SELECT name, LLM m (PROMPT 'guess the {color VARCHAR} of the "
         "{{kind}} named {{name}}') AS color FROM Items")


@pytest.fixture(scope="module")
def _engine_pair():
    jcfg = JC.get_smoke_config("olmo-1b").replace(vocab_size=259,
                                                 compute_dtype="float32")
    tcfg = TC.get_smoke_config("olmo-1b").replace(vocab_size=259,
                                                 compute_dtype="float32")
    je = JaxEngine(jcfg, max_len=256, seed=0)
    te = TorchEngine(tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray,
                                                              je.params),
                                           "cpu"),
                     max_len=256, seed=0, device="cpu")
    return je, te


@pytest.fixture
def engines(_engine_pair):
    """The module's engine pair, put back to a fresh sampling state."""
    for eng in _engine_pair:
        eng._rng = np.random.default_rng(0)
    return _engine_pair


def _db(db, table_cls, executor_cls, engine, options, rows):
    db.register_table("Items", table_cls.from_rows(rows))

    def factory(entry):
        ex = executor_cls(engine)
        ex.configure(dict(entry.options))
        return ex

    db.register_executor("local", factory)
    db.sql("CREATE LLM MODEL m PATH 'custom:local' ON PROMPT OPTIONS "
           + options)
    return db


def _stats(st):
    d = dataclasses.asdict(st)
    for k in WALL:
        d.pop(k)
    return d


@pytest.mark.parametrize("path,nrows,options", [
    # every row in one dispatch → one ContinuousBatcher.run over 4 slots
    ("batcher", 10, "{ 'batch_size': 1, 'max_str': 6, 'num_slots': 4, "
                    "'max_tokens': 48 }"),
    # one row per dispatch → InferenceEngine.generate
    ("generate", 1, "{ 'batch_size': 1, 'max_str': 6, 'max_tokens': 48 }"),
    # three rows marshaled into each prompt, two prompts batched, greedy
    ("marshaled", 6, "{ 'batch_size': 3, 'max_str': 4, 'max_tokens': 96, "
                     "'temperature': 0.0 }"),
], ids=["batcher", "generate", "marshaled"])
def test_sql_rows_and_stats_match_jax(engines, path, nrows, options):
    je, te = engines
    jdb = _db(JaxIPDB(), JaxTable, JaxExecutor, je, options, ROWS[:nrows])
    tdb = _db(TorchIPDB(device="cpu"), TorchTable, TorchExecutor, te,
              options, ROWS[:nrows])
    for _ in range(2):               # the second run hits the prompt cache
        a = jdb.sql(QUERY)
        b = tdb.sql(QUERY)
        assert b.table.rows() == a.table.rows()
        assert _stats(b.stats) == _stats(a.stats)
    assert all(isinstance(c, str) for c in b.table.column("color"))
    assert b.stats.prompt_cache_hits > 0


def test_torch_path_on_cpu_end_to_end():
    """PATH 'torch:olmo-1b' resolves to an in-process engine on the
    database's device (mirrors test_system.py's jax:olmo-1b test)."""
    d = TorchIPDB(device="cpu")
    d.register_table("Items", TorchTable.from_rows(
        [{"name": f"item{i}"} for i in range(3)]))
    d.sql("CREATE LLM MODEL tiny PATH 'torch:olmo-1b' ON PROMPT "
          "OPTIONS { 'batch_size': 2, 'max_str': 6 }")
    r = d.sql("SELECT name, LLM tiny (PROMPT 'guess the {color VARCHAR} "
              "of {{name}}') AS color FROM Items")
    assert len(r.table) == 3
    assert all(isinstance(c, str) for c in r.table.column("color"))
    assert r.stats.llm_calls == 2          # ceil(3 unique / batch 2)
    assert r.stats.prefill_tokens > 0 and r.stats.decode_tokens > 0
    assert "kv_layout=dense" in d.explain("SELECT name FROM Items")


def test_jax_path_is_refused():
    d = TorchIPDB(device="cpu")
    d.register_table("Items", TorchTable.from_rows([{"name": "a"}]))
    d.sql("CREATE LLM MODEL j PATH 'jax:olmo-1b' ON PROMPT")
    with pytest.raises(ValueError, match="torch:<arch>"):
        d.sql("SELECT LLM j (PROMPT 'the {c VARCHAR} of {{name}}') AS c "
              "FROM Items")
