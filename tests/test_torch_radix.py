"""repro_torch's paged continuous batcher, radix prefix tree, copy-on-write
forks, int8 pages and radix snapshots against the JAX package's.

The olmo-1b smoke config (vocab 259) in float32 on the same weights
(``params_from_jax``) and sampling seed: request texts, samples, errors and
every GenStats counter but the wall time (``cow_copies``, ``kv_bytes``,
``radix_hit_tokens`` included) must be equal.  Warm restarts: the port's
database adopts a snapshot's radix pages when it creates the matching
engine, and a payload written by the JAX engine (head_dim padded to 128
lanes) restores into the port's engine.
"""
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.serving import scheduler as JS
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.core.database import IPDB
from repro_torch.relational.table import Table
from repro_torch.serving import scheduler as TS
from repro_torch.serving.engine import InferenceEngine as TorchEngine
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cases import (assert_pool_baseline, engine_pair, gen_stats,
                         grammar_pair)

PREFIX = "SHARED INSTRUCTION BLOCK: extract the field from the row. " * 3


def _run(eng, sched, grammar, n, *, slots, budget=40, short=None,
         n_samples=1, temperature=0.7, shared_prefix="", in_prompt=PREFIX):
    reqs = [sched.Request(prompt=in_prompt + f"row {i}: " + "x" * (i % 3),
                          grammar=grammar, max_new_tokens=budget,
                          n_samples=n_samples) for i in range(n)]
    if short is not None:
        reqs[short].max_new_tokens = 2   # cannot finish the JSON grammar
    cb = sched.ContinuousBatcher(eng, num_slots=slots)
    done = cb.run(reqs, temperature=temperature, shared_prefix=shared_prefix)
    return [(r.text, r.error, r.samples) for r in done], gen_stats(cb.stats)


def _both(pair, grammar_kw=None, **kw):
    je, te = pair
    jg, tg = grammar_pair(**(grammar_kw or {}))
    a = _run(je, JS, jg, **kw)
    b = _run(te, TS, tg, **kw)
    assert b[0] == a[0]
    assert b[1] == a[1]
    assert_pool_baseline(te)
    return b


@pytest.mark.parametrize("slots", [2, 8])
@pytest.mark.parametrize("mode", ["radix", "exact"])
def test_batcher_paged_matches_jax(mode, slots):
    """radix: prompts that start alike share pages through the tree (the
    instruction is part of every prompt); exact: the caller's shared prefix
    resolves to memo pages once."""
    pair = engine_pair(page_size=16, prefix_cache_mode=mode)
    if mode == "radix":
        _, st = _both(pair, n=7, slots=slots)
        assert st["radix_hit_tokens"] > 0
    else:
        _, st = _both(pair, n=7, slots=slots, shared_prefix=PREFIX,
                      in_prompt="")
        assert st["prefix_hits"] == 0 and st["prefill_tokens"] > 0


def test_batcher_paged_token_budget_eviction_matches_jax():
    out, _ = _both(engine_pair(page_size=16), n=4, slots=2, short=1)
    assert out[1][1] and "budget" in out[1][1]
    assert all(out[i][1] is None for i in (0, 2, 3))


def test_paged_pool_bound_stalls_but_completes():
    """A pinned pool smaller than the slots' demand: refills stall until
    other slots free pages, every request completes, the pool never
    grows, and the answers equal an unbounded engine's."""
    pair = engine_pair(page_size=16, page_pool_pages=26)
    out, _ = _both(pair, n=6, slots=4)
    assert pair[1]._alloc.num_pages == 26
    free, _ = _both(engine_pair(page_size=16), n=6, slots=4)
    assert [o[0] for o in out] == [o[0] for o in free]


def test_paged_pool_growth_matches_jax():
    """Eight slots of distinct prompts outgrow the lazily sized pool (two
    rows' worth of pages): the engine first evicts unused radix leaves, then
    reallocates the pool tensors mid-run; the slots' pages written before
    the growth must survive it."""
    pair = engine_pair(page_size=16)
    out, _ = _both(pair, n=10, slots=8, budget=48,
                   in_prompt="distinct row text that differs per row ")
    for eng in pair:
        assert eng._alloc.num_pages > 2 * eng.num_table_blocks   # it grew
    assert pair[1]._pool["k"].shape[2] == pair[1]._alloc.num_pages


@pytest.mark.parametrize("ps", [16, 64])
def test_fork_samples_cow_match_jax(ps):
    """n_samples 3 at temperature 1.0: siblings fork off the first
    stream's prefill, privatize the shared tail page on their first write
    (cow_copies), and sample the JAX engine's tokens."""
    out, st = _both(engine_pair(page_size=ps), grammar_kw={"max_str": 3},
                    n=3, slots=4, n_samples=3, temperature=1.0)
    assert all(len(o[2]) == 3 for o in out)
    assert st["cow_copies"] > 0
    assert st["prefill_tokens"] > 0


def test_int8_quantize_on_commit_matches_jax():
    """Frozen pages quantize on commit: the first run reads fp pages, the
    repeat reads the int8 shadows (radix hits); texts and the logical
    kv_bytes (frozen pages at 1 byte per element) equal the JAX engine's,
    below the fp engine's."""
    je, te = engine_pair(page_size=16, kv_quant="int8")
    jg, tg = grammar_pair()
    rows = [f"row {i}: value {i * 3}" for i in range(3)]
    for _ in range(2):
        a = je.generate(rows, grammar=jg, shared_prefix=PREFIX,
                        max_new_tokens=24, temperature=0.7)
        b = te.generate(rows, grammar=tg, shared_prefix=PREFIX,
                        max_new_tokens=24, temperature=0.7)
        assert b.texts == a.texts
        assert gen_stats(b.stats) == gen_stats(a.stats)
    assert b.stats.radix_hit_tokens > 0
    assert int(np.sum(te._quant_flags > 0)) > 0
    np.testing.assert_array_equal(te._quant_flags, je._quant_flags)
    frozen = np.flatnonzero(te._quant_flags > 0)
    k = te._pool["k"][:, :, frozen].numpy()
    kq = te._pool["kq"][:, :, frozen].numpy().astype(np.float32)
    ks = te._pool["kscale"][:, :, frozen].numpy()[..., None, None]
    # scale = amax / 127, so rounding is the only error: |k - kq·s| <= s/2
    np.testing.assert_array_less(np.abs(k - kq * ks),
                                 np.broadcast_to(ks * 0.5 + 1e-6, k.shape))
    # the fp pages agree with the JAX engine's to float32 rounding, so an
    # int8 value may sit one step off where k / s lies at a half
    jkq = np.asarray(je._pool["kq"])[:, :, frozen, :, :16]
    assert np.abs(kq - jkq).max() <= 1
    assert np.mean(kq != jkq) < 1e-3
    _both((je, te), n=4, slots=4)      # the batcher over int8 pages
    _, tf = engine_pair(page_size=16)
    tf.generate(rows, grammar=tg, shared_prefix=PREFIX, max_new_tokens=24)
    assert te.kv_peak_bytes < tf.kv_peak_bytes


# ------------------------------- snapshots ------------------------------------
def _cfg(pkg):
    return pkg.get_smoke_config("olmo-1b").replace(vocab_size=259,
                                                   compute_dtype="float32")


def test_radix_snapshot_restore_warms_prefix_tree():
    """Mirror of test_resilience.py's: export_radix_state /
    restore_radix_state on a fresh engine serve repeat prompts from the
    tree with identical outputs; another page size restores nothing."""
    from repro_torch.serving.grammar import Field, JsonGrammar
    mk = lambda ps=32: TorchEngine(_cfg(TC), seed=0, max_len=512,  # noqa: E731
                                   kv_layout="paged", page_size=ps,
                                   device="cpu")
    g = JsonGrammar([Field("x", "INTEGER")])
    rows = [f"row {i}: value {i * 7}" for i in range(4)]
    e1 = mk()
    r1 = e1.generate(rows, grammar=g, shared_prefix=PREFIX,
                     max_new_tokens=24)
    state = e1.export_radix_state()
    assert state is not None and state["entries"]
    e2 = mk()
    assert e2.restore_radix_state(state) > 0
    r2 = e2.generate(rows, grammar=g, shared_prefix=PREFIX,
                     max_new_tokens=24)
    assert r2.texts == r1.texts
    assert r2.stats.radix_hit_tokens > 0     # warm from the restore alone
    assert r2.stats.prefill_tokens < r1.stats.prefill_tokens
    assert mk(ps=64).restore_radix_state(state) == 0


def test_radix_snapshot_from_jax_engine_restores():
    """A payload exported by the JAX engine (pool head_dim padded to 128)
    restores into the port's engine as into a JAX one: same texts and
    stats on the warm run."""
    from repro_torch.models.params import params_from_jax
    import jax
    je1 = JaxEngine(_cfg(JC), seed=0, max_len=256, kv_layout="paged",
                    page_size=16)
    jg, tg = grammar_pair()
    rows = [f"row {i}: value {i * 7}" for i in range(3)]
    je1.generate(rows, grammar=jg, shared_prefix=PREFIX, max_new_tokens=16)
    state = je1.export_radix_state()
    assert state["entries"][0]["k"].shape[-1] == 128
    je2 = JaxEngine(_cfg(JC), je1.params, seed=0, max_len=256,
                    kv_layout="paged", page_size=16)
    te2 = TorchEngine(_cfg(TC), params_from_jax(
        _cfg(TC), jax.tree.map(np.asarray, je1.params), "cpu"), seed=0,
        max_len=256, kv_layout="paged", page_size=16, device="cpu")
    assert te2.restore_radix_state(state) == je2.restore_radix_state(state) > 0
    a = je2.generate(rows, grammar=jg, shared_prefix=PREFIX,
                     max_new_tokens=16, temperature=0.7)
    b = te2.generate(rows, grammar=tg, shared_prefix=PREFIX,
                     max_new_tokens=16, temperature=0.7)
    assert b.texts == a.texts
    assert gen_stats(b.stats) == gen_stats(a.stats)
    assert b.stats.radix_hit_tokens > 0


def test_paged_database_warm_restart_hits_restored_tree(tmp_path):
    """A paged torch IPDB saves a snapshot; the reopened database adopts
    the radix pages when it first builds the engine, so its first query
    (over new rows: no prompt-cache hits) is served from the tree."""
    prompt = ("SELECT name, LLM m (PROMPT '" + PREFIX + "guess the {color "
              "VARCHAR} of {{name}}') AS color FROM ")
    create = ("CREATE LLM MODEL m PATH 'torch:olmo-1b' ON PROMPT OPTIONS { "
              "'kv_layout': 'paged', 'kv_page_size': 16, 'batch_size': 1, "
              "'max_str': 4, 'max_tokens': 48, 'num_slots': 4 }")

    def open_db(table):
        db = IPDB(device="cpu", snapshot_dir=str(tmp_path))
        db.register_table(table, Table.from_rows(
            [{"name": f"{table} {i}"} for i in range(3)]))
        db.sql(create)
        db.set_option("batch_size", 1)
        return db

    cold = open_db("Items")
    r0 = cold.sql(prompt + "Items")
    assert r0.stats.radix_hit_tokens > 0       # rows after the first
    assert cold.save_snapshot() is not None
    cold.close()
    warm = open_db("Fresh")
    assert warm.restored_snapshot is not None and warm._pending_radix
    r1 = warm.sql(prompt + "Fresh")
    assert not warm._pending_radix             # adopted by the new engine
    assert r1.stats.prompt_cache_hits == 0
    assert r1.stats.radix_hit_tokens > r0.stats.radix_hit_tokens
    assert all(isinstance(c, str) for c in r1.table.column("color"))
    plan = warm.explain(prompt + "Fresh")
    assert "kv_layout=paged" in plan and "pool: 0/0" not in plan
    warm.close()


@pytest.mark.parametrize("mode,prefill", [("exact", 4608), ("radix", 432)])
def test_prefix_paging_bench_counts_match_jax(mode, prefill):
    """benchmarks/bench_prefix_paging.py in quick mode (9 rows of three
    few-shot categories, pages of 64, after a warm-up query): the
    exact-string memo prefills 4608 tokens, the radix tree 432.  The port's
    engine reproduces the rows, the prefill and radix-hit counts and the
    peak KV bytes of the JAX engine's run."""
    import jax
    from benchmarks import bench_prefix_paging as BP
    from repro_torch.core.executors import TorchExecutor
    from repro_torch.models.params import params_from_jax
    je = BP._engine(**BP.SYSTEMS[mode])
    te = TorchEngine(_cfg(TC), params_from_jax(
        _cfg(TC), jax.tree.map(np.asarray, je.params), "cpu"), seed=0,
        max_len=1024, page_size=64, device="cpu", **BP.SYSTEMS[mode])

    def torch_db(n, eng):
        db = IPDB(device="cpu")
        for name, rows in (
                ("Items", [{"fewshot": BP.FEWSHOT[i % 3],
                            "name": f"item {i:02d}"} for i in range(n)]),
                ("WarmItems", [{"fewshot": BP.FEWSHOT[i], "name": f"warm {i}"}
                               for i in range(3)])):
            db.register_table(name, Table.from_rows(rows))
        db.register_executor("bench_jax", lambda entry: _configured(
            TorchExecutor(eng), entry))
        db.sql("CREATE LLM MODEL anno PATH 'custom:bench_jax' ON PROMPT "
               "OPTIONS { 'batch_size': 1, 'max_str': 8, 'temperature': 0.0, "
               "'num_slots': 8, 'max_tokens': 64, 'n_samples': 1 }")
        db.set_option("batch_size", 1)
        db.set_option("max_dispatch_calls", 0)
        return db

    out = []
    for eng, make in ((je, BP._db), (te, torch_db)):
        db = make(9, eng)
        db.sql(BP.QUERY.replace("FROM Items", "FROM WarmItems"))
        eng.kv_peak_bytes = 0
        r = db.sql(BP.QUERY)
        out.append((r.table.rows(), r.stats.prefill_tokens,
                    r.stats.radix_hit_tokens, eng.kv_peak_bytes))
        db.close()
    assert out[1] == out[0]
    assert out[1][1] == prefill


def _configured(ex, entry):
    ex.configure(dict(entry.options))
    return ex
