"""A whole run of a cell on the CPU at a small size, past the harness's
look for a chip, with the timed path broken underneath: `correct` has to
come out false for each fault the cell can have, and true without one.

The sizes are the configurations' small variants (2 layers, width 64) and
a small mix (8 rows a query, 4 a call, 2 slots, strings of 4 bytes);
the limits set for that size (``checks/<cell>.json``, ``small_limits``)
judge them.
"""
import json
import time

import pytest
import torch

from ipdb_bench.harness import bench

SMALL_MODEL = {
    "dense": dict(num_layers=2, d_model=64, vocab_size=288, num_heads=4,
                  num_kv_heads=4, head_dim=16, d_ff=96),
    "ssm": dict(num_layers=2, d_model=64, vocab_size=288, ssm_state=8),
}
SMALL_SQL = {"rows_per_query": 8,
             "warmup": {"calls": 1, "new_tokens": 2},
             "options": {"batch_size": 4, "num_slots": 2, "temperature": 0,
                         "max_str": 4, "max_tokens": 1024}}
SQL_CELLS = ("olmo-1b.sql-topic-dense", "falcon-mamba-7b.sql-topic-dense",
             "olmo-1b.sql-fewshot-paged")


def small(cell: bench.Cell) -> dict:
    traffic = dict(SMALL_SQL)
    eng = dict(cell.traffic["engine"], max_len=1024)
    traffic["engine"] = eng
    if cell.traffic.get("fewshot_bytes"):
        traffic["fewshot_bytes"] = 300
    return {"model": SMALL_MODEL[cell.config["model"]["family"]],
            "traffic": traffic, "limits": cell.checks["small_limits"]}


@pytest.fixture(autouse=True)
def few_threads():
    """Small runs on two threads: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size runs on the "
                    "card")


def execute_small(name: str, fault=None, seed: int = 2**31 + 99,
                  trace: bool = False):
    cell = bench.Cell(name)
    run = bench.Run(cell, seed, 0.0, trace, torch.device("cpu"),
                    time.perf_counter(), override=small(cell), fault=fault)
    return bench.execute(run)


# -- faults, each planted after set-up, on the timed path ----------------
def altered_token(engine):
    """The sampler serves the allowed token with the lowest logit, once in
    a while: a token altered where it is produced."""
    sample, calls = engine._sample, [0]

    def bad(logits, gs, states, temperature):
        toks = sample(logits, gs, states, temperature)
        calls[0] += 1
        if calls[0] % 7 == 3:
            for i, (g, st) in enumerate(zip(gs, states)):
                if g is not None:
                    m = torch.as_tensor(g.mask(st)[:logits.shape[1]],
                                        dtype=torch.bool)
                    if int(m.sum()) > 1:
                        row = logits[i, :m.shape[0]].float()
                        toks[i] = int(row.masked_fill(~m, float("inf"))
                                      .argmin())
        return toks
    engine._sample = bad


def stale_state(engine):
    """Each decode step reads the cache and returns it unchanged: the
    step's writes go to a copy (dense), or are undone (the page pool)."""
    if engine.kv_layout == "paged":
        paged = engine.paged_decode

        def undone(*a, **k):
            saved = {n: t.clone() for n, t in engine._pool.items()}
            out = paged(*a, **k)
            for n, t in saved.items():
                engine._pool[n].copy_(t)
            return out
        engine.paged_decode = undone
        return
    step = engine.decode_step

    def bad(toks, positions, cache):
        copy = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in cache.items()}
        logits, _ = step(toks, positions, copy)
        return logits, cache
    engine.decode_step = bad


def half_batch(engine):
    """The batcher serves half of each call's requests; the others come
    back without an answer."""
    from repro_torch.serving.scheduler import ContinuousBatcher
    run = ContinuousBatcher.run

    def bad(self, requests, **kw):
        reqs = list(requests)
        keep = reqs[: max(1, len(reqs) // 2)]
        run(self, keep, **kw)
        for r in reqs[len(keep):]:
            r.text, r.error = None, "left out"
        return reqs
    engine._restore = (ContinuousBatcher, "run", run, bad)
    ContinuousBatcher.run = bad


def altered_answer(engine):
    """One answer in each result changed after the engine produced it."""
    from repro_torch.core.executors import TorchExecutor
    many = TorchExecutor.complete_many

    def bad(self, *a, **k):
        out = many(self, *a, **k)
        out[0].text = out[0].text.replace('"topic": "', '"topic": "Z', 1)
        return out
    engine._restore = (TorchExecutor, "complete_many", many, bad)
    TorchExecutor.complete_many = bad


@pytest.mark.parametrize("name", SQL_CELLS)
def test_sound_run_is_correct(name):
    res = execute_small(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 8
    assert res["metrics"]["rows_per_s"]["value"] > 0


@pytest.mark.parametrize("name", SQL_CELLS)
def test_traced_run_wraps_each_kernel_metric_of_the_cell(name):
    """A traced run installs the wrapper that each of the cell's kernel
    metrics names in its file, counts its calls, and reads the span
    metrics; the CPU has no device events, so the rooflines stay out."""
    cell = bench.Cell(name)
    kernel = {n for n in cell.per_layer()
              if hasattr(bench.metric_module(n), "WRAPS")}
    res = execute_small(name, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["reading"]["kernels"]) == kernel
    assert all(c.calls > 0 for c in res["reading"]["kernels"].values())
    assert {"sql.self_pct", "batcher.occupancy_pct", "engine.prefill_pct",
            "engine.sample_ms", "model.tick_ms"} <= set(res["metrics"])
    assert not kernel & set(res["metrics"])


@pytest.mark.parametrize("fault", [altered_token, stale_state, half_batch,
                                   altered_answer],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", SQL_CELLS)
def test_planted_fault_is_not_correct(name, fault):
    planted = []

    def plant(engine):
        fault(engine)
        planted.append(engine)
    try:
        res = execute_small(name, fault=plant)
    finally:
        for eng in planted:            # a class-level fault, if still on
            owner, attr, old, bad = getattr(eng, "_restore", (None,) * 4)
            if owner is not None and owner.__dict__[attr] is bad:
                setattr(owner, attr, old)
    assert planted and not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("olmo-1b.sql-topic-dense",
                                  "falcon-mamba-7b.sql-topic-dense"))
def test_stale_state_is_not_correct_at_the_cells_size(card, name):
    """A decode step that leaves its cache or SSM state unchanged, at the
    cell's own size and limits (falcon-mamba-7b's compare logit_gap alone),
    on three seeds, each a one-query window; the numbers are printed."""
    cell = bench.Cell(name)
    for i, seed in enumerate((2**31 + 17, 2**31 + 18, 2**31 + 19)):
        over = {} if i == 0 else {
            "traffic": {"warmup": {"calls": 0, "new_tokens": 0}}}
        run = bench.Run(cell, seed, 0.0, False, torch.device("cuda"),
                        time.perf_counter(), override=over, fault=stale_state)
        res = bench.execute(run)
        print(json.dumps({"cell": name, "seed": seed,
                          "correct": res["correct"], **res["numbers"]}))
        assert not res["correct"], res["checks"]
