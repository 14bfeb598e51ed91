"""repro_torch's MoE family against the JAX package's.

Same numpy inputs, float32 on the CPU:

* the grouped matmul's plain version (what ``ops.gmm`` runs for CPU
  tensors) against ``repro.kernels.ops.gmm`` in interpret mode and
  ``repro.kernels.ref.gmm_ref`` on tests/test_kernels.py's cases, and the
  rows past the groups' sum;
* ``moe_block`` against the JAX ``moe_block`` (one and two capacity groups,
  drops forced by a skewed router at capacity factor 1.0, identical pad
  rows that take capacity first), and ``moe_block_reference`` against its
  JAX twin; tolerance 1e-5 (sums in another order, values of order 1);
* the forward (train, prefill, decode) of the qwen3-moe-30b-a3b and
  mixtral-8x22b smoke configs (mixtral: sliding window 16) on the same
  weights (``params_from_jax``), logits to 1e-4 as in test_torch_model.py;
* the pad rows of the prefill attention, which the MoE block routes: they
  must equal what the JAX SQL path's attention gives them;
* ``generate`` texts and GenStats on both KV layouts, and SQL rows and
  ExecStats through the two IPDBs, equal to the JAX engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core.database import IPDB as JaxIPDB
from repro.core.executors import JaxExecutor
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.relational.table import Table as JaxTable
from repro_torch.core.database import IPDB as TorchIPDB
from repro_torch.core.executors import TorchExecutor
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.params import params_from_jax
from repro_torch.relational.table import Table as TorchTable
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cases import (engine_pair, gen_stats, grammar_pair, prefill_case,
                         t as _t)

TOL = 1e-5
LOGIT_TOL = 1e-4
MOE_ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x22b"]


# ------------------------------- grouped matmul -------------------------------
def _group_sizes(T, E, seed, total=None):
    """`total` (default T) rows spread over E experts at random."""
    gs = np.zeros(E, np.int32)
    r = np.random.default_rng(seed)
    for _ in range(T if total is None else total):
        gs[r.integers(0, E)] += 1
    return gs


@pytest.mark.parametrize("T,M,N,E,seed", [
    (64, 32, 48, 4, 0), (130, 64, 64, 8, 1), (33, 96, 16, 3, 2),
    (16, 32, 32, 5, 3),
])
def test_gmm_plain_matches_jax(T, M, N, E, seed):
    rng = np.random.default_rng(seed)
    gs = _group_sizes(T, E, seed)
    x = rng.standard_normal((T, M), np.float32)
    w = (rng.standard_normal((E, M, N)) * 0.1).astype(np.float32)
    out = ops.gmm(_t(x), _t(w), _t(gs)).numpy()
    pallas = JOPS.gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                      block_m=16, block_n=16, block_k=32, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(
        out, np.asarray(JREF.gmm_ref(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(gs))), atol=3e-5, rtol=3e-5)


def test_gmm_plain_rows_past_the_groups_are_zero():
    """sum(gs) < T with empty experts: the MoE block's dropped choices sit
    past the sum and must come out 0; every other row is its expert's."""
    rng = np.random.default_rng(4)
    T, M, N, E = 40, 16, 24, 6
    gs = np.array([3, 0, 7, 0, 1, 9], np.int32)          # sum 20 < T
    x = rng.standard_normal((T, M), np.float32)
    w = rng.standard_normal((E, M, N)).astype(np.float32)
    n = ops.gmm.launches
    out = ops.gmm(_t(x), _t(w), _t(gs)).numpy()
    assert ops.gmm.launches == n          # a CPU tensor runs the plain version
    eid = np.repeat(np.arange(E), gs)
    want = np.einsum("tm,tmn->tn", x[:len(eid)], w[eid])
    np.testing.assert_allclose(out[:len(eid)], want, atol=TOL, rtol=TOL)
    assert not out[len(eid):].any()


# --------------------------------- moe block ----------------------------------
def _moe_case(seed, T, M=32, F=48, E=8, skew=0.0, pad=0):
    """x (T, M) and params; `skew` adds a bias towards expert 0..1 to the
    router (drops at capacity factor 1.0); the first `pad` rows are one
    repeated row, as left-pad prefill rows are."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, M), np.float32)
    x[:pad] = x[0]
    router = (rng.standard_normal((M, E)) * 0.5).astype(np.float32)
    router[:, :2] += skew * np.sign(x.mean(0))[:, None]
    def w(*shape):
        return (rng.standard_normal(shape) / shape[1] ** 0.5).astype(
            np.float32)
    return x, {"router": router, "w_gate": w(E, M, F), "w_up": w(E, M, F),
               "w_down": w(E, F, M)}


MOE_CASES = {
    "random": dict(T=48, cf=1.25),
    "skewed_cf1": dict(T=48, cf=1.0, skew=2.0),
    "pad_rows": dict(T=64, cf=1.25, pad=20),
}


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_jax(case, groups):
    c = dict(MOE_CASES[case])
    cf, K, E = c.pop("cf"), 2, 8
    x, p = _moe_case(0, **c)
    kw = dict(num_experts=E, top_k=K, capacity_factor=cf, num_groups=groups)
    want = JMOE.moe_block(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                           p.items()},
                          compute_dtype=jnp.float32, **kw)
    got = TMOE.moe_block(_t(x), {k: _t(v) for k, v in p.items()},
                         compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    if case != "random":     # the forced cases drop (the oracle drops none)
        oracle = TMOE.moe_block_reference(
            _t(x), {k: _t(v) for k, v in p.items()}, num_experts=E, top_k=K)
        assert not np.allclose(got.numpy(), oracle.numpy(), atol=1e-3)


def test_moe_block_without_drops_is_the_reference():
    """With room for every choice, the capacity block equals the dense
    oracle (the JAX models test's check), and both oracles agree."""
    x, p = _moe_case(1, T=24)
    kw = dict(num_experts=8, top_k=2)
    tp = {k: _t(v) for k, v in p.items()}
    got = TMOE.moe_block(_t(x), tp, capacity_factor=8.0,
                         compute_dtype=torch.float32, **kw)
    ref = TMOE.moe_block_reference(_t(x), tp, **kw)
    jref = JMOE.moe_block_reference(jnp.asarray(x), {k: jnp.asarray(v) for
                                                     k, v in p.items()}, **kw)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T,E,K,cf,want", [
    (8, 128, 8, 1.25, 4),       # qwen3-moe's decode tick over 8 slots
    (256, 128, 8, 1.25, 20),    # its 256-token prefill bucket
    (40, 8, 2, 1.25, 16),       # a smoke size
    (1, 4, 2, 1.0, 2),          # capped at Tg·K
])
def test_capacity_matches_jax(T, E, K, cf, want):
    c = JMOE._round_up(int(T * K * cf / E + 0.999), 4)
    assert min(max(4, c), T * K) == want          # moe.py:59-60
    assert TMOE.capacity(T, E, K, cf) == want


# ------------------------- prefill pad rows (routed) --------------------------
@pytest.mark.parametrize("case", ["pad_rows", "extend_offset"])
def test_flash_pad_rows_match_the_jax_sql_path(case):
    """The MoE block routes left-pad rows, so their attention output must be
    the JAX SQL path's (blockwise layers.flash_attention with its default
    1024-key blocks: the sum of V over 1024 keys), not only the valid
    rows'.  The port's blockwise twin pads its last block the same way."""
    q, k, v, qpos, kpos = prefill_case(3, **{
        "pad_rows": dict(B=2, S=48, H=4, KV=2, D=16, npad=13),
        "extend_offset": dict(B=2, S=24, H=4, KV=2, D=16, npad=5,
                              prefix=32)}[case])
    want = np.asarray(JL.flash_attention(*map(jnp.asarray,
                                              (q, k, v, qpos, kpos))))
    got = ops.flash_attention(*map(_t, (q, k, v, qpos, kpos))).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    blk = TL.flash_attention(*map(_t, (q, k, v, qpos, kpos)), block_q=16,
                             block_kv=16).numpy()
    jblk = np.asarray(JL.flash_attention(*map(jnp.asarray,
                                              (q, k, v, qpos, kpos)),
                                         True, 0, 0, 16, 16))
    np.testing.assert_allclose(blk, jblk, atol=TOL, rtol=TOL)


def test_prefix_attention_without_prefix_pad_rows_match_jax():
    """The paged prefill without a radix match: the port calls the flash
    function with kv_block=1, which gives a pad row the JAX
    prefix_suffix_attention's mean over the suffix."""
    q, k, v, qpos, _ = prefill_case(4, B=2, S=40, H=4, KV=2, D=16, npad=9)
    empty = np.zeros((0, 2, 16), np.float32)
    want = np.asarray(JL.prefix_suffix_attention(
        *map(jnp.asarray, (q, empty, empty, k, v, qpos)), 0))
    got = ops.flash_attention(*map(_t, (q, k, v, qpos, qpos)),
                              kv_block=1).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# ---------------------------------- forward -----------------------------------
def _setup(arch, seed=0):
    jcfg = JC.get_smoke_config(arch).replace(compute_dtype="float32")
    tcfg = TC.get_smoke_config(arch).replace(compute_dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                           "cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_modes_match_jax(arch):
    """Train and prefill logits of a batch with a left-padded row (every
    row compared: pads take capacity), then decode steps on the cache —
    mixtral's 20 tokens overflow its 16-slot sliding-window ring."""
    jcfg, tcfg, jp, tp = _setup(arch)
    B, S = 2, 20
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    pos[1] -= 4
    pos[1, :4] = -1
    toks[1, :4] = 0
    batch_j = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}
    batch_t = {"tokens": _t(toks), "positions": _t(pos)}
    jl, _ = JM.forward(jcfg, jp, batch_j, mode="train")
    tl, _ = TM.forward(tcfg, tp, batch_t, mode="train")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)

    jc, tc = JM.init_cache(jcfg, B, 32), TM.init_cache(tcfg, B, 32)
    jl, jc = JM.forward(jcfg, jp, batch_j, mode="prefill", cache=jc)
    tl, tc = TM.forward(tcfg, tp, batch_t, mode="prefill", cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    nxt = pos[:, -1] + 1
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        p = (nxt + step)[:, None].astype(np.int32)
        jl, jc = JM.forward(jcfg, jp, {"tokens": jnp.asarray(tok),
                                       "positions": jnp.asarray(p)},
                            mode="decode", cache=jc)
        tl, tc = TM.forward(tcfg, tp, {"tokens": _t(tok), "positions": _t(p)},
                            mode="decode", cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_moe_forward_num_groups_matches_jax():
    jcfg, tcfg, jp, tp = _setup("qwen3-moe-30b-a3b", seed=1)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks),
                                  "positions": jnp.asarray(pos)},
                       mode="train", num_groups=2)
    tl, _ = TM.forward(tcfg, tp, {"tokens": _t(toks), "positions": _t(pos)},
                       mode="train", num_groups=2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


# ------------------------------ engine and SQL --------------------------------
QWEN = "qwen3-moe-30b-a3b"


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_moe_generate_matches_jax(layout):
    kw = {"kv_layout": "dense"} if layout == "dense" else {"page_size": 16}
    je, te = engine_pair(QWEN, **kw)
    jg, tg = grammar_pair()
    rows = [f"row {i}: " + "detail " * (i % 3) + f"value {i * 7}"
            for i in range(3)]
    for extra in ("", " extended"):
        a = je.generate([r + extra for r in rows], grammar=jg,
                        max_new_tokens=24, temperature=0.7)
        b = te.generate([r + extra for r in rows], grammar=tg,
                        max_new_tokens=24, temperature=0.7)
        assert b.texts == a.texts
        assert gen_stats(b.stats) == gen_stats(a.stats)
    assert gen_stats(te.total) == gen_stats(je.total)


WALL = ("wall_s", "sim_latency_s", "serial_latency_s")
SQL = ("SELECT name, LLM m (PROMPT 'guess the {color VARCHAR} of the "
       "{{kind}} named {{name}}') AS color FROM Items")
BATCHER = ("{ 'batch_size': 1, 'max_str': 6, 'num_slots': 4, "
           "'max_tokens': 48 }")


def _db(db, table_cls, executor_cls, engine, rows):
    db.register_table("Items", table_cls.from_rows(rows))

    def factory(entry):
        ex = executor_cls(engine)
        ex.configure(dict(entry.options))
        return ex

    db.register_executor("local", factory)
    db.sql("CREATE LLM MODEL m PATH 'custom:local' ON PROMPT OPTIONS "
           + BATCHER)
    return db


def _exec_stats(st):
    d = dataclasses.asdict(st)
    for k in WALL:
        d.pop(k)
    return d


@pytest.mark.parametrize("layout", ["dense", "paged_radix"])
def test_moe_sql_rows_and_stats_match_jax(layout):
    """Six rows through the batcher over 4 slots (idle slots at the end
    are routed too), twice: the second run hits the prompt cache."""
    kw = {"kv_layout": "dense"} if layout == "dense" else {"page_size": 16}
    je, te = engine_pair(QWEN, **kw)
    rows = [{"name": f"item {i:02d}", "kind": ("bolt", "nut", "gear")[i % 3]}
            for i in range(6)]
    jdb = _db(JaxIPDB(), JaxTable, JaxExecutor, je, rows)
    tdb = _db(TorchIPDB(device="cpu"), TorchTable, TorchExecutor, te, rows)
    for _ in range(2):
        a, b = jdb.sql(SQL), tdb.sql(SQL)
        assert b.table.rows() == a.table.rows()
        assert _exec_stats(b.stats) == _exec_stats(a.stats)
    assert all(isinstance(c, str) for c in b.table.column("color"))
    if layout == "paged_radix":
        assert te.total.radix_hit_tokens > 0


def test_moe_torch_path_on_cpu_end_to_end():
    """PATH 'torch:qwen3-moe-30b-a3b' resolves to the smoke config (vocab
    259) on the database's device."""
    d = TorchIPDB(device="cpu")
    d.register_table("Items", TorchTable.from_rows(
        [{"name": f"item{i}"} for i in range(3)]))
    d.sql("CREATE LLM MODEL tiny PATH 'torch:qwen3-moe-30b-a3b' ON PROMPT "
          "OPTIONS { 'batch_size': 2, 'max_str': 6 }")
    r = d.sql("SELECT name, LLM tiny (PROMPT 'guess the {color VARCHAR} "
              "of {{name}}') AS color FROM Items")
    assert len(r.table) == 3
    assert all(isinstance(c, str) for c in r.table.column("color"))
    assert r.stats.llm_calls == 2
    eng = next(iter(d._torch_engines.values()))
    assert eng.cfg.family == "moe" and eng.cfg.vocab_size == 259
