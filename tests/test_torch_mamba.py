"""repro_torch's ssm and hybrid families against the JAX package's.

Same numpy inputs, float32 on the CPU unless a test says otherwise:

* the selective scan's plain version (what ``ops.selective_scan`` runs for
  CPU tensors) against the JAX package's chunked scan that the SQL path
  runs (``repro.models.mamba.selective_scan``, from a non-zero state), its
  sequential oracle, and the Pallas kernel in interpret mode (from zeros);
  tolerance 1e-5 (the chunked scan sums in another order);
* ``_causal_conv`` and ``mamba_mixer`` (train mode from a carried state,
  and one decode step) against the JAX functions: float32 1e-5; bfloat16
  within two bfloat16 steps (2 ** -6, relative) of values of order 1, as
  both frameworks round every op to bfloat16 but accumulate the matmuls
  in another order;
* the forward (train, left-padded prefill, decode) of the falcon-mamba-7b
  and hymba-1.5b smoke configs (hymba: sliding window 16, which the
  20-token prompt overflows) on the same weights: logits 1e-4, the SSM
  state 1e-5;
* ``generate`` texts and GenStats, the dense batcher with ``n_samples`` 3
  through the two IPDBs (rows and ExecStats), and, for the hybrid without a
  sliding window, the paged layout (radix hits, forks): all equal to the
  JAX engine's;
* what both packages refuse: the paged layout for an attention-free model,
  and a shared-prefix or paged prefill over hymba's sliding window.
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
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.relational.table import Table as JaxTable
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.scheduler import ContinuousBatcher as JaxBatcher
from repro.serving.scheduler import Request as JaxRequest
from repro_torch.core.database import IPDB as TorchIPDB
from repro_torch.core.executors import TorchExecutor
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch.models.params import params_from_jax
from repro_torch.relational.table import Table as TorchTable
from repro_torch.serving.engine import InferenceEngine as TorchEngine
from repro_torch.serving.scheduler import ContinuousBatcher as TorchBatcher
from repro_torch.serving.scheduler import Request as TorchRequest
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cases import (engine_pair, gen_stats, grammar_pair, scan_case,
                         t as _t)

TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 2.0 ** -6
ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
#: hymba's smoke config without its sliding window: the hybrid the paged
#: layout runs (both packages refuse a windowed paged prefill)
NO_WINDOW = (("sliding_window", 0),)


# ------------------------------- selective scan -------------------------------
@pytest.mark.parametrize("Di", [24, 40])
@pytest.mark.parametrize("S", [1, 33, 100])
def test_selective_scan_plain_matches_jax(S, Di):
    u, dt, A, B, C, D, h0 = scan_case(S * Di, 2, S, Di, 8)
    jargs = [jnp.asarray(a) for a in (u, dt, A, B, C, D)]
    y, h = ref.selective_scan_ref(*map(_t, (u, dt, A, B, C, D, h0)))
    for want in (JMB.selective_scan(*jargs, jnp.asarray(h0), chunk=16),
                 JMB.selective_scan_ref(*jargs, jnp.asarray(h0))):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want[1]), atol=TOL,
                                   rtol=TOL)
    y0, h0_ = ops.selective_scan(*map(_t, (u, dt, A, B, C, D)))
    py, ph = JOPS.selective_scan(*jargs, chunk=16, block_d=16,
                                 interpret=True)
    np.testing.assert_allclose(y0.numpy(), np.asarray(py), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(h0_.numpy(), np.asarray(ph), atol=TOL,
                               rtol=TOL)


def test_selective_scan_continues_a_state_in_place():
    """h_out aliasing h0 (the mixer's cache state): a scan over S steps
    equals two scans over its halves, the second from the first's state
    written where it was read; the CPU wrapper counts no launch."""
    u, dt, A, B, C, D, h0 = map(_t, scan_case(9, 2, 30, 24, 8))
    y, h = ops.selective_scan(u, dt, A, B, C, D, h0)
    state = h0.clone()
    n = ops.selective_scan.launches
    ya, out = ops.selective_scan(u[:, :11], dt[:, :11], A, B[:, :11],
                                 C[:, :11], D, state, h_out=state)
    yb, _ = ops.selective_scan(u[:, 11:], dt[:, 11:], A, B[:, 11:],
                               C[:, 11:], D, state, h_out=state)
    assert out is state and ops.selective_scan.launches == n
    torch.testing.assert_close(torch.cat([ya, yb], 1), y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(state, h, atol=TOL, rtol=TOL)


# ------------------------------- conv and mixer -------------------------------
def _mixer_case(seed, Bz=2, S=12, M=32, Di=48, N=8, R=4, K=4):
    """Mixer params scaled as the initializer scales them (normal / sqrt
    of fan-in; A_log log(1..N), D ones, biases small), x, and a non-zero
    carried state."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"in_x": w(M, Di), "in_z": w(M, Di), "conv_w": w(K, Di),
         "conv_b": (0.1 * rng.standard_normal(Di)).astype(np.float32),
         "x_proj": w(Di, R + 2 * N), "dt_proj": w(R, Di),
         "dt_bias": (0.1 * rng.standard_normal(Di)).astype(np.float32),
         "A_log": np.tile(np.log(np.arange(1, N + 1, dtype=np.float32)),
                          (Di, 1)),
         "D": np.ones(Di, np.float32), "out_proj": w(Di, M)}
    x = rng.standard_normal((Bz, S, M)).astype(np.float32)
    conv = rng.standard_normal((Bz, K - 1, Di)).astype(np.float32)
    h = rng.standard_normal((Bz, Di, N)).astype(np.float32)
    return x, p, conv, h, dict(ssm_state_dim=N, dt_rank=R, conv_dim=K)


FP32_LEAVES = ("A_log", "D", "dt_bias")


@pytest.mark.parametrize("mode", ["train", "decode"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_and_mixer_match_jax(dtype, mode):
    """The port keeps A_log, D and dt_bias in fp32 and the other leaves in
    the compute dtype (params_from_jax); the JAX mixer casts at each use."""
    x, p, conv, h, kw = _mixer_case(1)
    if mode == "decode":
        x = x[:, :1]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    jx = jnp.asarray(x).astype(jd)
    tx = _t(x).to(td)

    xc = x @ p["in_x"]                    # the conv's input, (Bz, S, Di)
    jy, jprev = JMB._causal_conv(jnp.asarray(xc).astype(jd),
                                 jnp.asarray(p["conv_w"]).astype(jd),
                                 jnp.asarray(p["conv_b"]).astype(jd),
                                 jnp.asarray(conv))
    ty, tprev = TMB._causal_conv(_t(xc).to(td), _t(p["conv_w"]).to(td),
                                 _t(p["conv_b"]).to(td), _t(conv))
    for got, want in ((ty, jy), (tprev, jprev)):
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)

    jout, jst = JMB.mamba_mixer(
        jx, {k: jnp.asarray(v) for k, v in p.items()}, mode=mode,
        state=JMB.SSMState(jnp.asarray(conv), jnp.asarray(h)), **kw)
    state = TMB.SSMState(_t(conv).clone(), _t(h).clone())
    tp = {k: _t(v) if k in FP32_LEAVES else _t(v).to(td)
          for k, v in p.items()}
    tout, tst = TMB.mamba_mixer(tx, tp, state=state, **kw)   # one path
    assert tst.conv is state.conv and tst.h is state.h     # in place
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    for got, want in ((tst.conv, jst.conv), (tst.h, jst.h)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=tol)


# ---------------------------------- forward -----------------------------------
def _setup(arch, seed=0):
    jcfg = JC.get_smoke_config(arch).replace(compute_dtype="float32")
    tcfg = TC.get_smoke_config(arch).replace(compute_dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                           "cpu")


def _assert_state(tc, jc):
    for k in ("conv", "h"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_forward_modes_match_jax(arch):
    """Train and prefill logits of a batch with a left-padded row (every
    row compared: the pads run through the conv and the scan), the SSM
    state after the prefill, then decode steps on the per-row cursor
    (continuous batching's row_idx) — hymba's 20-token prompt overflows its
    16-slot window ring."""
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

    jc = JM.init_cache(jcfg, B, 32, include_row_idx=True)
    tc = TM.init_cache(tcfg, B, 32, include_row_idx=True)
    assert set(tc) == set(jc)             # no k/v/slot_pos without attention
    jl, jc = JM.forward(jcfg, jp, batch_j, mode="prefill", cache=jc)
    tl, tc = TM.forward(tcfg, tp, batch_t, mode="prefill", cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    _assert_state(tc, jc)
    jc = dict(jc, row_idx=jnp.full((B,), S, jnp.int32))
    tc["row_idx"] = torch.full((B,), S, dtype=torch.int32)
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
        _assert_state(tc, jc)
        np.testing.assert_array_equal(tc["row_idx"].numpy(),
                                      np.asarray(jc["row_idx"]))


# ------------------------------ engine and SQL --------------------------------
ROWS = [f"row {i}: " + "detail " * (i % 3) + f"value {i * 7}"
        for i in range(3)]


@pytest.mark.parametrize("arch,prefix", [
    ("falcon-mamba-7b", ""), ("falcon-mamba-7b", "Answer for this row. "),
    ("hymba-1.5b", "")], ids=["ssm", "ssm_shared_prefix", "hybrid"])
def test_ssm_generate_matches_jax(arch, prefix):
    """Dense layout; with a shared prefix the suffix prefill continues the
    memoised prefix state (its left pads after the prefix), twice: the
    second call hits the memo."""
    je, te = engine_pair(arch, kv_layout="dense")
    jg, tg = grammar_pair()
    for extra in ("", " extended"):
        a = je.generate([r + extra for r in ROWS], grammar=jg,
                        max_new_tokens=24, temperature=0.7,
                        shared_prefix=prefix)
        b = te.generate([r + extra for r in ROWS], grammar=tg,
                        max_new_tokens=24, temperature=0.7,
                        shared_prefix=prefix)
        assert b.texts == a.texts
        assert gen_stats(b.stats) == gen_stats(a.stats)
    assert gen_stats(te.total) == gen_stats(je.total)
    if prefix:
        assert te.total.prefix_hits == 1


WALL = ("wall_s", "sim_latency_s", "serial_latency_s")
SQL = ("SELECT name, LLM m (PROMPT 'guess the {color VARCHAR} of the "
       "{{kind}} named {{name}}') AS color FROM Items")


def _db(db, table_cls, executor_cls, engine, rows, options):
    db.register_table("Items", table_cls.from_rows(rows))

    def factory(entry):
        ex = executor_cls(engine)
        ex.configure(dict(entry.options))
        return ex

    db.register_executor("local", factory)
    db.sql("CREATE LLM MODEL m PATH 'custom:local' ON PROMPT OPTIONS "
           + options)
    return db


def _exec_stats(st):
    d = dataclasses.asdict(st)
    for k in WALL:
        d.pop(k)
    return d


@pytest.mark.parametrize("arch,layout", [
    ("falcon-mamba-7b", "dense"), ("hymba-1.5b", "dense"),
    ("hymba-1.5b", "paged_radix")])
def test_ssm_sql_rows_and_stats_match_jax(arch, layout):
    """Five rows through the batcher over 4 slots with n_samples 3 at
    temperature 0.7 (15 streams: slots refill), twice: the second run hits
    the prompt cache.  Paged (hymba without its window): the streams of a
    row fork copy-on-write off the first one's prefill and SSM state, and
    a refilled slot's prefill continues what its last stream left (the
    JAX batcher's semantics)."""
    if layout == "dense":
        je, te = engine_pair(arch, kv_layout="dense")
    else:
        je, te = engine_pair(arch, config=NO_WINDOW, page_size=16)
    rows = [{"name": f"item {i:02d}", "kind": ("bolt", "nut", "gear")[i % 3]}
            for i in range(5)]
    opts = ("{ 'batch_size': 1, 'max_str': 6, 'num_slots': 4, "
            "'max_tokens': 32, 'n_samples': 3, 'temperature': 0.7 }")
    jdb = _db(JaxIPDB(), JaxTable, JaxExecutor, je, rows, opts)
    tdb = _db(TorchIPDB(device="cpu"), TorchTable, TorchExecutor, te, rows,
              opts)
    for _ in range(2):
        a, b = jdb.sql(SQL), tdb.sql(SQL)
        assert b.table.rows() == a.table.rows()
        assert _exec_stats(b.stats) == _exec_stats(a.stats)
    assert all(isinstance(c, str) for c in b.table.column("color"))
    if layout != "dense":
        assert te.total.radix_hit_tokens > 0 and te.total.cow_copies > 0


def test_hybrid_paged_generate_radix_hits_match_jax():
    """hymba without its window on the paged layout: the second call's rows
    match the first call's pages in the radix tree, so their prefill
    skips those tokens and their SSM state starts from zeros after them —
    the SSM never sees the matched prefix (the JAX engine's semantics,
    pinned here)."""
    je, te = engine_pair("hymba-1.5b", config=NO_WINDOW, page_size=16)
    jg, tg = grammar_pair()
    prompts = ["a long shared instruction that spans pages " * 2 + r
               for r in ROWS]
    for extra in ("", " again"):
        a = je.generate([p + extra for p in prompts], grammar=jg,
                        max_new_tokens=20, temperature=0.7)
        b = te.generate([p + extra for p in prompts], grammar=tg,
                        max_new_tokens=20, temperature=0.7)
        assert b.texts == a.texts
        assert gen_stats(b.stats) == gen_stats(a.stats)
    assert te.total.radix_hit_tokens > 0


def test_hybrid_paged_batcher_forks_match_jax():
    """The paged batcher over 2 slots: 3 requests with n_samples 3 (forks
    copy-on-write, the snapshot's SSM state cloned) and refills."""
    je, te = engine_pair("hymba-1.5b", config=NO_WINDOW, page_size=16)
    jg, tg = grammar_pair()
    out = []
    for eng, batcher, request, g in ((je, JaxBatcher, JaxRequest, jg),
                                     (te, TorchBatcher, TorchRequest, tg)):
        reqs = [request(r, grammar=g, max_new_tokens=20, n_samples=3)
                for r in ROWS]
        done = batcher(eng, num_slots=2).run(reqs, temperature=0.7)
        out.append(([(r.text, r.samples, r.error) for r in done],
                    gen_stats(eng.total)))
    assert out[1] == out[0]
    assert te.total.cow_copies > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_ssm_paths_on_cpu_end_to_end(arch):
    """PATH 'torch:<arch>' resolves to the smoke config (vocab 259) on the
    database's device; both families answer through the dense batcher."""
    d = TorchIPDB(device="cpu")
    d.register_table("Items", TorchTable.from_rows(
        [{"name": f"item{i}"} for i in range(3)]))
    d.sql(f"CREATE LLM MODEL tiny PATH 'torch:{arch}' ON PROMPT "
          "OPTIONS { 'batch_size': 2, 'max_str': 6 }")
    r = d.sql("SELECT name, LLM tiny (PROMPT 'guess the {color VARCHAR} "
              "of {{name}}') AS color FROM Items")
    assert len(r.table) == 3
    assert all(isinstance(c, str) for c in r.table.column("color"))
    assert r.stats.llm_calls == 2
    eng = next(iter(d._torch_engines.values()))
    assert eng.cfg.name == arch and eng.cfg.vocab_size == 259


# --------------------------------- refusals -----------------------------------
def test_paged_layout_refused_without_attention_as_in_jax():
    jcfg = JC.get_smoke_config("falcon-mamba-7b").replace(vocab_size=259)
    tcfg = TC.get_smoke_config("falcon-mamba-7b").replace(vocab_size=259)
    with pytest.raises(AssertionError, match="needs attention"):
        JaxEngine(jcfg, max_len=64, kv_layout="paged")
    with pytest.raises(ValueError, match="needs attention"):
        TorchEngine(tcfg, max_len=64, kv_layout="paged", device="cpu")
    for db, table, path in ((JaxIPDB(), JaxTable, "jax"),
                            (TorchIPDB(device="cpu"), TorchTable, "torch")):
        db.register_table("Items", table.from_rows([{"name": "a"}]))
        db.sql(f"CREATE LLM MODEL m PATH '{path}:falcon-mamba-7b' ON PROMPT "
               "OPTIONS { 'kv_layout': 'paged' }")
        with pytest.raises((AssertionError, ValueError),
                           match="needs attention"):
            db.sql("SELECT LLM m (PROMPT 'the {c VARCHAR} of {{name}}') "
                   "AS c FROM Items")


@pytest.mark.parametrize("case", ["paged", "dense_shared_prefix"])
def test_windowed_hybrid_prefill_refusals_match_jax(case):
    """hymba's sliding window: the paged prefill and the extend-offset
    prefill of a shared prefix assert in both packages."""
    kw = ({"page_size": 16} if case == "paged" else {"kv_layout": "dense"})
    je, te = engine_pair("hymba-1.5b", **kw)
    prefix = "" if case == "paged" else "Answer for this row. "
    for eng in (je, te):
        with pytest.raises(AssertionError):
            eng.generate(ROWS[:2], max_new_tokens=4, shared_prefix=prefix)
