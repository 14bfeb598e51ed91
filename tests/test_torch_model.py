"""repro_torch dense-family forward against repro.models.model.forward.

Same weights (the JAX param tree converted with ``params_from_jax``), same
numpy tokens, float32 compute: train, prefill and decode logits must agree
to 1e-4 (absolute, on logits of order 1: the two frameworks sum matmuls in
different orders).  The port-internal consistency checks mirror
tests/test_models.py (prefill + decode == train forward, extend-offset
prefill == one-shot prefill) at the same 2e-2 bound those tests use.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import model as JM
from repro_torch.models import model as TM
from repro_torch.models.params import init_params, params_from_jax
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 1e-4
ARCHS = ["olmo-1b", "yi-6b", "qwen2-7b", "starcoder2-15b"]


def _setup(arch, seed=0):
    jcfg = JC.get_smoke_config(arch).replace(compute_dtype="float32")
    tcfg = TC.get_smoke_config(arch).replace(compute_dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return toks, pos


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("arch", ["qwen2-7b", "starcoder2-15b"])
def test_train_forward_matches_jax(arch):
    """qkv bias (qwen2), GELU MLP + parametric LayerNorm (starcoder2)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    toks, pos = _tokens(jcfg, 2, 20)
    jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks),
                                  "positions": jnp.asarray(pos)}, mode="train")
    tl, _ = TM.forward(tcfg, tp, {"tokens": _t(toks), "positions": _t(pos)},
                       mode="train")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-6b"])
def test_forward_modes_match_jax(arch):
    """Train logits; prefill (left-padded) logits; then decode steps with the
    ring cache (idx mode) — all against the JAX forward on the same cache
    contents."""
    jcfg, tcfg, jp, tp = _setup(arch)
    B, S = 2, 20
    toks, pos = _tokens(jcfg, B, S)
    pos[1, :4] = -1                      # left padding on row 1
    jl, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks),
                                  "positions": jnp.asarray(pos)}, mode="train")
    tl, _ = TM.forward(tcfg, tp, {"tokens": _t(toks), "positions": _t(pos)},
                       mode="train")
    valid = pos >= 0
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               atol=TOL, rtol=TOL)

    jc = JM.init_cache(jcfg, B, 32)
    tc = TM.init_cache(tcfg, B, 32)
    jl, jc = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks),
                                   "positions": jnp.asarray(pos)},
                        mode="prefill", cache=jc, last_only=True)
    tl, tc = TM.forward(tcfg, tp, {"tokens": _t(toks), "positions": _t(pos)},
                        mode="prefill", cache=tc, last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    assert tc["idx"] == int(jc["idx"])
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for step in range(3):
        p = np.full((B, 1), S + step, np.int32)
        jl, jc = JM.forward(jcfg, jp, {"tokens": jnp.asarray(nxt[:, None]),
                                       "positions": jnp.asarray(p)},
                            mode="decode", cache=jc)
        tl, tc = TM.forward(tcfg, tp, {"tokens": _t(nxt[:, None]),
                                       "positions": _t(p)},
                            mode="decode", cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        # cache slots of pad tokens hold unspecified values (never read)
        live = np.asarray(jc["slot_pos"]) >= 0
        np.testing.assert_allclose(tc["k"].numpy()[:, live],
                                   np.asarray(jc["k"])[:, live],
                                   atol=TOL, rtol=TOL)
        nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-6b"])
def test_row_idx_decode_and_extend_prefill_match_jax(arch):
    """The serving engine's paths: prefill of a cached prefix, extend-offset
    prefill of left-padded suffixes, then per-row (row_idx) decode with
    ragged write cursors."""
    jcfg, tcfg, jp, tp = _setup(arch, seed=1)
    B, P, S, lc = 2, 16, 16, 48
    toks, pos = _tokens(jcfg, B, P + S, seed=1)
    jc, tc = JM.init_cache(jcfg, B, lc), TM.init_cache(tcfg, B, lc)
    pre = {"tokens": toks[:, :P], "positions": pos[:, :P]}
    _, jc = JM.forward(jcfg, jp, {k: jnp.asarray(v) for k, v in pre.items()},
                       mode="prefill", cache=jc)
    _, tc = TM.forward(tcfg, tp, {k: _t(v) for k, v in pre.items()},
                       mode="prefill", cache=tc)
    spos = pos[:, P:].copy()
    spos[0, :3] = -1                     # left-padded suffix on row 0
    suf = {"tokens": toks[:, P:], "positions": spos}
    jl, jc = JM.forward(jcfg, jp, {k: jnp.asarray(v) for k, v in suf.items()},
                        mode="prefill", cache=jc, extend_offset=P,
                        last_only=True)
    tl, tc = TM.forward(tcfg, tp, {k: _t(v) for k, v in suf.items()},
                        mode="prefill", cache=tc, extend_offset=P,
                        last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(jc["slot_pos"]))
    row_idx = np.array([P + S, P + S - 5], np.int32)   # ragged cursors
    jc = dict(jc, row_idx=jnp.asarray(row_idx))
    tc = dict(tc, row_idx=_t(row_idx.copy()))
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    for step in range(2):
        p = (row_idx + step)[:, None]
        jl, jc = JM.forward(jcfg, jp, {"tokens": jnp.asarray(nxt[:, None]),
                                       "positions": jnp.asarray(p)},
                            mode="decode", cache=jc)
        tl, tc = TM.forward(tcfg, tp, {"tokens": _t(nxt[:, None]),
                                       "positions": _t(p)},
                            mode="decode", cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_array_equal(tc["row_idx"].numpy(),
                                      np.asarray(jc["row_idx"]))
        np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                      np.asarray(jc["slot_pos"]))
        nxt = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-6b"])
def test_prefill_decode_matches_forward(arch):
    """Port-internal, as tests/test_models.py: prefill S-1 tokens, decode
    the last one == the train-mode forward's last logits."""
    cfg = TC.get_smoke_config(arch)
    B, S = 2, 24
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks, pos = _tokens(cfg, B, S, seed=2)
    full, _ = TM.forward(cfg, params, {"tokens": _t(toks),
                                       "positions": _t(pos)}, mode="train")
    cache = TM.init_cache(cfg, B, S + 8)
    _, cache = TM.forward(cfg, params, {"tokens": _t(toks[:, :S - 1]),
                                        "positions": _t(pos[:, :S - 1])},
                          mode="prefill", cache=cache)
    dec, _ = TM.forward(cfg, params, {"tokens": _t(toks[:, S - 1:]),
                                      "positions": _t(pos[:, S - 1:])},
                        mode="decode", cache=cache)
    err = float((dec[:, 0].float() - full[:, -1].float()).abs().max())
    assert err < 2e-2, f"{arch}: decode/train mismatch {err}"


def test_extend_prefill_matches_full():
    """Chunked prefill with cache extension == one-shot (train) forward."""
    cfg = TC.get_smoke_config("yi-6b")
    B, P, S = 2, 16, 16
    params = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    toks, pos = _tokens(cfg, B, P + S, seed=3)
    full, _ = TM.forward(cfg, params, {"tokens": _t(toks),
                                       "positions": _t(pos)}, mode="train")
    cache = TM.init_cache(cfg, B, P + S + 4)
    _, cache = TM.forward(cfg, params, {"tokens": _t(toks[:, :P]),
                                        "positions": _t(pos[:, :P])},
                          mode="prefill", cache=cache)
    ext, _ = TM.forward(cfg, params, {"tokens": _t(toks[:, P:]),
                                      "positions": _t(pos[:, P:])},
                        mode="prefill", cache=cache, extend_offset=P)
    err = float((ext[:, -1].float() - full[:, -1].float()).abs().max())
    assert err < 2e-2, f"extend mismatch {err}"


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_matches_jax_specs(arch):
    """init_params builds the JAX package's tree (names, shapes), follows
    its std rules, and params_from_jax keeps one compute-dtype copy."""
    cfg = TC.get_smoke_config(arch)
    specs = JM.param_specs(JC.get_smoke_config(arch))
    tp = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = {**tp["layers"], **{k: v for k, v in tp.items() if k != "layers"}}
    want = {**specs["layers"], **{k: v for k, v in specs.items()
                                  if k != "layers"}}
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    for name, x in flat.items():
        is_norm = name.startswith(("ln_", "final_norm"))
        assert x.dtype == (torch.float32 if is_norm else torch.bfloat16), name
    wq = tp["layers"]["attn.wq"].float()
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    if "attn.bq" in tp["layers"]:        # 2-D biases draw like matrices
        assert float(tp["layers"]["attn.bq"].float().std()) > 0
