"""repro_torch kernel functions against the JAX package's.

On the CPU the wrappers in ``repro_torch.kernels.ops`` run their plain
PyTorch versions (``repro_torch.kernels.ref``); these are held against
``repro.kernels.ref`` and against the Pallas kernels run with
``interpret=True`` (as tests/test_kernels.py runs them), on the same numpy
inputs.  The Hopper kernels themselves are held against the plain versions
on the card by tests/test_torch_cuda.py.

Tolerances (float32, CPU): attention 2e-5 absolute/relative — the two sides
sum in different orders, a few ulp of values of order 1; sampling is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from torch_cases import (FLASH_CASES, MASKS, decode_case, prefill_case,
                         sample_case, t as _t)
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

TOL = 2e-5


def _fold_q(q, KV):
    B, S, H, D = q.shape
    return q.reshape(B, S, KV, H // KV, D).transpose(0, 2, 3, 1, 4) \
        .reshape(B * KV, H // KV, S, D)


def _fold_kv(k):
    B, S, KV, D = k.shape
    return k.transpose(0, 2, 1, 3).reshape(B * KV, S, D)


def _unfold_o(o, B, KV):
    BK, G, S, D = o.shape
    return o.reshape(B, KV, G, S, D).transpose(0, 3, 1, 2, 4) \
        .reshape(B, S, KV * G, D)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_plain_matches_jax(case, mask):
    c = FLASH_CASES[case]
    q, k, v, qpos, kpos = prefill_case(0, **c)
    kw = MASKS[mask]
    out = ops.flash_attention(_t(q), _t(k), _t(v), _t(qpos), _t(kpos),
                              **kw).numpy()
    B, KV = c["B"], c["KV"]
    r = JREF.flash_attention_ref(
        _fold_q(q, KV), _fold_kv(k), _fold_kv(v), np.repeat(qpos, KV, 0),
        np.repeat(kpos, KV, 0), **kw)
    r = _unfold_o(np.asarray(r), B, KV)
    valid = qpos >= 0            # pad rows have no valid key: never read
    np.testing.assert_allclose(out[valid], r[valid], atol=TOL, rtol=TOL)
    assert np.isfinite(out).all()
    if mask == "causal" and case in ("pad_rows", "extend_offset"):
        # the SQL path's prefills (interpret mode is slow: two cases)
        pallas = np.asarray(JOPS.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
            jnp.asarray(kpos), block_q=16, block_kv=16, interpret=True, **kw))
        np.testing.assert_allclose(out[valid], pallas[valid], atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("case", ["gqa", "pad_rows", "extend_offset"])
def test_blockwise_flash_matches_jax_layers(case):
    """The plain blockwise layers.flash_attention against the JAX jnp twin
    (small blocks, so several q and kv blocks stream)."""
    q, k, v, qpos, kpos = prefill_case(1, **FLASH_CASES[case])
    out = TL.flash_attention(_t(q), _t(k), _t(v), _t(qpos), _t(kpos),
                             block_q=16, block_kv=16).numpy()
    r = np.asarray(JL.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), True, 0, 0, 16, 16))
    valid = qpos >= 0
    np.testing.assert_allclose(out[valid], r[valid], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,H,KV,D,L", [
    (3, 4, 4, 16, 96), (4, 8, 2, 32, 130), (2, 4, 1, 16, 64)])
def test_decode_attention_plain_matches_jax(B, H, KV, D, L):
    q, kc, vc, spos, qpos = decode_case(2, B, H, KV, D, L)
    out = ops.decode_attention(_t(q), _t(kc), _t(vc), _t(spos),
                               _t(qpos)).numpy()
    G = H // KV
    r = JREF.decode_attention_ref(
        q.reshape(B * KV, G, D), _fold_kv(kc), _fold_kv(vc),
        np.repeat(spos, KV, 0), np.repeat(qpos[:, None], KV, 0))
    r = np.asarray(r).reshape(B, H, D)
    np.testing.assert_allclose(out, r, atol=TOL, rtol=TOL)
    if KV < H:                   # interpret mode is slow: the GQA case
        pallas = np.asarray(JOPS.decode_attention(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(spos), jnp.asarray(qpos), block_l=32,
            interpret=True))
        np.testing.assert_allclose(out, pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(
        TL.decode_attention(_t(q), _t(kc), _t(vc), _t(spos), _t(qpos)).numpy(),
        np.asarray(JL.decode_attention(q, kc, vc, spos, qpos)),
        atol=TOL, rtol=TOL)


def _numpy_sampler(logits, mask, noise, temperature):
    """The JAX serving engine's numpy sampler (engine._sample)."""
    x = logits / (temperature if temperature > 0 else 1.0)
    if noise is not None:
        x = x + noise
    x = np.where(mask != 0, x, -1e30)
    return np.argmax(x, axis=-1).astype(np.int32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 0.5, 0.7])
def test_constrained_sample_plain_matches_jax(temperature, ties):
    B, V = 6, 512
    logits, mask, rng = sample_case(3, B, V, ties)
    noise = None
    if temperature > 0:
        u = rng.uniform(1e-9, 1.0, size=(B, V))
        noise = -np.log(-np.log(u))
        if ties:        # gaps of whole units: the noise only breaks ties
            noise = np.round(noise * 4) / 64
    T = temperature if temperature > 0 else 1.0
    out = ops.constrained_sample(_t(logits), _t(mask),
                                 None if noise is None else _t(noise),
                                 temperature=T).numpy()
    np.testing.assert_array_equal(out, _numpy_sampler(logits, mask, noise,
                                                      temperature))
    if T in (1.0, 0.5):
        # the JAX oracle and the Pallas kernel add float32 noise, and the
        # Pallas kernel multiplies by 1/T: with float32 noise values and an
        # exact 1/T all three pick the same tokens
        n32 = np.zeros((B, V), np.float32) if noise is None \
            else noise.astype(np.float32)
        port = ops.constrained_sample(
            _t(logits), _t(mask),
            None if noise is None else _t(n32.astype(np.float64)),
            temperature=T).numpy()
        r = np.asarray(JREF.constrained_sample_ref(logits, mask, n32,
                                                   temperature=T))
        pallas = np.asarray(JOPS.constrained_sample(
            jnp.asarray(logits), jnp.asarray(mask), jnp.asarray(n32),
            temperature=T, block_v=128, interpret=True))
        np.testing.assert_array_equal(port, r)
        np.testing.assert_array_equal(port, pallas)


def test_sampler_divides_by_temperature_like_numpy():
    """Adjacent float32 logits whose quotients by T differ but whose
    products with 1/T round equal: dividing picks the larger logit,
    multiplying would tie and pick index 0.  The engine's numpy sampler
    divides, so the port must too."""
    T = np.float32(0.7)
    lo = np.float32(6.0504184)
    hi = np.nextafter(lo, np.float32(np.inf))
    assert lo / T != hi / T and lo * (np.float32(1) / T) == hi * (
        np.float32(1) / T)
    logits = np.array([[lo, hi]], np.float32)
    mask = np.ones((1, 2), np.int8)
    assert _numpy_sampler(logits, mask, None, 0.7)[0] == 1
    assert ops.constrained_sample(_t(logits), _t(mask),
                                  temperature=0.7).numpy()[0] == 1


def test_sampler_ties_pick_lowest_index():
    logits = np.zeros((2, 300), np.float32)
    logits[0, [7, 100, 250]] = 5.0
    mask = np.ones((2, 300), np.int8)
    mask[1, :50] = 0
    out = ops.constrained_sample(_t(logits), _t(mask)).numpy()
    np.testing.assert_array_equal(out, [7, 50])


def test_cpu_wrappers_run_plain_and_count_nothing():
    ops.reset_launches()
    q, k, v, qpos, kpos = prefill_case(4, **FLASH_CASES["gqa"])
    ops.flash_attention(_t(q), _t(k), _t(v), _t(qpos), _t(kpos))
    assert {n: w.launches for n, w in ops.WRAPPERS.items()} == \
        {n: 0 for n in ops.WRAPPERS}
