"""The flash-attention backward of repro_torch against the JAX package's
hand-written one (``repro.models.layers.flash_attention``'s custom VJP,
``_flash_bwd``), on the same seeded numpy inputs, in float32 on the CPU:

* ``ref.flash_attention_bwd_ref`` (the plain version of the CUDA kernel
  ``flash_attention_bwd.cu``) and ``ref.flash_attention_fwd_ref``'s lse
  against ``jax.vjp`` of the blockwise jnp function: causal, sliding window,
  prefix-LM and bidirectional masks; GQA with G 1, 2, 4 and 8; left pads
  (rows with no visible key); kv longer than q; small blocks;
* the training path's ``ops.flash_attention`` (an autograd.Function when
  grad is on; on the CPU it runs the two plain versions) by
  ``torch.autograd.grad``;
* the rule for a row with no visible key, which differs from autograd
  through the forward, pinned on its own.

Tolerance: 2e-5 absolute and relative (float32 sums in another order than
the jnp einsums; outputs of order 1 to 10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from torch_cases import FLASH_CASES, MASKS, one_torch_thread, prefill_case, t  # noqa: F401

TOL = dict(atol=2e-5, rtol=2e-5)

CASES = {**FLASH_CASES,
         "gqa8": dict(B=1, S=37, H=8, KV=1, D=16, npad=6),
         "gqa4_bidir_pads": dict(B=2, S=20, H=8, KV=2, D=8, npad=4)}


def jax_vjp(q, k, v, qpos, kpos, g, *, causal=True, window=0, prefix_len=0,
            block_q=512, block_kv=1024):
    def f(q_, k_, v_):
        return JL.flash_attention(q_, k_, v_, jnp.asarray(qpos),
                                  jnp.asarray(kpos), causal, window,
                                  prefix_len, block_q, block_kv)
    out, pull = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, (_, _, _, _, _, _, lse) = JL._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
        jnp.asarray(kpos), causal, window, prefix_len, block_q, block_kv)
    return [np.array(x) for x in (out, lse, *pull(jnp.asarray(g)))]


def _case(name, seed=3):
    q, k, v, qpos, kpos = prefill_case(seed, **CASES[name])
    g = np.random.default_rng(seed + 1).standard_normal(q.shape, np.float32)
    return q, k, v, qpos, kpos, g


def _close(got, want):
    torch.testing.assert_close(got, t(want), **TOL)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_jax_vjp(case, mask):
    q, k, v, qpos, kpos, g = _case(case)
    kw = MASKS[mask]
    out_j, lse_j, dq_j, dk_j, dv_j = jax_vjp(q, k, v, qpos, kpos, g, **kw)
    out, lse = ref.flash_attention_fwd_ref(t(q), t(k), t(v), t(qpos),
                                           t(kpos), **kw)
    _close(out, out_j)
    _close(lse, lse_j)
    dq, dk, dv = ref.flash_attention_bwd_ref(t(q), t(k), t(v), t(qpos),
                                             t(kpos), out, lse, t(g), **kw)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        _close(got, want)


@pytest.mark.parametrize("blocks", [(8, 16), (16, 8)])
@pytest.mark.parametrize("mask", ["causal", "window"])
def test_bwd_ref_matches_jax_vjp_small_blocks(mask, blocks):
    """Blocks smaller than the sequence: the JAX forward's lse and the
    backward's dq summed over several kv blocks.  The forward keeps the
    kv block in the divisor of a row with no visible key."""
    block_q, block_kv = blocks
    q, k, v, qpos, kpos, g = _case("pad_rows", seed=9)
    kw = MASKS[mask]
    out_j, lse_j, dq_j, dk_j, dv_j = jax_vjp(q, k, v, qpos, kpos, g,
                                             block_q=block_q,
                                             block_kv=block_kv, **kw)
    out, lse = ref.flash_attention_fwd_ref(t(q), t(k), t(v), t(qpos),
                                           t(kpos), kv_block=block_kv, **kw)
    _close(out, out_j)
    _close(lse, lse_j)
    for got, want in zip(ref.flash_attention_bwd_ref(
            t(q), t(k), t(v), t(qpos), t(kpos), out, lse, t(g), **kw),
            (dq_j, dk_j, dv_j)):
        _close(got, want)


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("case", ["gqa", "pad_rows", "extend_offset"])
def test_training_flash_attention_cpu_autograd_matches_jax(case, mask):
    """ops.flash_attention with inputs that require grad: the autograd
    Function's CPU path (the plain forward and backward)."""
    q, k, v, qpos, kpos, g = _case(case, seed=5)
    kw = MASKS[mask]
    out_j, _, dq_j, dk_j, dv_j = jax_vjp(q, k, v, qpos, kpos, g, **kw)
    qt, kt, vt = (t(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, t(qpos), t(kpos), **kw)
    assert out.grad_fn is not None
    _close(out.detach(), out_j)
    for got, want in zip(torch.autograd.grad(out, (qt, kt, vt), t(g)),
                         (dq_j, dk_j, dv_j)):
        _close(got, want)


def test_serving_call_keeps_the_forward_only_path():
    """Without grad (the serving path) the wrapper returns the plain forward
    with no autograd graph, whatever the inputs require."""
    q, k, v, qpos, kpos, _ = _case("mha")
    qt = t(q).requires_grad_(True)
    with torch.no_grad():
        out = ops.flash_attention(qt, t(k), t(v), t(qpos), t(kpos))
    assert out.grad_fn is None
    torch.testing.assert_close(out, ref.flash_attention_ref(
        t(q), t(k), t(v), t(qpos), t(kpos)), atol=0, rtol=0)


def test_empty_row_gradient_follows_the_jax_backward():
    """A left-pad row sees no key.  Its forward is sum V / n (n: Skv rounded
    up to the kv block), so autograd through the forward would give each
    key's dv dO / n.  The JAX backward gives it dO (P = 1: its lse rounds to
    -1e30), and so does the port; the real rows agree either way."""
    q, k, v, qpos, kpos, g = _case("pad_rows", seed=12)
    out_j, lse_j, dq_j, dk_j, dv_j = jax_vjp(q, k, v, qpos, kpos, g)
    assert (lse_j[qpos < 0] == np.float32(ref.NEG_INF)).all()
    qt, kt, vt = (t(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, t(qpos), t(kpos))
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), t(g))
    _close(dv, dv_j)
    _close(dk, dk_j)
    _close(dq, dq_j)
    # autograd through the plain forward differs on the keys' dv
    qa, ka, va = (t(x).requires_grad_(True) for x in (q, k, v))
    auto = torch.autograd.grad(ref.flash_attention_ref(
        qa, ka, va, t(qpos), t(kpos)), (qa, ka, va), t(g))
    assert (auto[2] - dv).abs().max() > 1e-2
    # ... but not on a batch without pad rows
    g2 = g.copy()
    g2[qpos < 0] = 0.0
    auto = torch.autograd.grad(ref.flash_attention_ref(
        qa, ka, va, t(qpos), t(kpos)), (qa, ka, va), t(g2))
    out = ops.flash_attention(qt, kt, vt, t(qpos), t(kpos))
    mine = torch.autograd.grad(out, (qt, kt, vt), t(g2))
    for a, b in zip(auto, mine):
        torch.testing.assert_close(a, b, **TOL)
