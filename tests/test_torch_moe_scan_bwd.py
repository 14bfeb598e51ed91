"""The plain backward pairs of the grouped matmul and the selective scan
against the JAX functions that the JAX trainer differentiates, on the same
numpy inputs in float32 on the CPU:

* ``ref.gmm_bwd_ref`` (dx, dw) against ``jax.vjp`` of
  ``repro/kernels/ref.py::gmm_ref``: empty experts, rows past the groups'
  sum, one group over 64 rows;
* ``ref.selective_scan_bwd_ref`` from ``ref.selective_scan_fwd_ref``'s
  carries against ``jax.vjp`` of ``repro/models/mamba.py::selective_scan``
  (the chunked scan of the JAX train step): ragged S, N in {4, 8, 16, 32},
  several chunk counts on both sides;
* the MoE block's input and router gradients (and the experts') against
  ``jax.grad`` of ``repro/models/moe.py::moe_block``, with capacity drops;
* the autograd functions over the plain pairs (what ``ops.gmm`` and
  ``ops.selective_scan`` run for CPU tensors with grad on).

Tolerances: 1e-5 of each gradient's largest |value| (fp32 sums in another
order; the JAX scan forms its states by an associative scan).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro.models import mamba as JMB
from repro.models import moe as JMOE
from repro_torch.kernels import ops, ref
from repro_torch.models import moe as TMOE
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_cases import scan_case, t

TOL = 1e-5


def assert_grad_close(got, want, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, atol=TOL * scale, rtol=0,
                               err_msg=name)


# ------------------------------- grouped matmul -------------------------------
GMM_CASES = {
    "empty_experts_rows_past_sum": dict(T=40, M=16, N=24,
                                        gs=[3, 0, 7, 0, 1, 9]),
    "one_group_over_64_rows": dict(T=96, M=32, N=16, gs=[5, 80, 0, 11]),
    "all_rows": dict(T=33, M=24, N=40, gs=[10, 13, 10]),
}


@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_bwd_ref_matches_jax_vjp(case):
    c = GMM_CASES[case]
    T, M, N, gs = c["T"], c["M"], c["N"], np.array(c["gs"], np.int32)
    rng = np.random.default_rng(len(gs) + T)
    x = rng.standard_normal((T, M)).astype(np.float32)
    w = rng.standard_normal((len(gs), M, N)).astype(np.float32)
    dy = rng.standard_normal((T, N)).astype(np.float32)
    # the JAX oracle gives the rows past the sum the last expert's product
    # (jnp.repeat's padding), the port's gmm 0: the JAX side takes no
    # gradient there, and the port's must ignore what it is given there
    live = np.arange(T)[:, None] < gs.sum()
    _, vjp = jax.vjp(lambda a, b: JREF.gmm_ref(a, b, jnp.asarray(gs)),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(np.where(live, dy, 0)))
    dx, dw = ref.gmm_bwd_ref(t(x), t(w), t(gs), t(dy))
    assert_grad_close(dx, jdx, "dx")
    assert_grad_close(dw, jdw, "dw")
    assert not dx[int(gs.sum()):].any()
    assert not dw[gs == 0].any()


def test_gmm_differentiable_on_the_cpu_runs_the_plain_pair():
    rng = np.random.default_rng(3)
    gs = np.array([4, 0, 6], np.int32)
    x = t(rng.standard_normal((12, 8)).astype(np.float32)).requires_grad_()
    w = t(rng.standard_normal((3, 8, 16)).astype(np.float32)).requires_grad_()
    dy = t(rng.standard_normal((12, 16)).astype(np.float32))
    n = ops.gmm.launches, ops.gmm_bwd.launches
    out = ops.gmm(x, w, t(gs))
    dx, dw = torch.autograd.grad(out, (x, w), dy)
    assert (ops.gmm.launches, ops.gmm_bwd.launches) == n
    torch.testing.assert_close(out.detach(), ref.gmm_ref(x.detach(),
                                                         w.detach(), t(gs)))
    want = ref.gmm_bwd_ref(x.detach(), w.detach(), t(gs), dy)
    torch.testing.assert_close(dx, want[0])
    torch.testing.assert_close(dw, want[1])


# ------------------------------- selective scan -------------------------------
SCAN_CASES = [
    # (Bz, S, Di, N, torch chunks, JAX chunk)
    (2, 37, 6, 4, 3, 16),
    (1, 64, 5, 8, 4, 64),
    (2, 23, 4, 16, 1, 8),
    (1, 50, 3, 32, 7, 256),
    (3, 9, 4, 16, 16, 4),
]


@pytest.mark.parametrize("Bz,S,Di,N,chunks,jchunk", SCAN_CASES)
def test_selective_scan_bwd_ref_matches_jax_vjp(Bz, S, Di, N, chunks, jchunk):
    u, dt, A, B, C, D, _ = scan_case(S * N + chunks, Bz, S, Di, N, h0=False)
    dy = np.random.default_rng(S).standard_normal((Bz, S, Di)).astype(
        np.float32)
    h0 = jnp.zeros((Bz, Di, N), jnp.float32)

    def jscan(u, dt, A, B, C, D):
        return JMB.selective_scan(u, dt, A, B, C, D, h0, chunk=jchunk)[0]
    jy, vjp = jax.vjp(jscan, *map(jnp.asarray, (u, dt, A, B, C, D)))
    want = vjp(jnp.asarray(dy))
    y, h, carries = ref.selective_scan_fwd_ref(*map(t, (u, dt, A, B, C, D)),
                                               chunks=chunks)
    assert carries.shape == (Bz, chunks, Di, N)
    assert_grad_close(y, jy, "y")
    got = ref.selective_scan_bwd_ref(*map(t, (u, dt, A, B, C, D)), carries,
                                     t(dy))
    for name, g, w in zip(("du", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert_grad_close(g, w, name)


def test_selective_scan_fwd_ref_carries_are_the_chunk_states():
    u, dt, A, B, C, D, h0 = scan_case(5, 2, 21, 3, 8)
    args = tuple(map(t, (u, dt, A, B, C, D)))
    y, h, carries = ref.selective_scan_fwd_ref(*args, t(h0), chunks=4)
    y1, h1 = ref.selective_scan_ref(*args, t(h0))
    torch.testing.assert_close(y, y1)
    torch.testing.assert_close(h, h1)
    torch.testing.assert_close(carries[:, 0], t(h0))
    for k, (t0, _) in enumerate(ref.scan_chunks(21, 4)):
        if k:      # the state after the first t0 steps
            u0, dt0, A0, B0, C0, D0 = args
            _, hk = ref.selective_scan_ref(u0[:, :t0], dt0[:, :t0], A0,
                                           B0[:, :t0], C0[:, :t0], D0, t(h0))
            torch.testing.assert_close(carries[:, k], hk)


def test_selective_scan_differentiable_on_the_cpu_runs_the_plain_pair():
    u, dt, A, B, C, D, _ = scan_case(7, 2, 12, 4, 8, h0=False)
    leaves = [t(a).requires_grad_() for a in (u, dt, A, B, C, D)]
    dy = t(np.random.default_rng(1).standard_normal((2, 12, 4)).astype(
        np.float32))
    n = ops.selective_scan.launches, ops.selective_scan_bwd.launches
    y, _ = ops.selective_scan(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    assert (ops.selective_scan.launches, ops.selective_scan_bwd.launches) == n
    plain = [a.detach() for a in leaves]
    _, _, carries = ref.selective_scan_fwd_ref(*plain, chunks=1)
    for g, w in zip(got, ref.selective_scan_bwd_ref(*plain, carries, dy)):
        torch.testing.assert_close(g, w)
    with pytest.raises(ValueError, match="h_out"):
        ops.selective_scan(*leaves, h_out=torch.zeros(2, 4, 8))


# --------------------------------- moe block ----------------------------------
def _moe_case(seed, T, M=32, F=48, E=8, skew=0.0):
    """x (T, M) and params; `skew` biases the router towards experts 0..1,
    so that capacity factor 1.0 drops choices."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, M), np.float32)
    router = (rng.standard_normal((M, E)) * 0.5).astype(np.float32)
    router[:, :2] += skew * np.sign(x.mean(0))[:, None]

    def w(*shape):
        return (rng.standard_normal(shape) / shape[1] ** 0.5).astype(
            np.float32)
    return x, {"router": router, "w_gate": w(E, M, F), "w_up": w(E, M, F),
               "w_down": w(E, F, M)}


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf,skew", [(1.0, 2.0), (1.25, 0.0)])
def test_moe_block_gradients_match_jax(cf, skew, groups):
    x, p = _moe_case(0, T=48, skew=skew)
    kw = dict(num_experts=8, top_k=2, capacity_factor=cf, num_groups=groups)
    dy = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(x, p):
        y = JMOE.moe_block(x, p, compute_dtype=jnp.float32, **kw)
        return jnp.sum(y * jnp.asarray(dy))
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    tx = t(x).requires_grad_()
    tp = {k: t(v).requires_grad_() for k, v in p.items()}
    y = TMOE.moe_block(tx, tp, compute_dtype=torch.float32, **kw)
    names = sorted(tp)
    grads = torch.autograd.grad((y * t(dy)).sum(), [tx] + [tp[k]
                                                           for k in names])
    assert_grad_close(grads[0], jgx, "x")
    for name, g in zip(names, grads[1:]):
        assert_grad_close(g, jgp[name], name)
    if skew:       # capacity drops are present: some choice got no slot
        E, K = 8, 2
        C = TMOE.capacity(48 // groups, E, K, cf)
        _, idx = TMOE._route(t(x), t(p["router"]), K)
        counts = torch.stack([torch.bincount(r.flatten(), minlength=E)
                              for r in idx.reshape(groups, -1)])
        assert (counts > C).any()
