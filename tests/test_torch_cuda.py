"""The Hopper kernels of repro_torch against their plain PyTorch versions,
on the card.  Every test is marked ``cuda`` and skips without a GPU: a CUDA
kernel has no interpret mode.  The file imports no jax, so it runs on a GPU
machine without the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Tolerances: float32 1e-5 (the kernel sums in another order than the plain
einsum); bfloat16 2e-2 (inputs and outputs rounded to 8 mantissa bits).
Sampling is exact.  The int8 page variants dequantize exactly as their
plain versions do, so they keep the same tolerances.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from torch_cases import (FLASH_CASES, MASKS, decode_case, paged_case,
                         prefill_case, prefix_case, quantize_pool, sample_case,
                         t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the Hopper kernels have "
                    "no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    q, k, v, qpos, kpos = (t(a).to(cuda) for a in
                           prefill_case(5, **FLASH_CASES[case]))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    for kw in MASKS.values():
        n = ops.flash_attention.launches
        out = ops.flash_attention(q, k, v, qpos, kpos, **kw)
        assert ops.flash_attention.launches == n + 1
        r = ref.flash_attention_ref(q, k, v, qpos, kpos, **kw)
        valid = qpos >= 0
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(out[valid].float(), r[valid].float(),
                                   atol=tol, rtol=tol)
        assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_long_gqa(cuda, dtype):
    """yi-6b's full head layout (32 query heads on 4 kv heads, D=128) over
    a 300-token left-padded prompt: many kv tiles, G=8."""
    q, k, v, qpos, kpos = (t(a).to(cuda) for a in prefill_case(
        8, B=2, S=300, H=32, KV=4, D=128, npad=37))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out = ops.flash_attention(q, k, v, qpos, kpos)
    r = ref.flash_attention_ref(q, k, v, qpos, kpos)
    valid = qpos >= 0
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out[valid].float(), r[valid].float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,D,L", [(8, 16, 4, 128, 300),
                                        (8, 16, 16, 128, 512),
                                        (3, 32, 4, 128, 77),
                                        (2, 4, 4, 16, 64)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, B, H, KV, D, L):
    q, kc, vc, spos, qpos = (t(a).to(cuda) for a in
                             decode_case(6, B, H, KV, D, L))
    q, kc, vc = (x.to(dtype) for x in (q, kc, vc))
    out = ops.decode_attention(q, kc, vc, spos, qpos)
    r = ref.decode_attention_ref(q, kc, vc, spos, qpos)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_constrained_sample_kernel_matches_plain(cuda, temperature):
    logits, mask, rng = sample_case(7, 8, 50432, ties=False)
    noise = None
    if temperature > 0:
        noise = t(-np.log(-np.log(rng.uniform(1e-9, 1.0, (8, 50432))))).to(cuda)
    T = temperature if temperature > 0 else 1.0
    lg, mk = t(logits).to(cuda), t(mask).to(cuda)
    out = ops.constrained_sample(lg, mk, noise, temperature=T)
    r = ref.constrained_sample_ref(lg, mk, noise, temperature=T)
    assert torch.equal(out, r)


@pytest.mark.cuda
def test_constrained_sample_kernel_divides_by_temperature(cuda):
    """The kernel divides by T as the engine's numpy sampler does (see
    test_torch_kernels.py): these adjacent logits flip under 1/T."""
    lo = np.float32(6.0504184)
    logits = t(np.array([[lo, np.nextafter(lo, np.float32(np.inf))]],
                        np.float32)).to(cuda)
    mask = torch.ones((1, 2), dtype=torch.int8, device=cuda)
    assert ops.constrained_sample(logits, mask, temperature=0.7).item() == 1


def _quant(kp, vp, cuda):
    kq, ks, flags = quantize_pool(kp)
    vq, vs, _ = quantize_pool(vp)
    return {"kq": t(kq).to(cuda), "vq": t(vq).to(cuda),
            "kscale": t(ks).to(cuda), "vscale": t(vs).to(cuda),
            "flags": t(flags).to(cuda)}


PAGED_CASES = [dict(B=8, H=16, KV=16, D=128, ps=64, NB=8, P=80, shared=2),
               dict(B=3, H=8, KV=2, D=64, ps=16, NB=6, P=24, shared=1),
               dict(B=2, H=4, KV=4, D=16, ps=32, NB=4, P=9, shared=0)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
def test_decode_attention_paged_kernel_matches_plain(cuda, case, dtype,
                                                     quant):
    c = PAGED_CASES[case]
    q, kp, vp, table, qpos = paged_case(9, **c)
    qd = _quant(kp, vp, cuda) if quant else None
    q, kpd, vpd = (t(a).to(cuda).to(dtype) for a in (q, kp, vp))
    table, qpos = t(table).to(cuda), t(qpos).to(cuda)
    if quant:
        fn, w = ops.decode_attention_paged_quant, "decode_attention_paged_quant"
        out = fn(q, kpd, vpd, table, qpos, qd)
        r = ref.decode_attention_paged_ref(q, kpd, vpd, table, qpos, qd)
    else:
        w = "decode_attention_paged"
        n = ops.decode_attention_paged.launches
        out = ops.decode_attention_paged(q, kpd, vpd, table, qpos)
        assert ops.decode_attention_paged.launches == n + 1
        r = ref.decode_attention_paged_ref(q, kpd, vpd, table, qpos)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol,
                               msg=w)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D,ps,P,npre,plen", [
    (1, 256, 16, 16, 128, 64, 12, 3, None),     # the SQL path's shape
    (3, 40, 8, 2, 32, 16, 10, 4, 50),           # a partial last page
    (2, 33, 4, 4, 16, 32, 5, 0, None),          # no prefix
])
def test_flash_attention_prefix_kernel_matches_plain(cuda, dtype, quant, B,
                                                     S, H, KV, D, ps, P, npre,
                                                     plen):
    q, k, v, pos, kp, vp, ptab, plen = prefix_case(10, B, S, H, KV, D, ps, P,
                                                   npre, plen)
    qd = _quant(kp, vp, cuda) if quant else None
    q, k, v, kpd, vpd = (t(a).to(cuda).to(dtype) for a in (q, k, v, kp, vp))
    pos, ptab = t(pos).to(cuda), t(ptab).to(cuda)
    n = ops.flash_attention_prefix.launches
    out = ops.flash_attention_prefix(q, k, v, pos, kpd, vpd, ptab, plen, qd)
    assert ops.flash_attention_prefix.launches == n + 1
    r = ref.flash_attention_prefix_ref(q, k, v, pos, kpd, vpd, ptab, plen, qd)
    valid = pos >= 0
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out[valid].float(), r[valid].float(),
                               atol=tol, rtol=tol)
    assert torch.isfinite(out.float()).all()
