"""The Hopper kernels of repro_torch against their plain PyTorch versions,
on the card.  Every test is marked ``cuda`` and skips without a GPU: a CUDA
kernel has no interpret mode.  The file imports no jax, so it runs on a GPU
machine without the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Tolerances: float32 1e-5 (the kernel sums in another order than the plain
einsum); bfloat16 2e-2 (inputs and outputs rounded to 8 mantissa bits).
Sampling is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from torch_cases import (FLASH_CASES, MASKS, decode_case, prefill_case,
                         sample_case, t)


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
