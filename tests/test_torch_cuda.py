"""The Hopper kernels of repro_torch against their plain PyTorch versions,
on the card.  Every test is marked ``cuda`` and skips without a GPU: a CUDA
kernel has no interpret mode.  The file imports no jax, so it runs on a GPU
machine without the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Tolerances: float32 1e-5 (the kernel sums in another order than the plain
einsum); bfloat16 2e-2 (inputs and outputs rounded to 8 mantissa bits).
The backward kernels of the grouped matmul and the selective scan: each
gradient within 1e-5 (gmm) or 1e-4 (scan, float32 outputs) times its
largest |value|, 2e-2 for bfloat16 outputs; two calls equal to the bit.
Sampling is exact.  The int8 page variants dequantize exactly as their
plain versions do, so they keep the same tolerances.  Rows with no visible
key (left-pad rows, idle paged slots) are compared too: the MoE family
routes them.  The grouped matmul: float32 1e-4 and bfloat16 2e-2 (sums of
up to 2048 products of order 1, in another order).  The selective scan:
1e-4 in both dtypes, relative to values of order 1 to 10 (the kernel and
its plain version compute in float32 from the same inputs; the kernel sums
the N terms of y in another order, takes exp2f of a pre-scaled A, and
carries the state across time chunks as exp(A * sum dt) times the chunk's
start state).  The flash backward: 2e-2 (bfloat16) and 2e-5 (float32)
times each gradient's largest |value| (at least 1), the same fp32 products
summed in another order; two calls equal to the bit; the training
forward's lse 1e-4.  At paligemma-3b's serving shapes, where the softmax
spreads over thousands of keys and a typical bf16 output is about 2e-2,
each output vector is also held within 2e-2 (bfloat16) or 1e-5 (float32)
of its own 2-norm, and the plain output with one 64-key tile hidden must
fail that rule.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from torch_cases import (FLASH_CASES, MASKS, decode_case, paged_case,
                         prefill_case, prefix_case, quantize_pool, sample_case,
                         scan_case, t)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the Hopper kernels have "
                    "no interpret mode")
    return torch.device("cuda")


#: FLASH_CASES and the shapes of the tensor-core path: olmo-1b's SQL
#: bucket (256 rows, 31 of them left pads in the first 64-row query tile,
#: 16 heads of 128, GQA 1), query counts that are no multiple of the
#: 64-row tile at GQA 5 and 8, and head dims rounded up to 64/128/256
#: (24: half a k16 step; 80: hubert-xlarge's; 256: paligemma-3b's)
FLASH_CUDA_CASES = {
    **FLASH_CASES,
    "olmo_bucket": dict(B=1, S=256, H=16, KV=16, D=128, npad=31),
    "gqa5_d64": dict(B=2, S=100, H=10, KV=2, D=64, npad=9),
    "gqa8_d128": dict(B=1, S=130, H=16, KV=2, D=128, npad=3),
    "d24": dict(B=1, S=65, H=2, KV=1, D=24, npad=4),
    "d80": dict(B=1, S=70, H=4, KV=2, D=80, npad=2),
    "d256": dict(B=1, S=96, H=2, KV=1, D=256, npad=5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CUDA_CASES))
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    q, k, v, qpos, kpos = (t(a).to(cuda) for a in
                           prefill_case(5, **FLASH_CUDA_CASES[case]))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    for kw in MASKS.values():
        n = ops.flash_attention.launches
        out = ops.flash_attention(q, k, v, qpos, kpos, **kw)
        assert ops.flash_attention.launches == n + 1
        r = ref.flash_attention_ref(q, k, v, qpos, kpos, **kw)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


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
@pytest.mark.parametrize("kv_block", [1024, 1])
def test_flash_attention_kernel_qwen3_moe_heads(cuda, dtype, kv_block):
    """qwen3-moe-30b-a3b's heads (32 on 4 kv heads, D=64) over the SQL
    path's 256-token bucket with 31 left-pad rows, pad rows included, at
    both divisors of a row with no visible key."""
    q, k, v, qpos, kpos = (t(a).to(cuda) for a in prefill_case(
        11, B=1, S=256, H=32, KV=4, D=64, npad=31))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out = ops.flash_attention(q, k, v, qpos, kpos, kv_block=kv_block)
    r = ref.flash_attention_ref(q, k, v, qpos, kpos, kv_block=kv_block)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_hymba_heads(cuda, dtype):
    """hymba-1.5b's heads (25 on 5 kv heads, D=64: 5 query heads per kv
    head, not a power of two) with its 1024-token window over the SQL
    path's 256-token bucket, 31 left-pad rows included."""
    q, k, v, qpos, kpos = (t(a).to(cuda) for a in prefill_case(
        16, B=1, S=256, H=25, KV=5, D=64, npad=31))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out = ops.flash_attention(q, k, v, qpos, kpos, window=1024)
    r = ref.flash_attention_ref(q, k, v, qpos, kpos, window=1024)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,D,L", [(8, 32, 4, 64, 512),
                                        (8, 25, 5, 64, 512),
                                        (8, 16, 4, 128, 300),
                                        (8, 16, 16, 128, 512),
                                        (3, 32, 4, 128, 77),
                                        (2, 4, 4, 16, 64)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, B, H, KV, D, L):
    q, kc, vc, spos, qpos = (t(a).to(cuda) for a in
                             decode_case(6, B, H, KV, D, L))
    q, kc, vc = (x.to(dtype) for x in (q, kc, vc))
    spos[-1] = -1                       # a row with no valid slot: mean of V
    out = ops.decode_attention(q, kc, vc, spos, qpos)
    r = ref.decode_attention_ref(q, kc, vc, spos, qpos)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


def _wrapped_ring(q, kc, vc, spos, qpos):
    """Roll each row of decode_case's ring along L so that its newest
    positions sit in its first slots: slots 0..k-1 hold positions
    fill-k..fill-1, the oldest ones the ring's end, empty slots between."""
    for b in range(spos.shape[0]):
        fill = int(qpos[b]) + 1
        shift = spos.shape[1] - fill + fill // 2 + 1
        kc[b], vc[b], spos[b] = [np.roll(x[b], shift, axis=0)
                                 for x in (kc, vc, spos)]
    return q, kc, vc, spos, qpos


def _last_split_only(q, kc, vc, spos, qpos):
    """Row 0's only valid slot is the ring's last (in the last split of
    the cluster), row 1's the last slot of the first half."""
    L = spos.shape[1]
    for b, slot in ((0, L - 1), (1, L // 2 - 1)):
        spos[b] = -1
        spos[b, slot] = qpos[b]
    return q, kc, vc, spos, qpos


#: the split design's cases: (B, H, KV, D, L, how the ring is laid out).
#: B * KV = 1 and 128 move the number of splits between 8 and 2; L = 333
#: is no multiple of the 32-slot tile, and its 11 tiles leave the last
#: splits empty at 8; bfloat16 runs on the tensor cores where D % 16 == 0
#: and D <= 128, and on the CUDA cores at D = 24 and 256; 16 query heads
#: a kv head take two blocks of 8
DECODE_SPLIT_CASES = {
    "wrapped_ring": (8, 32, 4, 64, 512, _wrapped_ring),
    "wrapped_ring_gqa5": (8, 25, 5, 64, 512, _wrapped_ring),
    "last_split_only": (8, 32, 4, 64, 512, _last_split_only),
    "bkv1": (1, 8, 1, 128, 512, None),
    "bkv128": (16, 32, 8, 64, 512, None),
    "odd_L": (4, 8, 2, 64, 333, None),
    "odd_L_wrapped": (4, 8, 2, 128, 333, _wrapped_ring),
    "d24": (4, 8, 2, 24, 100, None),
    "d256_wrapped": (3, 4, 1, 256, 200, _wrapped_ring),
    "gqa16": (3, 32, 2, 64, 130, _wrapped_ring),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(DECODE_SPLIT_CASES))
def test_decode_attention_kernel_split_cases(cuda, case, dtype):
    """Slot layouts that the cluster split and the dead-tile skip must get
    right; the last row (when B > 1) has no valid slot: mean of V."""
    B, H, KV, D, L, layout = DECODE_SPLIT_CASES[case]
    arrays = decode_case(17, B, H, KV, D, L)
    if layout is not None:
        arrays = layout(*arrays)
    q, kc, vc, spos, qpos = (t(np.ascontiguousarray(a)).to(cuda)
                             for a in arrays)
    q, kc, vc = (x.to(dtype) for x in (q, kc, vc))
    if B > 2:
        spos[-1] = -1
    n = ops.decode_attention.launches
    out = ops.decode_attention(q, kc, vc, spos, qpos)
    assert ops.decode_attention.launches == n + 1
    r = ref.decode_attention_ref(q, kc, vc, spos, qpos)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


#: kernels (a) and (b): (B, H, KV, D, L) of a rank's cache, the ring laid
#: out as by decode_case or wrapped; D is a rank's head_dim slice for (b)
#: (mixtral-8x22b's 128 over 2 and 4 ranks, olmo-1b's 128 over 2, the smoke
#: configs' 16 over 2)
DECODE_RANK_CASES = {
    "mixtral_hd2": (4, 48, 8, 64, 512, None),
    "mixtral_hd4": (4, 48, 8, 32, 300, _wrapped_ring),
    "olmo_hd2": (8, 16, 16, 64, 512, _wrapped_ring),
    "gqa16_d8": (3, 32, 2, 8, 130, None),
    "d256": (2, 4, 1, 256, 77, _wrapped_ring),
}


def _rank_case(case, dtype, cuda, seed):
    B, H, KV, D, L, layout = DECODE_RANK_CASES[case]
    arrays = decode_case(seed, B, H, KV, D, L)
    if layout is not None:
        arrays = layout(*arrays)
    q, kc, vc, spos, qpos = (t(np.ascontiguousarray(a)).to(cuda)
                             for a in arrays)
    if B > 2:
        spos[-1] = -1                   # a row with no valid slot
    return (q.to(dtype), kc.to(dtype), vc.to(dtype), spos, qpos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(DECODE_RANK_CASES))
def test_decode_attention_lse_kernel_matches_plain(cuda, case, dtype):
    """Kernel (a): kernel 2's output and each head's lse (-inf for the row
    with no valid slot)."""
    q, kc, vc, spos, qpos = _rank_case(case, dtype, cuda, 21)
    n = ops.decode_attention_lse.launches
    out, lse = ops.decode_attention_lse(q, kc, vc, spos, qpos)
    assert ops.decode_attention_lse.launches == n + 1
    r, rl = ref.decode_attention_lse_ref(q, kc, vc, spos, qpos)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    if spos.shape[0] > 2:
        assert torch.isneginf(lse[-1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(DECODE_RANK_CASES))
def test_decode_attention_hd_kernels_match_plain(cuda, case, dtype):
    """Kernel (b): the partial scores of a head_dim slice, then the softmax
    and P.V of the summed scores; two slices summed equal the whole."""
    q, kc, vc, spos, qpos = _rank_case(case, dtype, cuda, 22)
    scale = 1.0 / np.sqrt(2 * q.shape[-1])
    n = (ops.decode_attention_hd_scores.launches,
         ops.decode_attention_hd_out.launches)
    s = ops.decode_attention_hd_scores(q, kc, scale)
    out, lse = ops.decode_attention_hd_out(s, vc, spos, qpos)
    assert (ops.decode_attention_hd_scores.launches,
            ops.decode_attention_hd_out.launches) == (n[0] + 1, n[1] + 1)
    rs = ref.decode_attention_hd_scores_ref(q, kc, scale)
    torch.testing.assert_close(s, rs, atol=1e-4, rtol=1e-5)
    r, rl = ref.decode_attention_hd_out_ref(rs, vc, spos, qpos)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    # the whole head_dim as two slices: the sum of the partial scores is
    # kernel 2's attention
    half = q.shape[-1] // 2
    if half % 8 == 0:
        parts = [ops.decode_attention_hd_scores(
            q[..., i:i + half].contiguous(), kc[..., i:i + half].contiguous(),
            1.0 / np.sqrt(q.shape[-1])) for i in (0, half)]
        whole, _ = ops.decode_attention_hd_out(parts[0] + parts[1], vc,
                                               spos, qpos)
        torch.testing.assert_close(
            whole.float(), ref.decode_attention_ref(q, kc, vc, spos,
                                                    qpos).float(),
            atol=tol, rtol=tol)


#: the split designs of (a) and (b)'s second launch: chip_smoke.py's
#: yardstick shapes (a (2, 2) rank of mixtral-8x22b's decode: B 2, 48 heads
#: on 8; (a) 2048 slots of 128, (b) 4096 slots of 64 columns), L under one
#: 32-slot tile, L no multiple of 32, G over 8 (two head groups), a head dim
#: off the tensor cores
DECODE_SPLIT_RANK_CASES = {
    "mixtral_lc": (2, 48, 8, 128, 2048),
    "mixtral_hd": (2, 48, 8, 64, 4096),
    "L20": (3, 8, 2, 64, 20),
    "L333_g12": (3, 24, 2, 64, 333),
    "g12_d24": (3, 24, 2, 24, 100),
}


def _split_rank_case(case, dtype, cuda, empty):
    """decode_case's ring; `empty` "last_row": the last row has no valid
    slot, "all_rows": no row has one, "none": every row has one."""
    B, H, KV, D, L = DECODE_SPLIT_RANK_CASES[case]
    q, kc, vc, spos, qpos = (t(a).to(cuda) for a in
                             decode_case(23, B, H, KV, D, L))
    if empty == "all_rows":
        spos[:] = -1
    elif empty == "last_row":
        spos[-1] = -1
    return q.to(dtype), kc.to(dtype), vc.to(dtype), spos, qpos


@pytest.mark.cuda
@pytest.mark.parametrize("empty", ["last_row", "all_rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(DECODE_SPLIT_RANK_CASES))
def test_decode_attention_lse_split_edges(cuda, case, dtype, empty):
    """Kernel (a) against its plain version where rows have no valid slot
    (their output the mean of V read at bandwidth, their lse -inf); two
    calls equal to the bit."""
    args = _split_rank_case(case, dtype, cuda, empty)
    out, lse = ops.decode_attention_lse(*args)
    r, rl = ref.decode_attention_lse_ref(*args)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    assert torch.isneginf(lse[-1]).all()
    again = ops.decode_attention_lse(*args)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def vector_rel_err(got, want):
    """The largest ||got - want|| / ||want|| over the output vectors
    (2-norms along the last dim)."""
    got, want = got.float(), want.float()
    return ((got - want).norm(dim=-1)
            / want.norm(dim=-1).clamp_min(1e-30)).max().item()


#: paligemma-3b's serving decode (8 query heads on 1 kv head of 256: kernel
#: 2's D 256 body, on the CUDA cores): its whole 8224-slot ring and a
#: `model`-2 rank's half of it (kernel (a), the lc mode), and a short ring;
#: the last row has no valid slot: (B, L)
VLM_DECODE_CASES = {"ring_8224": (3, 8224), "rank_4112": (3, 4112),
                    "L77": (2, 77)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode_attention", "decode_attention_lse"])
@pytest.mark.parametrize("case", list(VLM_DECODE_CASES))
def test_decode_kernels_at_head_dim_256_with_an_empty_row(cuda, case, kernel):
    """Kernel 2 and (a) in bf16 at paligemma-3b's heads against their plain
    versions, the empty row's output the mean of V (its lse -inf); each
    output vector within 2e-2 of its 2-norm, which the plain output with
    the first 64 slots hidden is not."""
    B, L = VLM_DECODE_CASES[case]
    q, kc, vc, spos, qpos = (t(a).to(cuda) for a in
                             decode_case(31, B, 8, 1, 256, L))
    spos[-1] = -1
    args = tuple(x.to(torch.bfloat16) for x in (q, kc, vc)) + (spos, qpos)
    fn = getattr(ops, kernel)
    n = fn.launches
    got = fn(*args)
    assert fn.launches == n + 1
    want = getattr(ref, kernel + "_ref")(*args)
    if kernel == "decode_attention":
        got, want = (got,), (want,)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    assert vector_rel_err(got[0], want[0]) <= 2e-2
    hidden = spos.clone()
    hidden[:, :64] = -1
    dropped = getattr(ref, kernel + "_ref")(*args[:3], hidden, qpos)
    if kernel == "decode_attention_lse":
        dropped = dropped[0]
    assert vector_rel_err(dropped, want[0]) > 2e-2
    if kernel == "decode_attention_lse":
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)
        assert torch.isneginf(got[1][-1]).all()


#: kernel 2 and (a) at paligemma-3b's heads where the D 256 launch splits
#: each row over several one-block clusters (chunks) merged by a second
#: launch: the serving ring and a `model`-2 rank's half, every row filled
#: (B, L, fills)
VLM_CHUNK_CASES = {"ring_8224": (2, 8224, (8193, 8225)),
                   "rank_4112": (2, 4112, (4081, 4113)),
                   "short_fill": (2, 8224, (40, 300))}


def decode_shape(dtype, hd_out, B, H, KV, L, D):
    """kernel 2's (splits, warps, stages, chunks) at a shape (a query)."""
    fn = ops.build()["decode_attention.cu"].repro_decode_attention_shape
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    assert fn(ops._DTYPES[dtype], hd_out, B, H, KV, L, D, out) == 0
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode_attention", "decode_attention_lse"])
@pytest.mark.parametrize("case", list(VLM_CHUNK_CASES))
def test_decode_kernels_at_head_dim_256_chunked(cuda, case, kernel):
    """The chunked launch (more than one cluster a row) on the tensor
    cores: against the plain version, each output vector within 2e-2 of
    its 2-norm (the plain output with a 64-slot tile hidden is not), (a)'s
    lse within 1e-4, two calls equal to the bit."""
    B, L, (lo, hi) = VLM_CHUNK_CASES[case]
    assert decode_shape(torch.bfloat16, 0, B, 8, 1, L, 256)[3] > 1
    q, kc, vc, spos, qpos = (t(a).to(cuda) for a in
                             decode_case(37, B, 8, 1, 256, L))
    fills = torch.tensor([lo, hi - 1][:B], device=cuda)
    spos = torch.arange(L, device=cuda, dtype=torch.int32).repeat(B, 1)
    spos[spos >= fills[:, None]] = -1
    qpos = (fills - 1).to(torch.int32)
    args = tuple(x.to(torch.bfloat16) for x in (q, kc, vc)) + (spos, qpos)
    fn = getattr(ops, kernel)
    n = fn.launches
    got = fn(*args)
    again = fn(*args)
    assert fn.launches == n + 2
    plain = getattr(ref, kernel + "_ref")
    want = plain(*args)
    if kernel == "decode_attention":
        got, again, want = (got,), (again,), (want,)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=2e-2,
                               rtol=2e-2)
    assert vector_rel_err(got[0], want[0]) <= 2e-2
    hidden = spos.clone()
    hidden[:, 64 * (lo // 128):64 * (lo // 128) + 64] = -1
    dropped = plain(*args[:3], hidden, qpos)
    dropped = dropped[0] if kernel == "decode_attention_lse" else dropped
    assert vector_rel_err(dropped, want[0]) > 2e-2
    if kernel == "decode_attention_lse":
        torch.testing.assert_close(got[1], want[1], atol=1e-4, rtol=1e-5)


#: kernel 1 on the warp-specialised wgmma body (bf16, D 256): paligemma-3b's
#: heads (8 on 1), prefix-LM over an image prefix, with left-pad rows (a
#: row with no visible key under a causal mask without a prefix), a window,
#: bidirectional, a sequence-parallel rank's queries (from q_lo), Sq no
#: multiple of the 128-row tile: (B, S, q_lo, npad, mask)
WS_FLASH_CASES = {
    "prefix_lm": (2, 1024, 0, 0, dict(causal=True, prefix_len=256)),
    "prefix_lm_pads": (2, 700, 0, 37, dict(causal=True, prefix_len=96)),
    "causal_pads": (1, 520, 0, 70, dict(causal=True)),
    "window": (1, 640, 0, 5, dict(causal=True, window=200)),
    "bidirectional": (2, 300, 0, 0, dict(causal=False)),
    "rank": (2, 1024, 512, 0, dict(causal=True, prefix_len=256)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WS_FLASH_CASES))
def test_flash_attention_wgmma_body_at_head_dim_256(cuda, case):
    """Against the plain forward: every row (pad rows: the sum of V over
    the keys / empty_div) within 2e-2, each output vector within 2e-2 of
    its 2-norm (the plain output with a 64-key tile hidden is not), the
    training launch's lse within 1e-4 (-1e30 on a row with no visible
    key), two calls equal to the bit."""
    B, S, lo, npad, kw = WS_FLASH_CASES[case]
    q, k, v, qpos, kpos = prefill_case(43, B, S, 8, 1, 256, npad=npad)
    q, qpos = (np.ascontiguousarray(a[:, lo:]) for a in (q, qpos))
    q, k, v, qpos, kpos = (t(a).to(cuda) for a in (q, k, v, qpos, kpos))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    n = ops.flash_attention.launches
    out = ops._flash_forward(q, k, v, qpos, kpos, kw["causal"],
                             kw.get("window", 0), kw.get("prefix_len", 0),
                             ref.FLASH_KV_BLOCK, lse)
    again = ops.flash_attention(q, k, v, qpos, kpos, **kw)
    assert ops.flash_attention.launches == n + 2
    assert torch.equal(out, again)
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, qpos, kpos, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert vector_rel_err(out, want) <= 2e-2
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    if npad and kw.get("prefix_len", 0) == 0:
        assert (lse[:, :npad] == -1e30).all()
    hidden = kpos.clone()
    t0 = (npad + (S - npad) // 2) // 64 * 64
    hidden[:, t0:t0 + 64] = -1
    dropped = ref.flash_attention_ref(q, k, v, qpos, hidden, **kw)
    seen = ref.attention_mask(qpos, hidden, **kw).any(-1)
    assert vector_rel_err(dropped[seen], want[seen]) > 2e-2


#: kernel 1 at a sequence-parallel rank's queries (a chunk of the
#: positions) against the whole sequence: paligemma-3b's prefix-LM heads at
#: D 256 (the last half of the sequence; a chunk inside the image prefix
#: and past it) and hubert-xlarge's bidirectional heads at D 80: (B, Skv,
#: first query, queries, H, KV, D, mask)
FLASH_OFFSET_CASES = {
    "vlm_last_half": (2, 300, 150, 150, 8, 1, 256,
                      dict(causal=True, prefix_len=40)),
    "vlm_chunk_in_prefix": (1, 256, 32, 64, 8, 1, 256,
                            dict(causal=True, prefix_len=80)),
    "encoder_second_half": (2, 200, 100, 100, 16, 16, 80,
                            dict(causal=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_OFFSET_CASES))
def test_flash_attention_kernel_query_offset(cuda, case, dtype):
    B, Skv, lo, Sq, H, KV, D, kw = FLASH_OFFSET_CASES[case]
    q, k, v, _, kpos = prefill_case(41, B, Skv, H, KV, D)
    q, qpos = (np.ascontiguousarray(a[:, lo:lo + Sq]) for a in (q, kpos))
    q, k, v, qpos, kpos = (t(a).to(cuda) for a in (q, k, v, qpos, kpos))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    out = ops.flash_attention(q, k, v, qpos, kpos, **kw)
    r = ref.flash_attention_ref(q, k, v, qpos, kpos, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)
    assert vector_rel_err(out, r) <= tol


#: kernel (b)'s scores launch: chip_smoke.py's rank shapes (a (2, 2) rank
#: of mixtral-8x22b's B 2 decode; hymba-1.5b's and mixtral-8x22b's batch-1
#: decode, the slots over `data` and head_dim over `model`), L no multiple
#: of a tile and odd, L under a 16-slot tile, G over 16 (two passes of the
#: A operand), head dims off the tensor cores (8, 24, 256): (B, H, KV, D, L)
HD_SCORE_CASES = {
    "mixtral_b2": (2, 48, 8, 64, 4096),
    "hymba_b1": (1, 25, 5, 32, 512),
    "mixtral_b1": (1, 48, 8, 64, 2048),
    "L333": (3, 24, 2, 64, 333),
    "L7": (2, 8, 2, 32, 7),
    "g24": (1, 48, 2, 64, 100),
    "d8": (3, 32, 2, 8, 130),
    "d24": (3, 24, 2, 24, 100),
    "d256": (2, 4, 1, 256, 77),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(HD_SCORE_CASES))
def test_decode_attention_hd_scores_kernel_shapes(cuda, case, dtype):
    """Kernel (b)'s scores launch against its plain version (one launch
    counted); two calls equal to the bit; its launch shape gives the
    batch-1 rank shapes a block an SM."""
    B, H, KV, D, L = HD_SCORE_CASES[case]
    q, kc, _, _, _ = (t(a).to(cuda) for a in decode_case(25, B, H, KV, D, L))
    q, kc = q.to(dtype), kc.to(dtype)
    scale = 1.0 / np.sqrt(2 * D)
    n = ops.decode_attention_hd_scores.launches
    s = ops.decode_attention_hd_scores(q, kc, scale)
    assert ops.decode_attention_hd_scores.launches == n + 1
    torch.testing.assert_close(
        s, ref.decode_attention_hd_scores_ref(q, kc, scale), atol=1e-4,
        rtol=1e-5)
    assert torch.equal(s, ops.decode_attention_hd_scores(q, kc, scale))
    if case.endswith("_b1"):
        import ctypes
        fn = ops.build()["decode_attention.cu"] \
            .repro_decode_attention_hd_scores_shape
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        shape = (ctypes.c_int * 4)()
        assert fn(ops._DTYPES[dtype], B, H, KV, L, D, shape) == 0
        TW, W, per = shape[0], shape[1], shape[2]
        blocks = -(-(-(-L // TW)) // (W * per)) * KV * B
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert blocks >= sms, (tuple(shape), blocks, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("empty", ["none", "last_row", "all_rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(DECODE_SPLIT_RANK_CASES)
                         + ["hymba_b1", "mixtral_b1"])
def test_decode_attention_hd_out_split_edges(cuda, case, dtype, empty):
    """Kernel (b)'s second launch against its plain version over scores of
    chip_smoke.py's spread (3 x a standard normal), at the split designs'
    shapes and the batch-1 rank shapes (the slots over `data`, head_dim
    over `model`), every row filled or rows with no valid slot (their
    output the mean of V, their lse -inf); one launch counted; two calls
    equal to the bit."""
    if case in DECODE_SPLIT_RANK_CASES:
        _, _, vc, spos, qpos = _split_rank_case(case, dtype, cuda, empty)
        H = DECODE_SPLIT_RANK_CASES[case][1]
    else:
        B, H, KV, D, L = HD_SCORE_CASES[case]
        _, _, vc, spos, qpos = (t(a).to(cuda) for a in
                                decode_case(26, B, H, KV, D, L))
        vc = vc.to(dtype)
        if empty != "none":
            spos[-1 if empty == "last_row" else slice(None)] = -1
    if empty == "none":
        assert ((spos >= 0) & (spos <= qpos[:, None])).any(-1).all()
    B = spos.shape[0]
    scores = torch.from_numpy(np.random.default_rng(27).standard_normal(
        (B, H, spos.shape[1]), np.float32) * 3).to(cuda)
    n = ops.decode_attention_hd_out.launches
    out, lse = ops.decode_attention_hd_out(scores, vc, spos, qpos)
    assert ops.decode_attention_hd_out.launches == n + 1
    r, rl = ref.decode_attention_hd_out_ref(scores, vc, spos, qpos)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rl, atol=1e-4, rtol=1e-5)
    assert torch.isneginf(lse[-1]).all() == (empty != "none")
    again = ops.decode_attention_hd_out(scores, vc, spos, qpos)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("V", [50432, 152064, 65024, 32001])
def test_constrained_sample_kernel_matches_plain(cuda, temperature, V):
    """olmo-1b's, qwen3-moe-30b-a3b's and falcon-mamba-7b's padded
    vocabularies, and hymba-1.5b's 32001 (odd: row b's mask starts at byte
    b * V, so every split's 16-byte loads have an unaligned head and
    tail)."""
    logits, mask, rng = sample_case(7, 8, V, ties=False)
    noise = None
    if temperature > 0:
        noise = t(-np.log(-np.log(rng.uniform(1e-9, 1.0, (8, V))))).to(cuda)
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


@pytest.mark.cuda
def test_constrained_sample_kernel_ties_across_splits(cuda):
    """Greedy over few distinct logits (exact ties in every split), and a
    maximum at two indices in different splits of the row: the lower
    index wins, as in np.argmax."""
    V = 152064
    logits, mask, _ = sample_case(19, 8, V, ties=True)
    lg, mk = t(logits).to(cuda), t(mask).to(cuda)
    out = ops.constrained_sample(lg, mk, None)
    assert torch.equal(out, ref.constrained_sample_ref(lg, mk, None))
    per = V // 8
    for b, (i, j) in enumerate([(2 * per + 5, 5 * per + 7), (per - 1, per),
                                (3, 7 * per + 1)]):
        logits[b, i] = logits[b, j] = 100.0
        mask[b, i] = mask[b, j] = 1
    lg, mk = t(logits).to(cuda), t(mask).to(cuda)
    out = ops.constrained_sample(lg, mk, None)
    assert torch.equal(out, ref.constrained_sample_ref(lg, mk, None))
    assert out[:3].tolist() == [2 * per + 5, per - 1, 3]


@pytest.mark.cuda
@pytest.mark.parametrize("V", [152064, 32001])
def test_constrained_sample_kernel_only_last_entry_allowed(cuda, V):
    """Row 0 allows only its last entry, row 1 nothing at all (every entry
    at -1e30: index 0, as np.argmax), row 2 only its first."""
    logits, mask, rng = sample_case(20, 4, V, ties=False)
    mask[:3] = 0
    mask[0, V - 1] = 1
    mask[2, 0] = 1
    lg, mk = t(logits).to(cuda), t(mask).to(cuda)
    noise = t(-np.log(-np.log(rng.uniform(1e-9, 1.0, (4, V))))).to(cuda)
    for nz, temp in ((None, 1.0), (noise, 0.7)):
        out = ops.constrained_sample(lg, mk, nz, temperature=temp)
        assert torch.equal(out, ref.constrained_sample_ref(lg, mk, nz,
                                                           temperature=temp))
        assert out[:3].tolist() == [V - 1, 0, 0]


def _quant(kp, vp, cuda, frozen_every=2):
    """The int8 shadows of two pools; frozen_every None freezes no page."""
    kq, ks, flags = quantize_pool(kp, frozen_every or 1)
    vq, vs, _ = quantize_pool(vp, frozen_every or 1)
    if frozen_every is None:
        flags[:] = 0
    return {"kq": t(kq).to(cuda), "vq": t(vq).to(cuda),
            "kscale": t(ks).to(cuda), "vscale": t(vs).to(cuda),
            "flags": t(flags).to(cuda)}


PAGED_CASES = [dict(B=8, H=16, KV=16, D=128, ps=64, NB=8, P=80, shared=2),
               dict(B=3, H=8, KV=2, D=64, ps=16, NB=6, P=24, shared=1),
               dict(B=2, H=4, KV=4, D=16, ps=32, NB=4, P=9, shared=0),
               # qwen3-moe-30b-a3b's heads, 3 radix-shared prefix pages
               dict(B=8, H=32, KV=4, D=64, ps=64, NB=8, P=80, shared=3)]


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(PAGED_CASES)))
def test_decode_attention_paged_kernel_matches_plain(cuda, case, dtype,
                                                     quant):
    c = PAGED_CASES[case]
    q, kp, vp, table, qpos = paged_case(9, **c)
    if c["B"] > 2:
        table[1] = -1       # an idle batcher slot: the mean over page 0
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


def paged_scenario(seed, H, KV, D, layout):
    """Block tables for the int8 kernel's cluster split, numpy: q (B, H, D),
    pools (KV, P, ps, D), table (B, NB), qpos (B,).

    "rows": 8 rows over pages of 64 (NB 8, the first 2 pages shared): a
    mid-page fill, an idle row (table all -1), fills at a page edge (qpos =
    2 ps - 1 and 2 ps), a -1 entry below the fill, a 3-token fill (its
    later splits hold no tile), a row with qpos -1 over real pages (no
    valid token: the mean over its pages) and a full table.
    "wide": pages of 128 (NB 2): 8 tiles of 32, so up to 8 splits, more
    than the pages; row 1's 6-token fill leaves every split but one empty.
    """
    rng = np.random.default_rng(seed)
    if layout == "rows":
        B, ps, NB, P = 8, 64, 8, 64
        qpos = np.array([300, 0, 2 * ps - 1, 2 * ps, 400, 2, -1, NB * ps - 1],
                        np.int32)
    else:
        B, ps, NB, P = 2, 128, 2, 5
        qpos = np.array([200, 5], np.int32)
    perm = iter(rng.permutation(P))
    shared = [next(perm) for _ in range(min(2, NB))]
    table = np.full((B, NB), -1, np.int32)
    for b in range(B):
        table[b, :len(shared)] = shared
        for j in range(len(shared), NB):
            table[b, j] = next(perm, 0)
    if layout == "rows":
        table[1] = -1                   # an idle batcher slot
        table[4, 3] = -1                # a hole below the fill (400)
    q = rng.standard_normal((B, H, D), np.float32)
    kp = rng.standard_normal((KV, P, ps, D), np.float32)
    vp = rng.standard_normal((KV, P, ps, D), np.float32)
    return q, kp, vp, table, qpos


#: frozen pages: none, every other page, all (quantize_pool's frozen_every)
FROZEN = {"none": None, "mixed": 2, "all": 1}
#: olmo-1b's heads (G 1, D 128), qwen3-moe-30b-a3b's (G 8, D 64) and
#: hymba-1.5b's (G 5, D 64)
PAGED_HEADS = {"olmo": (16, 16, 128), "qwen3_moe": (32, 4, 64),
               "hymba": (25, 5, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "wide"])
@pytest.mark.parametrize("frozen", list(FROZEN))
@pytest.mark.parametrize("heads", list(PAGED_HEADS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_paged_quant_kernel_split_cases(cuda, dtype, heads,
                                                         frozen, layout):
    """Kernel B's cluster split over pages against its plain version."""
    H, KV, D = PAGED_HEADS[heads]
    q, kp, vp, table, qpos = paged_scenario(31, H, KV, D, layout)
    qd = _quant(kp, vp, cuda, FROZEN[frozen])
    q, kpd, vpd = (t(a).to(cuda).to(dtype) for a in (q, kp, vp))
    table, qpos = t(table).to(cuda), t(qpos).to(cuda)
    n = ops.decode_attention_paged_quant.launches
    out = ops.decode_attention_paged_quant(q, kpd, vpd, table, qpos, qd)
    assert ops.decode_attention_paged_quant.launches == n + 1
    r = ref.decode_attention_paged_ref(q, kpd, vpd, table, qpos, qd)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


def _paged_fp_against_plain(cuda, dtype, H, KV, D, layout):
    q, kp, vp, table, qpos = paged_scenario(37, H, KV, D, layout)
    q, kpd, vpd = (t(a).to(cuda).to(dtype) for a in (q, kp, vp))
    table, qpos = t(table).to(cuda), t(qpos).to(cuda)
    n = ops.decode_attention_paged.launches
    out = ops.decode_attention_paged(q, kpd, vpd, table, qpos)
    assert ops.decode_attention_paged.launches == n + 1
    r = ref.decode_attention_paged_ref(q, kpd, vpd, table, qpos)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "wide"])
@pytest.mark.parametrize("heads", list(PAGED_HEADS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_paged_kernel_split_cases(cuda, dtype, heads,
                                                   layout):
    """Kernel A's cluster split over pages (its two-stage warp ring)
    against its plain version."""
    _paged_fp_against_plain(cuda, dtype, *PAGED_HEADS[heads], layout)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rows", "wide"])
@pytest.mark.parametrize("D", [40, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_paged_kernel_head_dims(cuda, dtype, D, layout):
    """Head dims off the tensor-core path: 40 (five 16-byte chunks of
    bf16 a row) and 256, on the CUDA cores in both dtypes."""
    _paged_fp_against_plain(cuda, dtype, 8, 2, D, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,D,ps,P,npre,plen", [
    (1, 256, 16, 16, 128, 64, 12, 3, None),     # the SQL path's shape
    (1, 256, 32, 4, 64, 64, 12, 3, None),       # qwen3-moe-30b-a3b's heads
    (3, 40, 8, 2, 32, 16, 10, 4, 50),           # a partial last page
    (2, 33, 4, 4, 16, 32, 5, 0, None),          # no prefix
    # prefixes that end mid-page at the path's page size, D 128 and GQA 8
    (2, 64, 16, 16, 128, 64, 12, 3, 150),
    (1, 64, 32, 4, 64, 64, 12, 3, 170),
    # pages smaller and larger than the 64-key tile, GQA 5, 70 queries
    (2, 70, 10, 2, 64, 32, 10, 4, 100),
    (1, 40, 4, 4, 64, 128, 6, 2, 200),
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
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


# ------------------------------- grouped matmul -------------------------------
def _gmm_inputs(cuda, dtype, T, M, N, gs, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, M, generator=g)
    w = torch.randn(len(gs), M, N, generator=g) / M ** 0.5
    return (x.to(cuda, dtype), w.to(cuda, dtype),
            torch.tensor(gs, dtype=torch.int32, device=cuda))


GMM_CASES = {
    # tests/test_kernels.py's cases (N = 48 and 16: not multiples of 128)
    "jax_0": (64, 32, 48, [20, 15, 13, 16]),
    "jax_1": (130, 64, 64, [16, 17, 15, 18, 14, 16, 17, 17]),
    "jax_2": (33, 96, 16, [11, 10, 12]),
    # one-row groups and empty experts, rows past the sum (dropped choices)
    "decode": (64, 256, 200, [1, 0, 2, 1, 0, 0, 3, 1] * 4 + [0] * 96),
    "sum_lt_T": (40, 64, 136, [3, 0, 7, 0, 1, 9]),
    # a group spanning several row tiles
    "long_group": (100, 128, 256, [0, 70, 0, 30]),
    # groups on both sides of the 16-row slices and the 64-row tile,
    # consecutive empty experts, N = 200 not a multiple of the 64-column
    # unit, M = 96 not a multiple of the 64-value contraction chunk
    "group_sizes": (340, 96, 200, [0, 1, 0, 0, 15, 16, 17, 20, 0, 64, 65,
                                   130]),
    "one_expert": (80, 72, 72, [70]),
    "e1024": (64, 64, 136, [3, 0, 0, 0, 0, 1] + [0] * 505 + [20]
              + [0] * 511 + [17]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GMM_CASES))
def test_gmm_kernel_matches_plain(cuda, case, dtype):
    T, M, N, gs = GMM_CASES[case]
    x, w, g = _gmm_inputs(cuda, dtype, T, M, N, gs, 12)
    n = ops.gmm.launches
    out = ops.gmm(x, w, g)
    assert ops.gmm.launches == n + 1
    r = ref.gmm_ref(x, w, g)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)
    assert not out[sum(gs):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("orient", ["gate_up", "down"])
def test_gmm_kernel_qwen3_moe_prefill(cuda, dtype, orient):
    """A 256-token prefill of qwen3-moe-30b-a3b: 2048 choices over 128
    experts, each capped at the capacity 20 (dropped ones past the sum)."""
    M, N = (2048, 768) if orient == "gate_up" else (768, 2048)
    g = torch.Generator().manual_seed(13)
    picks = torch.stack([torch.randperm(128, generator=g)[:8]
                         for _ in range(256)])
    gs = torch.bincount(picks.flatten(), minlength=128).clamp(max=20).tolist()
    x, w, gd = _gmm_inputs(cuda, dtype, 2048, M, N, gs, 14)
    out = ops.gmm(x, w, gd)
    r = ref.gmm_ref(x, w, gd)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), r.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_gmm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, w, g = _gmm_inputs(cuda, torch.bfloat16, 16, 32, 48, [8, 8], 15)
    with pytest.raises(ValueError, match="int32"):
        ops.gmm(x, w, g.long())
    with pytest.raises(ValueError, match="int32"):
        ops.gmm(x, w, g.cpu())
    with pytest.raises(ValueError, match="share"):
        ops.gmm(x, w.float(), g)
    with pytest.raises(ValueError, match="multiples of 8"):
        ops.gmm(x[:, :30].contiguous(), w[:, :30].contiguous(), g)
    with pytest.raises(ValueError, match=r"\(E, M, N\)"):
        ops.gmm(x, w[0], g)


# ------------------------- grouped matmul: the backward -------------------------
#: group sizes of the backward's cases: empty, one row, both sides of the
#: wgmma body's 64-row halves and 128-row tiles, and a training group at
#: the capacity 320 of qwen3-moe-30b-a3b at B 8 x 512 ("training": 64 or
#: more rows per expert on average); and groups of kernel 6's serving sizes
#: ("small": fewer than 64 rows per expert on average)
GMM_BWD_SIZES = {"training": [0, 1, 63, 64, 65, 127, 128, 129, 320],
                 "small": [0, 1, 2, 17, 63, 64, 65]}


def _gmm_bwd_case(cuda, dtype, E, M, N, seed, sizes="training"):
    """Group sizes cycling through GMM_BWD_SIZES[sizes] over E experts, 13
    rows past their sum (dropped choices), x, w and dy."""
    cycle = GMM_BWD_SIZES[sizes]
    gs = [cycle[(e + seed) % len(cycle)] for e in range(E)]
    x, w, g = _gmm_inputs(cuda, dtype, sum(gs) + 13, M, N, gs, seed)
    dy = torch.randn(x.shape[0], N, generator=torch.Generator().manual_seed(
        seed)).to(cuda, dtype)
    return x, w, g, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,N,sizes", [
    (8, 96, 200, "training"), (8, 256, 64, "training"),
    (128, 128, 72, "training"), (9, 512, 264, "training"),
    (8, 96, 200, "small"), (64, 136, 520, "small")])
def test_gmm_bwd_kernel_matches_plain(cuda, E, M, N, sizes, dtype):
    """dx and dw against the plain pair, each within the tolerance times
    its largest |value| (fp32 sums of up to 320 products in another order;
    bf16 outputs rounded once); rows past the sum 0 in dx, empty experts 0
    in dw; two calls equal to the bit.  M and N on both sides of the wgmma
    body's 128-row and 256-column tiles; T / E on both sides of 64."""
    x, w, g, dy = _gmm_bwd_case(cuda, dtype, E, M, N, E + M, sizes)
    assert (x.shape[0] >= 64 * E) == (sizes == "training")
    n = ops.gmm_bwd.launches
    got = ops.gmm_bwd(x, w, g, dy)
    assert ops.gmm_bwd.launches == n + 1
    want = ref.gmm_bwd_ref(x, w, g, dy)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for name, a, b in zip(("dx", "dw"), got, want):
        scale = max(1e-30, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * scale, (name, err, tol * scale)
    kept = int(g.sum())
    assert not got[0][kept:].any()
    assert not got[1][g == 0].any()
    again = ops.gmm_bwd(x, w, g, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_bwd_kernel_no_rows(cuda, dtype):
    """With no rows (T = 0) dx is empty and dw zeros, counted as a launch,
    whatever dw held before."""
    E, M, N = 8, 96, 200
    x = torch.empty(0, M, dtype=dtype, device=cuda)
    w = torch.randn(E, M, N, generator=torch.Generator().manual_seed(0)
                    ).to(cuda, dtype)
    g = torch.zeros(E, dtype=torch.int32, device=cuda)
    dy = torch.empty(0, N, dtype=dtype, device=cuda)
    torch.full((E, M, N), 7.0, dtype=dtype, device=cuda)  # a dirty cache
    n = ops.gmm_bwd.launches
    dx, dw = ops.gmm_bwd(x, w, g, dy)
    assert ops.gmm_bwd.launches == n + 1
    assert dx.shape == (0, M) and dw.shape == (E, M, N)
    assert not dw.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_training_path_matches_plain(cuda, dtype):
    """The differentiable ops.gmm (kernel 6, then gmm_bwd) against the
    plain autograd function at qwen3-moe-30b-a3b's gate/up width."""
    x, w, g, dy = _gmm_bwd_case(cuda, dtype, 16, 2048, 768, 3)
    leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    n = ops.gmm.launches, ops.gmm_bwd.launches
    out = ops.gmm(*leaves, g)
    got = torch.autograd.grad(out, leaves, dy)
    assert (ops.gmm.launches, ops.gmm_bwd.launches) == (n[0] + 1, n[1] + 1)
    plain = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    want = torch.autograd.grad(ref.gmm_grad_ref(*plain, g), plain, dy)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


# ------------------------------- selective scan -------------------------------
def _scan_inputs(cuda, dtype, Bz, S, Di, N, seed, R=16):
    """scan_case on the card: u, B and C in `dtype`, B and C slices of one
    (Bz, S, R + 2N) projection as the mixer passes them."""
    u, dt, A, B, C, D, h0 = scan_case(seed, Bz, S, Di, N)
    dbc = torch.zeros(Bz, S, R + 2 * N, dtype=dtype, device=cuda)
    dbc[..., R:R + N] = t(B).to(cuda, dtype)
    dbc[..., R + N:] = t(C).to(cuda, dtype)
    return (t(u).to(cuda, dtype), t(dt).to(cuda), t(A).to(cuda),
            dbc[..., R:R + N], dbc[..., R + N:], t(D).to(cuda),
            t(h0).to(cuda))


def _assert_scan_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("Di", [8192, 3200])
@pytest.mark.parametrize("S", [1, 33, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_matches_plain(cuda, dtype, S, Di):
    """falcon-mamba-7b's and hymba-1.5b's channels (N 16), from zeros, from
    a state, and from a state it overwrites in place (h_out is h0)."""
    u, dt, A, B, C, D, h0 = _scan_inputs(cuda, dtype, 2, S, Di, 16, S + Di)
    n = ops.selective_scan.launches
    _assert_scan_close(ops.selective_scan(u, dt, A, B, C, D),
                       ref.selective_scan_ref(u, dt, A, B, C, D))
    want = ref.selective_scan_ref(u, dt, A, B, C, D, h0)
    _assert_scan_close(ops.selective_scan(u, dt, A, B, C, D, h0), want)
    state = h0.clone()
    y, h = ops.selective_scan(u, dt, A, B, C, D, state, h_out=state)
    assert h is state and ops.selective_scan.launches == n + 3
    _assert_scan_close((y, h), want)


#: (Bz, Di) pairs: falcon-mamba-7b's prefill row and channels, a ragged
#: channel count (no multiple of the 32-channel group or the 128-thread
#: decode block), hymba-1.5b's channels at the decode slots
SCAN_ROWS = [(1, 8192), (3, 100), (8, 3200)]


@pytest.mark.cuda
@pytest.mark.parametrize("Bz,Di", SCAN_ROWS)
@pytest.mark.parametrize("S", [1, 2, 33, 64, 255, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_chunk_shapes(cuda, dtype, S, Bz, Di):
    """The decode launch (S = 1) and the chunked prefill at lengths that
    are and are not multiples of the chunks and slabs, from zeros, from a
    state, and in place (h_out is h0)."""
    u, dt, A, B, C, D, h0 = _scan_inputs(cuda, dtype, Bz, S, Di, 16, S + Bz)
    _assert_scan_close(ops.selective_scan(u, dt, A, B, C, D),
                       ref.selective_scan_ref(u, dt, A, B, C, D))
    want = ref.selective_scan_ref(u, dt, A, B, C, D, h0)
    _assert_scan_close(ops.selective_scan(u, dt, A, B, C, D, h0), want)
    state = h0.clone()
    n = ops.selective_scan.launches
    y, h = ops.selective_scan(u, dt, A, B, C, D, state, h_out=state)
    assert h is state and ops.selective_scan.launches == n + 1
    _assert_scan_close((y, h), want)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 8, 32])
@pytest.mark.parametrize("S", [1, 33, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_state_sizes(cuda, dtype, S, N):
    """The other state sizes, at hymba's channels over 3 rows, in place."""
    u, dt, A, B, C, D, h0 = _scan_inputs(cuda, dtype, 3, S, 3200, N, S + N)
    want = ref.selective_scan_ref(u, dt, A, B, C, D, h0)
    state = h0.clone()
    _assert_scan_close(ops.selective_scan(u, dt, A, B, C, D, state,
                                          h_out=state), want)
    _assert_scan_close(ops.selective_scan(u, dt, A, B, C, D),
                       ref.selective_scan_ref(u, dt, A, B, C, D))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_kernel_decode_with_idle_slots(cuda, dtype):
    """A decode tick over 8 slots (S = 1, state in place), three of them
    idle with dt = 0 and u = 0: their state must come back unchanged."""
    u, dt, A, B, C, D, h0 = _scan_inputs(cuda, dtype, 8, 1, 8192, 16, 21)
    idle = [1, 4, 6]
    u[idle] = 0
    dt[idle] = 0
    want = ref.selective_scan_ref(u, dt, A, B, C, D, h0)
    state = h0.clone()
    got = ops.selective_scan(u, dt, A, B, C, D, state, h_out=state)
    _assert_scan_close(got, want)
    assert torch.equal(state[idle], h0[idle])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 40])
def test_selective_scan_kernel_unaligned_state(cuda, S):
    """A state and an A that are contiguous but not 16-byte aligned (views
    one float into a buffer): the decode step falls back to a one-chunk
    scan, in place as before."""
    u, dt, A, B, C, D, h0 = _scan_inputs(cuda, torch.bfloat16, 3, S, 100, 16,
                                         23)
    want = ref.selective_scan_ref(u, dt, A, B, C, D, h0)

    def unaligned(x):
        buf = torch.empty(x.numel() + 1, device=cuda)
        out = buf[1:].view(x.shape)
        out.copy_(x)
        return out
    state, A1 = unaligned(h0), unaligned(A)
    assert state.data_ptr() % 16 and A1.data_ptr() % 16
    y, h = ops.selective_scan(u, dt, A1, B, C, D, state, h_out=state)
    assert h is state
    _assert_scan_close((y, h), want)


@pytest.mark.cuda
def test_selective_scan_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    u, dt, A, B, C, D, h0 = _scan_inputs(cuda, torch.bfloat16, 2, 8, 64, 16,
                                         22)
    with pytest.raises(ValueError, match="share"):
        ops.selective_scan(u.float(), dt, A, B, C, D)
    with pytest.raises(ValueError, match="dt float32"):
        ops.selective_scan(u, dt.to(torch.bfloat16), A, B, C, D)
    with pytest.raises(ValueError, match="h0"):
        ops.selective_scan(u, dt, A, B, C, D, h0[:1])
    with pytest.raises(ValueError, match="row stride"):
        ops.selective_scan(u, dt, A, B.transpose(0, 1).contiguous()
                           .transpose(0, 1), C, D)
    with pytest.raises(ValueError, match="state size"):
        ops.selective_scan(u, dt, A[:, :12].contiguous(), B[..., :12],
                           C[..., :12], D)


# ------------------------ selective scan: the backward --------------------------
def _assert_scan_grads_close(got, want, dtype):
    """Each gradient within the tolerance times its largest |value|: 1e-4
    for the float32 outputs (d(dt), dA, dD; and all of them in float32),
    2e-2 for du, dB and dC in bfloat16 (rounded once to 8 bits)."""
    for name, a, b in zip(("du", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        tol = 2e-2 if a.dtype == torch.bfloat16 else 1e-4
        scale = max(1e-30, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol * scale, (name, err, tol * scale)


#: (Bz, S, Di, N): falcon-mamba-7b's channels at its training batch and
#: longer, hymba-1.5b's at its training length, one step, ragged lengths,
#: every state size
SCAN_BWD_CASES = [(1, 1, 3200, 16), (4, 37, 8192, 16), (4, 512, 8192, 16),
                  (2, 2048, 3200, 16), (1, 2048, 8192, 16), (2, 300, 3200, 4),
                  (1, 129, 3200, 8), (3, 1000, 3200, 32), (4, 255, 100, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bz,S,Di,N", SCAN_BWD_CASES)
def test_selective_scan_bwd_kernel_matches_plain(cuda, Bz, S, Di, N, dtype):
    """The backward kernel against its plain version from the same carries
    (the plain forward's, at the chunk count of the training launch --
    chunks of ~64 steps, S not always a multiple of them -- at 3 chunks,
    and at 12, which leaves S = 37 two empty trailing chunks), twice equal
    to the bit; then the carries of the training forward against the plain
    forward's."""
    u, dt, A, B, C, D, _ = _scan_inputs(cuda, dtype, Bz, S, Di, N, S + N)
    dy = torch.randn(Bz, S, Di, generator=torch.Generator().manual_seed(S)
                     ).to(cuda)
    T = ops._fn("selective_scan_train_chunks")(Bz, S, Di, N)
    assert T == -(-S // 64)
    for chunks in sorted({T, min(3, S), min(12, S)}):
        _, _, carries = ref.selective_scan_fwd_ref(u, dt, A, B, C, D,
                                                   chunks=chunks)
        n = ops.selective_scan_bwd.launches
        got = ops.selective_scan_bwd(u, dt, A, B, C, D, carries, dy)
        assert ops.selective_scan_bwd.launches == n + 1
        want = ref.selective_scan_bwd_ref(u, dt, A, B, C, D, carries, dy)
        _assert_scan_grads_close(got, want, dtype)
        again = ops.selective_scan_bwd(u, dt, A, B, C, D, carries, dy)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    y, h, carries = ops._scan_forward(u, dt, A, B, C, D, None, None, True)
    assert carries.shape == (Bz, T, Di, N)
    want = ref.selective_scan_fwd_ref(u, dt, A, B, C, D, chunks=T)
    _assert_scan_close((y, h, carries), want)
    again = ops._scan_forward(u, dt, A, B, C, D, None, None, True)
    assert all(torch.equal(a, b) for a, b in zip((y, h, carries), again))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [4, 8, 16, 32])
def test_selective_scan_bwd_chunk_limit(cuda, N):
    """Chunks of the carries up to repro_selective_scan_bwd_max_chunk(N)
    steps run and match the plain backward; one step more is refused up
    front with a ValueError that names the limit, before any launch."""
    most = ops._fn("selective_scan_bwd_max_chunk")(N)
    per_sub = 4 * 4 * 2 * N    # a 4-step sub-chunk's B/C rows, float32
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    assert most == (optin // per_sub - 8) * 4
    dtype = torch.bfloat16
    S = 2 * most + 1
    u, dt, A, B, C, D, _ = _scan_inputs(cuda, dtype, 1, S, 64, N, N)
    dy = torch.randn(1, S, 64, generator=torch.Generator().manual_seed(N)
                     ).to(cuda)
    _, _, carries = ref.selective_scan_fwd_ref(u, dt, A, B, C, D, chunks=3)
    got = ops.selective_scan_bwd(u, dt, A, B, C, D, carries, dy)
    _assert_scan_grads_close(
        got, ref.selective_scan_bwd_ref(u, dt, A, B, C, D, carries, dy),
        dtype)
    _, _, carries = ref.selective_scan_fwd_ref(u, dt, A, B, C, D, chunks=2)
    n = ops.selective_scan_bwd.launches
    with pytest.raises(ValueError, match=f"at most {most} steps"):
        ops.selective_scan_bwd(u, dt, A, B, C, D, carries, dy)
    assert ops.selective_scan_bwd.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("Bz,S,Di,N", [(1, 256, 8192, 16), (8, 1, 8192, 16),
                                       (1, 256, 3200, 16), (8, 1, 3200, 16),
                                       (3, 300, 100, 32), (2, 7, 64, 4)])
def test_selective_scan_serving_chunk_pick_unchanged(cuda, Bz, S, Di, N):
    """The serving launch's time chunks (repro_selective_scan_chunks) are
    the smallest power of two that gives the card ~8 warps an SM, with
    chunks of at least 8 steps, at most 16 (8 at N = 32): the training
    launch's carry chunks are a count of their own."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups, cap, T = -(-Di // 32) * Bz, 8 if N == 32 else 16, 1
    while T < cap and groups * T < 8 * sms and -(-S // (2 * T)) >= 8:
        T *= 2
    assert ops._fn("selective_scan_chunks")(Bz, S, Di, N) == T


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_training_path_matches_plain(cuda, dtype):
    """The differentiable ops.selective_scan (kernel 7 with its carries,
    then the backward kernel) against the plain autograd function, at
    hymba-1.5b's channels over 300 steps from a given h0."""
    u, dt, A, B, C, D, h0 = _scan_inputs(cuda, dtype, 2, 300, 3200, 16, 5)
    dbc = B._base
    dy = torch.randn(2, 300, 3200, generator=torch.Generator().manual_seed(
        6)).to(cuda)

    def leaves():
        d = dbc.clone().requires_grad_(True)
        return ([x.clone().requires_grad_(True) for x in (u, dt, A)]
                + [d[..., 16:32], d[..., 32:], D.clone().requires_grad_(True)],
                d)
    (lu, ldt, lA, lB, lC, lD), d1 = leaves()
    n = ops.selective_scan.launches, ops.selective_scan_bwd.launches
    y, _ = ops.selective_scan(lu, ldt, lA, lB, lC, lD, h0)
    got = torch.autograd.grad(y, [lu, ldt, lA, d1, lD], dy)
    assert (ops.selective_scan.launches,
            ops.selective_scan_bwd.launches) == (n[0] + 1, n[1] + 1)
    (pu, pdt, pA, pB, pC, pD), d2 = leaves()
    r, _ = ref.selective_scan_grad_ref(pu, pdt, pA, pB, pC, pD, h0)
    want = torch.autograd.grad(r, [pu, pdt, pA, d2, pD], dy)
    _assert_scan_close((y,), (r,))
    for a, b in zip(got, want):
        tol = 2e-2 if a.dtype == torch.bfloat16 else 1e-4
        assert (a.float() - b.float()).abs().max().item() <= \
            tol * b.float().abs().max().item()
    with pytest.raises(ValueError, match="h_out"):
        ops.selective_scan(lu, ldt, lA, lB, lC, lD, h0, h_out=h0.clone())


# ---------------------- flash attention: the training path ---------------------
#: the backward's shapes on the training path (chip_smoke.py phase 2):
#: olmo-1b (B 8, S 512, 16 x 128, causal), paligemma-3b (B 4, 256 image
#: tokens + 128 text, 8 x 256 on 1 kv head, prefix-LM), hubert-xlarge (B 8,
#: S 512, 16 x 80, bidirectional), qwen3-moe-30b-a3b (B 8, S 512, 32 x 64
#: on 4 kv heads, causal), hymba-1.5b (B 2, S 2048, 25 x 64 on 5 kv heads,
#: causal, window 1024)
TRAIN_ATTENTION = {
    "olmo-1b": (dict(B=8, S=512, H=16, KV=16, D=128), dict(causal=True)),
    "paligemma-3b": (dict(B=4, S=384, H=8, KV=1, D=256),
                     dict(causal=True, prefix_len=256)),
    "hubert-xlarge": (dict(B=8, S=512, H=16, KV=16, D=80),
                      dict(causal=False)),
    "qwen3-moe-30b-a3b": (dict(B=8, S=512, H=32, KV=4, D=64),
                          dict(causal=True)),
    "hymba-1.5b": (dict(B=2, S=2048, H=25, KV=5, D=64),
                   dict(causal=True, window=1024)),
}


def _bwd_inputs(cuda, dtype, seed, **shape):
    q, k, v, qpos, kpos = (t(a).to(cuda) for a in prefill_case(seed, **shape))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed)
                    ).to(cuda).to(dtype)
    return q, k, v, qpos, kpos, g


def _assert_grads_close(got, want, dtype):
    """Each gradient within the tolerance times its own largest |value|
    (dq and dk carry the 1/sqrt(D) scale, dv does not): the kernel and the
    plain version sum the same fp32 products in another order (2e-2 in
    bf16, whose outputs are rounded to 8 bits; 2e-5 in float32)."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = max(1e-30, b.float().abs().max().item())
        tol = (2e-2 if dtype == torch.bfloat16 else 2e-5) * scale
        err = (a.float() - b.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


def _bwd_against_plain(cuda, dtype, seed, shape, mask):
    """The backward kernel against its plain version on the same forward
    (the plain one's output and lse), twice, equal to the bit."""
    q, k, v, qpos, kpos, g = _bwd_inputs(cuda, dtype, seed, **shape)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, qpos, kpos, **mask)
    n = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, qpos, kpos, out, lse, g, **mask)
    assert ops.flash_attention_bwd.launches == n + 1
    want = ref.flash_attention_bwd_ref(q, k, v, qpos, kpos, out, lse, g, **mask)
    _assert_grads_close(got, want, dtype)
    again = ops.flash_attention_bwd(q, k, v, qpos, kpos, out, lse, g, **mask)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("config", list(TRAIN_ATTENTION))
def test_flash_attention_bwd_kernel_train_shapes(cuda, config, dtype):
    shape, mask = TRAIN_ATTENTION[config]
    _bwd_against_plain(cuda, dtype, 31, shape, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(FLASH_CUDA_CASES))
def test_flash_attention_bwd_kernel_matches_plain(cuda, case, dtype, mask):
    """FLASH_CUDA_CASES (left pads: rows with no visible key, whose P is 1
    on every key; GQA 1 to 8; kv longer than q; head dims 16 to 256) under
    every mask."""
    _bwd_against_plain(cuda, dtype, 32, FLASH_CUDA_CASES[case], MASKS[mask])


#: the bf16 tensor-core body's paths: a kv head's query heads split over a
#: cluster (G 2, 4 and 8 on 1-2 kv heads), head dims 64 and 256, lengths
#: that are no multiple of the 64-row tile, 5 left-pad rows (no visible
#: key); masks that give whole-tile (unmasked), diagonal and skipped tiles
BWD_BODY_CASES = {
    f"g{G}_kv{KV}_d{D}_s{S}": dict(B=2, S=S, H=G * KV, KV=KV, D=D, npad=5)
    for G, KV in ((2, 1), (4, 2), (8, 1)) for D in (64, 256)
    for S in (37, 100, 130)}
BWD_BODY_MASKS = {"causal": dict(causal=True),
                  "window": dict(causal=True, window=128),
                  "prefix_lm": dict(causal=True, prefix_len=70),
                  "bidirectional": dict(causal=False)}


@pytest.mark.cuda
@pytest.mark.parametrize("mask", list(BWD_BODY_MASKS))
@pytest.mark.parametrize("case", list(BWD_BODY_CASES))
def test_flash_attention_bwd_kernel_tensor_core_paths(cuda, case, mask):
    _bwd_against_plain(cuda, torch.bfloat16, 35, BWD_BODY_CASES[case],
                       BWD_BODY_MASKS[mask])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("config", list(TRAIN_ATTENTION))
def test_flash_attention_training_path_matches_plain(cuda, config, dtype):
    """The differentiable ops.flash_attention (kernel 1 with its lse, then
    the backward kernel) against the plain autograd function: the output,
    the lse the forward kept, and the gradients."""
    shape, mask = TRAIN_ATTENTION[config]
    q, k, v, qpos, kpos, g = _bwd_inputs(cuda, dtype, 33, **shape)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    out = ops.flash_attention(*leaves, qpos, kpos, **mask)
    got = torch.autograd.grad(out, leaves, g)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (n[0] + 1, n[1] + 1)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    r = ref.flash_attention_grad_ref(*plain, qpos, kpos, **mask)
    want = torch.autograd.grad(r, plain, g)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(out.detach().float(), r.detach().float(),
                               atol=tol, rtol=tol)
    _assert_grads_close(got, want, dtype)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    ops._flash_forward(q, k, v, qpos, kpos, mask.get("causal", True),
                       mask.get("window", 0), mask.get("prefix_len", 0),
                       ref.FLASH_KV_BLOCK, lse)
    _, lse_ref = ref.flash_attention_fwd_ref(q, k, v, qpos, kpos, **mask)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_of_empty_rows(cuda, dtype):
    """A left-pad row's lse is -1e30, as the JAX forward rounds it, so that
    the backward gives it P = 1 on every key."""
    q, k, v, qpos, kpos = (t(a).to(cuda) for a in prefill_case(
        34, B=2, S=100, H=4, KV=2, D=64, npad=9))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=cuda)
    ops._flash_forward(q, k, v, qpos, kpos, True, 0, 0, ref.FLASH_KV_BLOCK,
                       lse)
    assert (lse[qpos < 0] == ref.NEG_INF).all()
    assert torch.isfinite(lse[qpos >= 0]).all()


@pytest.mark.cuda
def test_forward_only_wrappers_refuse_differentiation(cuda):
    q, kc, vc, spos, qpos = (t(a).to(cuda) for a in
                             decode_case(6, 2, 4, 4, 16, 32))
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.decode_attention(q.requires_grad_(True), kc, vc, spos, qpos)


# ------------------------------ remat on the card -------------------------------
def _state_digest(state):
    """Per-leaf digests of a train state's bits, on the card: each leaf's
    bit patterns as int32, summed plainly and with a weight a position."""
    from repro_torch.training import optim as OPT
    out = []
    for leaf in OPT.leaves(state["params"]) + OPT.leaves(state["opt"]):
        bits = leaf.detach().reshape(-1).view(torch.int32).long()
        w = torch.arange(bits.numel(), device=bits.device) \
            * 2654435761 % 2147483647
        out.append((int(bits.sum()), int((bits * w).sum())))
    return out + [state["step"]]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,B,S", [("olmo-1b", 2, 512),
                                      ("qwen3-moe-30b-a3b", 4, 512),
                                      ("hymba-1.5b", 1, 2048)])
def test_remat_step_equal_to_the_bit_at_full_width(cuda, arch, B, S,
                                                   monkeypatch):
    """One bfloat16 train step at 2 layers of the published config (hymba:
    2048 tokens, its 1024-token window live), deterministic, with remat
    off, "nothing" and "dots": the same loss, gradient norm and state to
    the bit (the recompute launches kernels 1, 6 and 7 again and must
    give the same tensors)."""
    import repro_torch.configs as C
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training import optim as OPT
    from repro_torch.training.data import DataConfig, synthetic_batch
    cfg = C.get_config(arch).replace(num_layers=2)
    batch = synthetic_batch(cfg, DataConfig(batch=B, seq_len=S), 0)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    runs = {}
    try:
        for policy, kw in (("off", dict(remat=False)), ("nothing", {}),
                           ("dots", dict(remat_policy="dots"))):
            state = ST.init_train_state(
                cfg, torch.Generator("cuda").manual_seed(0), "cuda")
            step = ST.make_train_step(
                cfg, ShapeSpec("t", S, B, "train"),
                opt_cfg=OPT.AdamWConfig(lr=3e-3, warmup_steps=2,
                                        total_steps=10), **kw)
            n = ops.flash_attention.launches + ops.gmm.launches \
                + ops.selective_scan.launches
            state, m = step(state, batch)
            runs[policy] = (m["loss"].item(), m["grad_norm"].item(),
                            _state_digest(state),
                            ops.flash_attention.launches + ops.gmm.launches
                            + ops.selective_scan.launches - n)
            del state, step
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was)
    for policy in ("nothing", "dots"):
        assert runs[policy][:3] == runs["off"][:3], policy
        # the recompute launches each layer's forward kernels once more
        assert runs[policy][3] == 2 * runs["off"][3] > 0, policy


@pytest.mark.cuda
def test_frontdoor_torch_model_three_concurrent_sessions(cuda, monkeypatch):
    """The front door over PATH 'torch:olmo-1b' (its published config,
    random weights) on the card: three concurrent sessions stream their
    rows, each closed by an ok trailer, every value a string of the
    grammar; the kernels are loaded at first use from the inference
    service's worker thread (the libraries were dropped first)."""
    import threading

    from repro_torch.core.database import IPDB
    from repro_torch.frontdoor import FrontDoor, FrontDoorClient
    from repro_torch.relational.table import Table
    build_threads = []
    real_build = ops.build

    def build(*a, **k):
        build_threads.append(threading.current_thread().name)
        return real_build(*a, **k)
    monkeypatch.setattr(ops, "build", build)
    monkeypatch.setattr(ops, "_fns", {})
    ops.reset_launches()
    db = IPDB()
    for i in range(3):
        db.register_table(f"T{i}", Table.from_rows(
            [{"name": f"t{i} item {j}"} for j in range(4)]))
    db.sql("CREATE LLM MODEL m PATH 'torch:olmo-1b' ON PROMPT OPTIONS { "
           "'config': 'full', 'batch_size': 1, 'num_slots': 4, "
           "'max_tokens': 48, 'max_str': 6 }")
    results = [None] * 3
    with db, FrontDoor(db, max_sessions=3) as fd:
        def one(i):
            results[i] = list(FrontDoorClient(fd.host, fd.port).query(
                f"SELECT name, LLM m (PROMPT 'the {{color VARCHAR}} of "
                f"{{{{name}}}}') AS color FROM T{i}",
                tenant=f"tenant{i % 2}").frames())
        threads = [threading.Thread(target=one, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    for frames in results:
        trailer = frames[-1]
        assert trailer["type"] == "trailer" and trailer["status"] == "ok"
        assert trailer["rows"] == 4 and trailer["stats"]["decode_tokens"] > 0
        colors = [r["color"] for f in frames if f["type"] == "chunk"
                  for r in f["rows"]]
        assert len(colors) == 4
        assert all(isinstance(c, str) and len(c) <= 6 for c in colors)
    assert build_threads and "MainThread" not in build_threads
    for k in ("flash_attention", "decode_attention", "constrained_sample"):
        assert ops.WRAPPERS[k].launches > 0, k


# --------------------- the mesh's rank-local kernel shapes ----------------------
#: kernel 1 with its backward at the shapes one rank of a 16-wide model axis
#: gives it (query heads / 16 with the kv heads they read): olmo-1b 1 on 1,
#: qwen3-moe-30b-a3b 2 on 1 (inside one GQA group), yi-6b 2 on 1 (head dim
#: 128); 2 rows of 512 tokens
RANK_LOCAL_ATTENTION = {
    "olmo-1b": dict(B=2, S=512, H=1, KV=1, D=128),
    "qwen3-moe-30b-a3b": dict(B=2, S=512, H=2, KV=1, D=64),
    "yi-6b": dict(B=2, S=512, H=2, KV=1, D=128),
}


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(RANK_LOCAL_ATTENTION))
def test_flash_attention_training_path_rank_local(cuda, config):
    """The differentiable ops.flash_attention in bf16 at a rank's heads
    against the plain autograd function."""
    q, k, v, qpos, kpos, g = _bwd_inputs(cuda, torch.bfloat16, 35,
                                         **RANK_LOCAL_ATTENTION[config])
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    n = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    out = ops.flash_attention(*leaves, qpos, kpos, causal=True)
    got = torch.autograd.grad(out, leaves, g)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (n[0] + 1, n[1] + 1)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    r = ref.flash_attention_grad_ref(*plain, qpos, kpos, causal=True)
    want = torch.autograd.grad(r, plain, g)
    torch.testing.assert_close(out.detach().float(), r.detach().float(),
                               atol=2e-2, rtol=2e-2)
    _assert_grads_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("Di", [512, 200, 4096])
def test_selective_scan_training_path_rank_local(cuda, Di):
    """The differentiable ops.selective_scan in bf16 at a rank's d_inner
    channels: falcon-mamba-7b's 8192 over 16 (512) and over 2 (4096),
    hymba-1.5b's 3200 over 16 (200)."""
    u, dt, A, B, C, D, h0 = _scan_inputs(cuda, torch.bfloat16, 2, 300, Di,
                                         16, 7)
    dbc = B._base
    dy = torch.randn(2, 300, Di, generator=torch.Generator().manual_seed(
        8)).to(cuda)

    def leaves():
        d = dbc.clone().requires_grad_(True)
        return ([x.clone().requires_grad_(True) for x in (u, dt, A)]
                + [d[..., 16:32], d[..., 32:], D.clone().requires_grad_(True)],
                d)
    (lu, ldt, lA, lB, lC, lD), d1 = leaves()
    y, _ = ops.selective_scan(lu, ldt, lA, lB, lC, lD)
    got = torch.autograd.grad(y, [lu, ldt, lA, d1, lD], dy)
    (pu, pdt, pA, pB, pC, pD), d2 = leaves()
    r, _ = ref.selective_scan_grad_ref(pu, pdt, pA, pB, pC, pD)
    want = torch.autograd.grad(r, [pu, pdt, pA, d2, pD], dy)
    _assert_scan_close((y,), (r,))
    for a, b in zip(got, want):
        tol = 2e-2 if a.dtype == torch.bfloat16 else 1e-4
        assert (a.float() - b.float()).abs().max().item() <= \
            tol * b.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("E,M,N", [(8, 2048, 768), (64, 2048, 768),
                                   (8, 6144, 1024)])
def test_gmm_training_path_rank_local(cuda, E, M, N):
    """The differentiable ops.gmm in bf16 at a rank's experts: qwen3-moe's
    128 experts over 16 (8) and over 2 (64), and mixtral-8x22b's 8
    experts at d_ff 16384 over 16 (1024)."""
    x, w, g, dy = _gmm_bwd_case(cuda, torch.bfloat16, E, M, N, 9)
    leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    got = torch.autograd.grad(ops.gmm(*leaves, g), leaves, dy)
    plain = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)]
    want = torch.autograd.grad(ref.gmm_grad_ref(*plain, g), plain, dy)
    for a, b in zip(got, want):
        assert (a.float() - b.float()).abs().max().item() <= \
            2e-2 * b.float().abs().max().item()


@pytest.mark.cuda
def test_one_by_one_nccl_mesh_step_equal_to_the_bit(cuda, tmp_path,
                                                    monkeypatch):
    """A world of one with NCCL, a 1 x 1 mesh: one bf16 train step of
    qwen3-moe-30b-a3b at full width and 2 layers equals the one-device
    step to the bit (deterministic) and moves no collective byte."""
    import torch.distributed as dist

    import repro_torch.configs as C
    from repro_torch.launch import dist as D
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training import optim as OPT
    from repro_torch.training.data import DataConfig, synthetic_batch
    cfg = C.get_config("qwen3-moe-30b-a3b").replace(num_layers=2)
    batch = synthetic_batch(cfg, DataConfig(batch=2, seq_len=512), 0)
    D.init_world(0, 1, str(tmp_path / "store"))
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    runs = []
    try:
        mesh = D.Mesh({"data": 1, "model": 1})
        for m in (None, mesh):
            state = ST.init_train_state(
                cfg, torch.Generator("cuda").manual_seed(0), "cuda", mesh=m)
            step = ST.make_train_step(
                cfg, ShapeSpec("t", 512, 2, "train"), mesh=m,
                opt_cfg=OPT.AdamWConfig(lr=1e-3, warmup_steps=0))
            state, met = step(state, batch)
            runs.append(({k: v.item() for k, v in met.items()},
                         _state_digest(state)))
            del state, step
            torch.cuda.empty_cache()
        assert sum(mesh.bytes.values()) == 0
    finally:
        torch.use_deterministic_algorithms(was)
        dist.destroy_process_group()
    assert runs[0] == runs[1]
