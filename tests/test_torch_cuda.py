"""The Hopper kernels of repro_torch against their plain PyTorch versions,
on the card.  Every test is marked ``cuda`` and skips without a GPU: a CUDA
kernel has no interpret mode.  The file imports no jax, so it runs on a GPU
machine without the JAX package:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Tolerances: float32 1e-5 (the kernel sums in another order than the plain
einsum); bfloat16 2e-2 (inputs and outputs rounded to 8 mantissa bits).
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
forward's lse 1e-4.
"""
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


# ---------------------- flash attention: the training path ---------------------
#: the backward's shapes on the training path (chip_smoke.py phase 2):
#: olmo-1b (B 8, S 512, 16 x 128, causal), paligemma-3b (B 4, 256 image
#: tokens + 128 text, 8 x 256 on 1 kv head, prefix-LM), hubert-xlarge (B 8,
#: S 512, 16 x 80, bidirectional)
TRAIN_ATTENTION = {
    "olmo-1b": (dict(B=8, S=512, H=16, KV=16, D=128), dict(causal=True)),
    "paligemma-3b": (dict(B=4, S=384, H=8, KV=1, D=256),
                     dict(causal=True, prefix_len=256)),
    "hubert-xlarge": (dict(B=8, S=512, H=16, KV=16, D=80),
                      dict(causal=False)),
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
