#!/usr/bin/env python3
"""Drive repro_torch's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root; needs one GPU
    python3 chip_smoke.py --only gmm,flash_attention   # phases 1-2 only
    python3 chip_smoke.py --only selective_scan,decode_attention_paged_quant
    python3 chip_smoke.py --only flash_attention_bwd
    python3 chip_smoke.py --only flash_attention_bwd --compare-bwd PARENT_CU

Phases, each reported on its own lines:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   Hopper kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a, one
   process per source, all started together), with one line per kernel of
   every source (``PTXAS_SOURCES``) giving what ``nvcc -Xptxas -v``
   reports: registers, shared memory, spills;
2. each kernel at the shapes the SQL paths give it, in bfloat16 and float32,
   once for each config whose paths run it (olmo-1b's 16 heads x 128 and
   vocabulary, qwen3-moe-30b-a3b's 32 heads x 64 on 4 kv heads and
   vocabulary, its experts for the grouped matmul, hymba-1.5b's 25 heads x
   64 on 5 kv heads, window 1024 and vocabulary, falcon-mamba-7b's
   vocabulary, and both SSM configs' channels for the selective scan; the
   flash backward at the training path's shapes, phase 6): its
   largest error against its plain PyTorch version (tolerance stated), and
   the times of the kernel, the plain version and one PyTorch library call
   computing the same function where there is one (a yardstick only; the
   port never calls it), beside the least time the card could take
   (``bound_ms``: the bytes the function needs over the memory rate, or
   its operations over the peak rate, the larger); for every kernel also
   the profiler's device time of the kernel alone (``device_ms``), for the
   selective scan the host time of its wrapper per call (``host_ms``), for
   C the same numbers over int8 frozen prefix pages, for the paged
   decode kernels A and B the (splits, warps) of their launch, and for the
   flash backward its design (body, split of the query heads, ring stages;
   P and dS always keep their low half), its device time per launch, the
   training forward's bound and SDPA forward, and SDPA's backward with a
   bool mask and with the least-masked arguments (``--compare-bwd`` also
   times the parent's backward, built for that call, in turns with this
   one, alone and in warm train steps of the three training
   configurations, with one profiled step of each);
3. the olmo-1b configuration at full width (16 layers, d_model 2048, vocab
   50304, random weights from a seeded generator; dense family):
   a. float32 logits of a prefill and decode steps through the kernels
      against the plain attention (dense layout), and of a paged prefill
      over a radix-committed prefix plus decode steps against the dense
      path's logits and, with fp and with int8 pages, against the plain
      attention;
   b. in bfloat16, the dense SQL path through ``repro_torch``'s IPDB (16
      rows through the continuous batcher, one row through ``generate``,
      4 rows with ``n_samples`` 3), then the paged path (``kv_layout
      'paged'``, pages of 64, radix prefix tree) in two sessions, fp pages
      and int8 pages, each over the same 16 rows and the same 4 rows with
      ``n_samples`` 3.  Each path's kernel launches are counted from zero
      around it, every answer must parse under the grammar, the paged
      queries must hit the radix tree and the ``n_samples`` queries must
      fork copy-on-write pages.  One warm query of each layout, and one
      of the int8 pages, is profiled;
4. the qwen3-moe-30b-a3b configuration (MoE family: 128 experts, top-8,
   d_ff 768, 32 heads x 64 on 4 kv heads, vocab 151936, random weights):
   a. at full width and 4 of its 48 layers in float32, the logits of a
      left-padded prefill and three decode steps, dense and paged (fp pages
      over a radix-committed prefix), through the kernels against the plain
      versions (attention and the grouped matmul);
   b. at full width and full depth in bfloat16 (~60 GB of weights), after
      the olmo sessions are freed: the dense SQL path (16 rows through the
      batcher, one row through ``generate``) and one paged query (pages of
      64, radix tree, which it must hit), kernel launches counted from zero
      around them, every answer parsed; one warm dense query profiled;
5. the ssm and hybrid families (Mamba-1 mixers through the selective-scan
   kernel, random weights): falcon-mamba-7b (64 layers, d_model 4096,
   d_inner 8192, state 16, vocab 65024) and hymba-1.5b (32 layers, d_model
   1600, 25 heads x 64 on 5 kv heads, window 1024, d_inner 3200, vocab
   32001):
   a. float32 logits of a left-padded prefill and three decode steps
      through the kernels against the plain versions (the scan and
      attention): falcon-mamba at full width and 4 of its 64 layers,
      hymba at full width and depth;
   b. in bfloat16 after the MoE session is freed, at full width and depth:
      falcon-mamba (~14.5 GB of weights) through the dense batcher (16
      rows), ``generate`` (one row) and 4 rows with ``n_samples`` 3, its
      launches counted as the ``ssm`` path, one warm query profiled; then
      hymba through the batcher and ``generate``, counted as the ``hybrid``
      path; every answer parsed (both families run the dense layout only:
      the paged layout needs attention and no sliding window);
6. the training path (the dense, VLM and encoder families; kernel 1 with
   its lse and the flash backward, ``flash_attention_bwd.cu``, which phase
   2 checks at each trained config's shapes: olmo-1b's B 8 x 512 tokens of
   16 heads x 128, causal; paligemma-3b's B 4 x (256 image + 128 text) of
   8 x 256 on 1 kv head, prefix-LM; hubert-xlarge's B 8 x 512 of 16 x 80,
   bidirectional), after the hybrid session is freed:
   a. one train step in float32 at full width and 2 layers of each of the
      three configs: logits, loss and the gradient of every master leaf
      through the kernels against the plain autograd function;
   b. ``repro_torch.launch.train`` in bfloat16 compute with float32 master
      weights and AdamW state: olmo-1b at full width and depth for 8 steps,
      deterministic (the loss must fall); 4 steps, a checkpoint, a restore
      and 4 more, which must equal the 8 to the bit; hubert-xlarge at full
      width and depth and paligemma-3b at full width and depth for 4 steps
      each (at the driver's own 20 warm-up steps);
      step times, tokens/s, model FLOP/s over the bf16 peak and peak
      memory, one warm step of each profiled; the launches counted as the
      ``train`` path;
7. a JSON line with every kernel's numbers at the dtype its path gives it,
   then the last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no last
line.  Without a GPU it exits 2 at once.  ``--only`` runs phases 1 and 2
for the named kernels, prints their JSON line and stops, without the last
line (for comparing kernel versions on one card in one call).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
L2_BYTES = 50e6                           # H100 SXM L2 cache
PEAK_FLOPS = {torch.bfloat16: 989e12,     # dense tensor core
              torch.float32: 67e12}       # fp32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
SEED = 0

# main-path shapes, to which path_shapes adds each config's heads and padded
# vocabulary: 8 decode slots over a 512-token ring cache
DEC = dict(B=8, L=512)
PRE = dict(B=1, S=256, prompt=225)      # the 256-token bucket
SAMPLE = dict(B=8, allowed=259, temperature=0.7)
# the paged path: 8 slots, pages of 64 tokens, tables bucketed to 8 blocks
# (max_len 512); each row holds its ~225-token prompt plus 0-64 decoded
# tokens (fills 225-289), and its first 3 pages (192 tokens) are the
# radix-matched prompt prefix that every row shares; prefill of a 33-token
# suffix in the 64-token bucket over those 3 pages
PAGED = dict(B=8, ps=64, NB=8, shared=3, fills=(225, 289))
PRE_PAGED = dict(B=1, S=64, ps=64, npre=3, suffix=33)
# the MoE path's grouped matmuls: 8 decode slots or one 256-token prefill;
# qwen3-moe-30b-a3b's top-8 of 128 experts, each expert's choices capped at
# the capacity (4 at decode, 20 at prefill), gate/up (2048 -> 768) and down
# (768 -> 2048)
GMM = dict(calls={"decode": 8, "prefill": 256})
# the selective scan of every mixer layer: one 256-token prefill bucket from
# the cache's state, and a decode tick over 8 slots (one step from the
# carried state, written in place)
SCAN = dict(calls={"decode": (8, 1), "prefill": (1, 256)})
DENSE_ARCH = "olmo-1b"
MOE_ARCH = "qwen3-moe-30b-a3b"
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "hymba-1.5b"
VLM_ARCH = "paligemma-3b"
ENC_ARCH = "hubert-xlarge"
# the training path: global batch and sequence length of each trained config
# (paligemma: 256 image-patch embeddings + 128 text tokens)
TRAIN = {DENSE_ARCH: dict(B=8, S=512), VLM_ARCH: dict(B=4, S=384),
         ENC_ARCH: dict(B=8, S=512)}


def path_shapes(cfg) -> dict:
    """Each kernel's shapes on a config's SQL paths: the slots, buckets,
    prompt and pages above with the config's (padded) query heads, kv heads,
    head dim, window and padded vocabulary where it has attention, its
    experts and widths for the grouped matmul where it has experts, and
    its channels and state size for the selective scan where it has a
    mixer."""
    out = {"constrained_sample": dict(SAMPLE, V=cfg.padded_vocab)}
    if cfg.has_attention:
        heads = dict(H=cfg.padded_heads, KV=cfg.num_kv_heads, D=cfg.head_dim)
        out.update({
            "flash_attention": dict(PRE, window=cfg.sliding_window, **heads),
            "decode_attention": dict(DEC, **heads),
            "decode_attention_paged": dict(PAGED, **heads),
            "decode_attention_paged_quant": dict(PAGED, **heads),
            "flash_attention_prefix": dict(PRE_PAGED, **heads)})
    if cfg.has_moe:
        out["gmm"] = dict(GMM, E=cfg.num_experts, K=cfg.top_k,
                          d_model=cfg.d_model, d_ff=cfg.d_ff)
    if cfg.has_ssm:
        out["selective_scan"] = dict(SCAN, Di=cfg.d_inner, N=cfg.ssm_state)
    if cfg.name in TRAIN:
        out["flash_attention_bwd"] = dict(
            TRAIN[cfg.name], H=cfg.padded_heads, KV=cfg.num_kv_heads,
            D=cfg.head_dim, causal=cfg.causal,
            prefix_len=cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    return out


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def time_ms(fn, inputs, iters=40, warmup=3) -> float:
    """Mean device time of fn(*inputs[i % len(inputs)]) over `iters` calls,
    timed with CUDA events.  Several input sets rotate so that, where they
    exceed the 50 MB L2 cache together, every call reads cold memory as the
    real caller does."""
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, args, kernel: str, iters=20, tries=3):
    """The device time of one launch of `kernel` (a substring of its
    symbol) in fn(*args), from the profiler: without the host's share,
    which time_ms's events include whenever the wrapper's Python and
    launch take longer than the kernel.  A profiled window that recorded
    no launch of the kernel (the profiler drops a window now and then) is
    taken again; None, printed as "not measured", if all `tries` did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(tries):
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and kernel in e.key)
        if total > 0:
            return total / 1e3 / iters
    return None


def host_ms(fn, args, iters=200) -> float:
    """The host time of one call of fn(*args): the wall time of `iters`
    calls enqueued back to back, before the device is waited for (the
    device finishes each call faster than the host enqueues the next)."""
    fn(*args)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    ms = (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def rotations(needed_bytes: float) -> int:
    """How many input sets a timing rotates through: enough that the bytes
    the calls need exceed twice the L2 together, so that every call reads
    cold HBM as the real caller does (at least 6, at most 64)."""
    return int(min(64, max(6, -(-2 * L2_BYTES // max(needed_bytes, 1)))))


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


#: the kernel sources whose kernels' resources, as ``nvcc -Xptxas -v``
#: reports them, are printed after the build
PTXAS_SOURCES = ("gmm.cu", "flash_attention.cu", "decode_attention.cu",
                 "constrained_sample.cu", "decode_attention_paged.cu",
                 "selective_scan.cu", "flash_attention_bwd.cu")


def ptxas_resources(log: str) -> list:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its (demangled)
    name, registers, static shared memory and spills."""
    names, out, cur, spill = [], [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1]
        elif "bytes stack frame" in line and cur:
            spill = line.strip()
        elif "Used" in line and "registers" in line and cur:
            names.append(cur)
            out.append(line.split(":", 1)[1].strip() + "; " + spill)
            cur, spill = None, ""
    try:
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
    except (OSError, subprocess.CalledProcessError):
        pass
    lines = []
    for n, o in zip(names, out):
        # the name and its first argument's type (overloads differ there)
        n = n.replace("(anonymous namespace)::", "").removeprefix("void ")
        name, _, args = n.partition("(")
        first = args.split(",")[0].rstrip(")")
        lines.append(f"{name}({first}{', ...' if ',' in args else ''}): {o}")
    return lines


# ------------------------------ phase 2: kernels -------------------------------
def check_decode(ops, ref, dtype, gen, shape):
    B, L, H, KV, D = (shape[k] for k in ("B", "L", "H", "KV", "D"))
    dev = "cuda"
    fills = torch.randint(96, 321, (B,), generator=gen, device=dev)
    spos = torch.arange(L, device=dev, dtype=torch.int32).repeat(B, 1)
    spos[spos >= fills[:, None]] = -1
    qpos = (fills - 1).to(torch.int32)
    valid = (spos >= 0).sum().item()
    s = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * B * H * D * s + 2 * valid * KV * D * s + B * L * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * valid * H * D, dtype)
    sets = []
    for _ in range(rotations(nbytes)):
        q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
        kc = torch.randn(B, L, KV, D, generator=gen, device=dev).to(dtype)
        vc = torch.randn(B, L, KV, D, generator=gen, device=dev).to(dtype)
        sets.append((q, kc, vc, spos, qpos))
    out = ops.decode_attention(*sets[0])
    err = (out.float() - ref.decode_attention_ref(*sets[0]).float()).abs().max()
    mask = (spos >= 0)[:, None, None, :]
    lib_sets = [(q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2))
                for q, kc, vc, _, _ in sets]

    def library(q4, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=H != KV)
    return dict(max_abs_err=err.item(),
                ms=time_ms(ops.decode_attention, sets),
                device_ms=device_ms(ops.decode_attention, sets[0],
                                    "decode_attention_kernel"),
                plain_ms=time_ms(ref.decode_attention_ref, sets),
                library_ms=time_ms(library, lib_sets),
                bound_ms=b_ms, bound_by=b_by)


def check_flash(ops, ref, dtype, gen, shape):
    B, S, H, KV, D, n, W = (shape[k] for k in ("B", "S", "H", "KV", "D",
                                                "prompt", "window"))
    dev = "cuda"
    pos = (torch.arange(S, device=dev, dtype=torch.int32) - (S - n)).repeat(B, 1)
    pos[pos < 0] = -1                   # left padding, as engine._prefill
    valid = pos >= 0
    s = torch.tensor([], dtype=dtype).element_size()
    # causal (query, key) pairs per head, inside the window
    pairs = B * sum(min(i + 1, W or n) for i in range(n))
    # q/k/v rows of real tokens (pad rows are never needed), the whole
    # output, and the positions once (queries and keys share them)
    rows = int(valid.sum())
    nbytes = rows * (H + 2 * KV) * D * s + B * S * H * D * s + pos.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * pairs * H * D, dtype)
    sets = []
    for _ in range(rotations(nbytes)):
        q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        sets.append((q, k, v, pos, pos))
    kernel = functools.partial(ops.flash_attention, window=W)
    plain = functools.partial(ref.flash_attention_ref, window=W)
    out = kernel(*sets[0])
    err = (out[valid].float() - plain(*sets[0])[valid].float()).abs().max()
    if not torch.isfinite(out.float()).all():
        fail("flash_attention: non-finite output on pad rows")
    mask = ((pos[:, None, :] <= pos[:, :, None]) & (pos[:, None, :] >= 0))
    if W:
        mask &= pos[:, None, :] > pos[:, :, None] - W

    def library(q, k, v, _qpos, _kpos):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=H != KV)
    return dict(max_abs_err=err.item(),
                ms=time_ms(kernel, sets),
                device_ms=device_ms(kernel, sets[0], "flash_attention_kernel"),
                plain_ms=time_ms(plain, sets),
                library_ms=time_ms(library, sets),
                bound_ms=b_ms, bound_by=b_by)


def check_sample(ops, ref, dtype, gen, shape):
    B, V, A, T = (shape[k] for k in ("B", "V", "allowed", "temperature"))
    dev = "cuda"
    logits = torch.randn(B, V, generator=gen, device=dev).to(dtype)
    mask = torch.zeros(B, V, dtype=torch.int8, device=dev)
    mask[:, :A] = (torch.rand(B, A, generator=gen, device=dev) < 0.5).to(
        torch.int8)
    mask[:, 0] = 1                      # the grammar allows a few byte tokens
    u = torch.rand(B, V, generator=gen, device=dev, dtype=torch.float64)
    noise = -torch.log(-torch.log(u.clamp_min(1e-9)))
    args = (logits, mask, noise)
    out = ops.constrained_sample(*args, temperature=T)
    want = ref.constrained_sample_ref(*args, temperature=T)
    greedy = ops.constrained_sample(logits, mask, None)
    if not (torch.equal(out, want) and torch.equal(
            greedy, ref.constrained_sample_ref(logits, mask, None))):
        fail(f"constrained_sample {dtype}: tokens differ from the plain version")
    # the whole mask, a logit and its float64 noise where the mask allows
    # the entry, the tokens out
    n_allowed = int(mask.sum())
    nbytes = B * V + n_allowed * (logits.element_size() + 8) + B * 4
    b_ms, b_by = bound(nbytes, 3 * n_allowed, torch.float32)
    allowed = mask.bool()

    def library():
        return torch.argmax(torch.where(allowed, logits / T + noise, -1e30), -1)
    def kernel(*a):
        return ops.constrained_sample(*a, temperature=T)
    return dict(max_abs_err=0.0,
                ms=time_ms(kernel, [args]),
                device_ms=device_ms(kernel, args, "constrained_sample_kernel"),
                plain_ms=time_ms(lambda *a: ref.constrained_sample_ref(
                    *a, temperature=T), [args]),
                library_ms=time_ms(library, [()]),
                bound_ms=b_ms, bound_by=b_by)


def paged_tables(gen, shape, dev="cuda"):
    """Block tables of the paged decode path: B rows with fills drawn from
    shape["fills"]; each row's first `shared` pages are the same pool pages
    (the radix-shared prompt prefix), then its own pages up to its fill
    plus 64 tokens of decode capacity (the engine allocates ahead), -1
    after."""
    B, ps, NB, sh = (shape[k] for k in ("B", "ps", "NB", "shared"))
    lo, hi = shape["fills"]
    fills = torch.randint(lo, hi + 1, (B,), generator=gen, device=dev).tolist()
    table = torch.full((B, NB), -1, dtype=torch.int32)
    nxt = sh
    for b, f in enumerate(fills):
        cap = min(NB, -(-(f + 64) // ps))
        table[b, :sh] = torch.arange(sh)
        table[b, sh:cap] = torch.arange(nxt, nxt + cap - sh)
        nxt += cap - sh
    qpos = torch.tensor([f - 1 for f in fills], dtype=torch.int32)
    return table.to(dev), qpos.to(dev), fills, nxt


def quantize_pages(kp, frozen):
    """The engine's int8 shadow of the pages `frozen` of a (KV, P, ps, D)
    pool (kernels A/B/C read it where flags > 0): per-(kv-head, page)
    scale = abs-max / 127, round half to even."""
    src = kp.float()
    scale = torch.clamp(src.abs().amax(dim=(2, 3)), min=1e-8) / 127.0
    q8 = torch.clamp(torch.round(src / scale[..., None, None]), -127,
                     127).to(torch.int8)
    flags = torch.zeros(kp.shape[1], dtype=torch.int8, device=kp.device)
    flags[frozen] = 1
    return q8, scale.contiguous(), flags


def _dequant(pool, q8, scale, flags):
    fr = (flags > 0)[None, :, None, None]
    return torch.where(fr, (q8.float() * scale[..., None, None]).to(
        pool.dtype), pool)


def paged_split_shape(ops, dtype, quant, shape, P):
    """The (splits, warps) with which kernel A (or B, `quant`) launches at
    `shape`, as the library picks them (a query: nothing is launched)."""
    fn = ops.build()["decode_attention_paged.cu"] \
        .repro_decode_attention_paged_shape
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    err = fn(ops._DTYPES[dtype], int(quant), *(shape[k] for k in (
        "B", "H", "KV")), P, shape["ps"], shape["NB"], shape["D"], out)
    if err:
        fail(f"decode_attention_paged shape query: CUDA error {err}")
    return out[0], out[1]


def check_decode_paged(ops, ref, dtype, gen, shape, quant=False):
    """Kernel A (fp pages) or B (`quant`: the shared prefix pages frozen in
    int8, as the radix tree freezes committed prompt pages).  Also reports
    the (splits, warps) the kernel launches with there."""
    B, H, KV, D, ps, NB, sh = (shape[k] for k in
                               ("B", "H", "KV", "D", "ps", "NB", "shared"))
    dev = "cuda"
    table, qpos, fills, P = paged_tables(gen, shape)
    s = torch.tensor([], dtype=dtype).element_size()
    # needed: each valid token's K and V once -- the shared pages' tokens
    # once for all rows, at 1 byte per element (plus two scales per kv head
    # and page) when frozen -- q, out, the table and the positions
    shared_tok = sh * ps
    own_tok = sum(f - shared_tok for f in fills)
    kv_row = 2 * KV * D
    nbytes = (own_tok * kv_row * s + 2 * B * H * D * s
              + table.numel() * 4 + B * 4
              + (shared_tok * kv_row + sh * KV * 2 * 4 if quant
                 else shared_tok * kv_row * s))
    b_ms, b_by = bound(nbytes, 4 * sum(fills) * H * D, dtype)
    sets = []
    for _ in range(rotations(nbytes)):
        q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
        kp = torch.randn(KV, P, ps, D, generator=gen, device=dev).to(dtype)
        vp = torch.randn(KV, P, ps, D, generator=gen, device=dev).to(dtype)
        args = [q, kp, vp, table, qpos]
        if quant:
            kq, ks, flags = quantize_pages(kp, list(range(sh)))
            vq, vs, _ = quantize_pages(vp, list(range(sh)))
            args.append({"kq": kq, "vq": vq, "kscale": ks, "vscale": vs,
                         "flags": flags})
        sets.append(tuple(args))
    fn, name = (ops.decode_attention_paged_quant,
                "decode_attention_paged_quant_kernel") if quant else \
        (ops.decode_attention_paged, "decode_attention_paged_kernel")
    plain = ref.decode_attention_paged_ref
    err = (fn(*sets[0]).float() - plain(*sets[0]).float()).abs().max()
    pos = torch.arange(NB * ps, device=dev)
    mask = ((table >= 0).repeat_interleave(ps, dim=1)
            & (pos[None, :] <= qpos[:, None].long()))[:, None, None, :]
    tl = table.long().clamp(min=0)

    def library(q, kp, vp, _t, _p, qd=None):
        if qd is not None:
            kp = _dequant(kp, qd["kq"], qd["kscale"], qd["flags"])
            vp = _dequant(vp, qd["vq"], qd["vscale"], qd["flags"])
        k = kp[:, tl].permute(1, 0, 2, 3, 4).reshape(B, KV, NB * ps, D)
        v = vp[:, tl].permute(1, 0, 2, 3, 4).reshape(B, KV, NB * ps, D)
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=H != KV)
    splits, warps = paged_split_shape(ops, dtype, quant, shape, P)
    return dict(max_abs_err=err.item(), ms=time_ms(fn, sets),
                device_ms=device_ms(fn, sets[0], name),
                plain_ms=time_ms(plain, sets),
                library_ms=time_ms(library, sets),
                bound_ms=b_ms, bound_by=b_by, splits=splits, warps=warps)


def check_flash_prefix(ops, ref, dtype, gen, shape):
    """Kernel C: one slot's suffix prefill over the radix-matched prefix
    pages; the error is the larger of the fp and the int8-page variant."""
    B, S, H, KV, D, ps, npre, n = (shape[k] for k in (
        "B", "S", "H", "KV", "D", "ps", "npre", "suffix"))
    dev = "cuda"
    plen, P = npre * ps, 4 * npre
    pos = (torch.arange(S, device=dev, dtype=torch.int32) - (S - n)
           + plen).repeat(B, 1)
    pos[:, :S - n] = -1                 # left padding, as engine.paged_prefill
    ptab = torch.randperm(P, generator=gen, device=dev)[:npre].to(torch.int32)
    valid = pos >= 0
    s = torch.tensor([], dtype=dtype).element_size()
    rows = int(valid.sum())
    # q/k/v of real suffix tokens, the whole output, the positions, the
    # prefix pages' K/V once and the prefix table
    nbytes = (rows * (H + 2 * KV) * D * s + B * S * H * D * s
              + pos.numel() * 4 + 2 * plen * KV * D * s + npre * 4)
    flops = 4 * H * D * (rows * plen + B * n * (n + 1) // 2)
    b_ms, b_by = bound(nbytes, flops, dtype)
    sets = []
    for _ in range(rotations(nbytes)):
        q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        kp = torch.randn(KV, P, ps, D, generator=gen, device=dev).to(dtype)
        vp = torch.randn(KV, P, ps, D, generator=gen, device=dev).to(dtype)
        sets.append((q, k, v, pos, kp, vp, ptab, plen))
    qsets = []
    for args in sets:
        kq, ks, flags = quantize_pages(args[4], ptab.long())
        vq, vs, _ = quantize_pages(args[5], ptab.long())
        qsets.append(args + ({"kq": kq, "vq": vq, "kscale": ks, "vscale": vs,
                              "flags": flags},))
    err = max((ops.flash_attention_prefix(*args).float()
               - ref.flash_attention_prefix_ref(*args).float()
               )[valid].abs().max().item() for args in (sets[0], qsets[0]))
    tl = ptab.long()
    mask = torch.cat([(pos >= 0)[:, :, None].expand(B, S, plen),
                      (pos[:, None, :] <= pos[:, :, None])
                      & (pos[:, None, :] >= 0)], dim=2)[:, None]

    def library(q, k, v, _pos, kp, vp, _ptab, _plen, qd=None):
        if qd is not None:
            kp = _dequant(kp, qd["kq"], qd["kscale"], qd["flags"])
            vp = _dequant(vp, qd["vq"], qd["vscale"], qd["flags"])
        kpre = kp[:, tl].reshape(KV, plen, D)[None].expand(B, -1, -1, -1)
        vpre = vp[:, tl].reshape(KV, plen, D)[None].expand(B, -1, -1, -1)
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), torch.cat([kpre, k.transpose(1, 2)], 2),
            torch.cat([vpre, v.transpose(1, 2)], 2), attn_mask=mask,
            enable_gqa=H != KV)
    fn, name = ops.flash_attention_prefix, "flash_attention_prefix_kernel"
    # the int8 pages' numbers: the kernel reads the frozen pages' int8
    # shadows, the library call dequantizes them first
    int8 = dict(ms=time_ms(fn, qsets), device_ms=device_ms(fn, qsets[0], name),
                library_ms=time_ms(library, qsets))
    print(f"  flash_attention_prefix {str(dtype)[6:]} int8 pages: ms "
          f"{int8['ms']:.4f} (device_ms {fmt_ms(int8['device_ms'])}) "
          f"library_ms "
          f"(dequantize, prefix gather + SDPA) {int8['library_ms']:.4f}",
          flush=True)
    return dict(max_abs_err=err, ms=time_ms(fn, sets),
                device_ms=device_ms(fn, sets[0], name),
                plain_ms=time_ms(ref.flash_attention_prefix_ref, sets),
                library_ms=time_ms(library, sets),
                bound_ms=b_ms, bound_by=b_by, int8_pages=int8)


def gmm_case(gen, shape, tokens, M, N, dtype):
    """Group sizes drawn as the router makes them -- each token picks K
    distinct experts uniformly, each expert keeps at most the capacity --
    and x (tokens * K rows, the dropped choices past the kept ones), w."""
    from repro_torch.models.moe import capacity
    E, K = shape["E"], shape["K"]
    C = capacity(tokens, E, K, 1.25)
    picks = torch.rand(tokens, E, generator=gen, device="cuda").argsort(
        -1)[:, :K]
    gs = torch.bincount(picks.flatten(), minlength=E).clamp(max=C)
    x = torch.randn(tokens * K, M, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(E, M, N, generator=gen, device="cuda")
         / M ** 0.5).to(dtype)
    return x, w, gs.to(torch.int32), C


def check_gmm(ops, ref, dtype, gen, shape):
    """Kernel 6 at the MoE path's four shapes (decode and prefill, gate/up
    and down).  The reported numbers are the decode gate/up call's (2 of
    the 3 calls of each layer and decode tick, the most frequent); every
    shape's are printed and kept under "by_shape".  One weight tensor is
    over 50 MB (128 experts), so the weights read cold from HBM without
    rotating input sets.  The error is held against the tolerance times
    the largest |output| (at least 1): the kernel and the plain version
    round the same fp32 sums, taken in another order, so one bfloat16 step
    of an output may differ."""
    E, dm, dff = shape["E"], shape["d_model"], shape["d_ff"]
    shapes = {}
    for phase, tokens in shape["calls"].items():
        for orient, (M, N) in (("gate_up", (dm, dff)), ("down", (dff, dm))):
            x, w, gs, C = gmm_case(gen, shape, tokens, M, N, dtype)
            args = (x, w, gs)
            out = ops.gmm(*args)
            want = ref.gmm_ref(*args)
            err = (out.float() - want.float()).abs().max().item()
            scale = max(1.0, want.float().abs().max().item())
            kept = int(gs.sum())
            s = x.element_size()
            nbytes = (kept * M * s + int((gs > 0).sum()) * M * N * s
                      + x.shape[0] * N * s + E * 4)
            b_ms, b_by = bound(nbytes, 2 * kept * M * N, dtype)
            # the JAX block's own formulation: the (E, C, M) capacity buffer
            # times every expert's weights
            buf = torch.zeros(E, C, M, dtype=dtype, device="cuda")
            starts = torch.cumsum(gs, 0).tolist()
            for e, (a, b) in enumerate(zip([0] + starts[:-1], starts)):
                buf[e, :b - a] = x[a:b]
            shapes[f"{phase}_{orient}"] = dict(
                rows=x.shape[0], M=M, N=N, kept=kept, capacity=C,
                nonempty_experts=int((gs > 0).sum()),
                max_abs_err=err, tolerance_scale=scale,
                ms=time_ms(ops.gmm, [args]),
                device_ms=device_ms(ops.gmm, args, "gmm_kernel"),
                plain_ms=time_ms(ref.gmm_ref, [args]),
                library_ms=time_ms(torch.bmm, [(buf, w)]),
                bound_ms=b_ms, bound_by=b_by)
            del x, w, buf
    for k, r in shapes.items():
        print(f"  gmm {str(dtype)[6:]} {k}: rows {r['rows']} ({r['kept']} "
              f"kept, capacity {r['capacity']}, {r['nonempty_experts']} "
              f"experts) M {r['M']} N {r['N']}: max_abs_err "
              f"{r['max_abs_err']} ms {r['ms']:.4f} (device_ms "
              f"{fmt_ms(r['device_ms'])}) plain_ms "
              f"{r['plain_ms']:.4f} library_ms (bmm over the capacity "
              f"buffer) {r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
              f"({r['bound_by']})", flush=True)
    top = shapes["decode_gate_up"]
    worst = max(shapes.values(),
                key=lambda r: r["max_abs_err"] / r["tolerance_scale"])
    return dict(max_abs_err=worst["max_abs_err"],
                tolerance_scale=worst["tolerance_scale"],
                ms=top["ms"], device_ms=top["device_ms"],
                plain_ms=top["plain_ms"],
                library_ms=top["library_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], by_shape=shapes)


def check_scan(ops, ref, dtype, gen, shape):
    """Kernel 7 at the mixer's two shapes: a 256-token prefill bucket and a
    decode tick over 8 slots (S = 1, from the carried state, written in
    place as the model does).  u, B and C in `dtype` (B and C slices of
    one projection, as the mixer passes them), dt, A, D and the state in
    float32.  The reported numbers are the decode call's (one per layer
    and tick, the most frequent); both are printed and kept under
    "by_shape".  The error is held against the tolerance times the largest
    |output| (at least 1): the kernel and the plain version compute in
    float32 from the same inputs, the N-term sum in another order.
    host_ms is the wrapper's host time per call.  No single PyTorch call
    computes the scan: library_ms is None."""
    Di, N, R = shape["Di"], shape["N"], 16
    dev = "cuda"
    shapes = {}
    for phase, (Bz, S) in shape["calls"].items():
        s = torch.tensor([], dtype=dtype).element_size()
        # u, dt and y once, the B and C rows, A and D, the state read and
        # written; ~6 float32 operations per (t, d, n)
        nbytes = (Bz * S * Di * (s + 4 + 4) + 2 * Bz * S * N * s
                  + Di * N * 4 + Di * 4 + 2 * Bz * Di * N * 4)
        b_ms, b_by = bound(nbytes, 6 * Bz * S * Di * N, torch.float32)
        sets = []
        for _ in range(rotations(nbytes)):
            u = torch.randn(Bz, S, Di, generator=gen, device=dev).to(dtype)
            dt = torch.nn.functional.softplus(
                torch.randn(Bz, S, Di, generator=gen, device=dev) - 1.0)
            A = -torch.exp(torch.log(torch.arange(
                1, N + 1, device=dev, dtype=torch.float32)).expand(Di, N)
                + 0.1 * torch.randn(Di, N, generator=gen, device=dev))
            dbc = torch.randn(Bz, S, R + 2 * N, generator=gen,
                              device=dev).to(dtype)
            D = torch.randn(Di, generator=gen, device=dev)
            h0 = torch.randn(Bz, Di, N, generator=gen, device=dev)
            sets.append((u, dt, A.contiguous(), dbc[..., R:R + N],
                         dbc[..., R + N:], D, h0))
        want = ref.selective_scan_ref(*sets[0])
        state = sets[0][6].clone()
        got = ops.selective_scan(*sets[0][:6], state, h_out=state)
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        scale = max(1.0, *(w.abs().max().item() for w in want))

        def kernel(*a):
            return ops.selective_scan(*a, h_out=a[6])
        shapes[phase] = dict(
            Bz=Bz, S=S, Di=Di, N=N, max_abs_err=err, tolerance_scale=scale,
            ms=time_ms(kernel, sets),
            device_ms=device_ms(kernel, sets[0], "selective_scan_kernel"),
            host_ms=host_ms(kernel, sets[0]),
            plain_ms=time_ms(ref.selective_scan_ref, sets), library_ms=None,
            bound_ms=b_ms, bound_by=b_by)
    for k, r in shapes.items():
        print(f"  selective_scan {str(dtype)[6:]} {k}: Bz {r['Bz']} S "
              f"{r['S']} Di {r['Di']} N {r['N']}: max_abs_err "
              f"{r['max_abs_err']} (|y| up to {r['tolerance_scale']:.3g}) ms "
              f"{r['ms']:.4f} (device_ms {fmt_ms(r['device_ms'])}, host_ms "
              f"{r['host_ms']:.4f}) plain_ms "
              f"{r['plain_ms']:.4f} library_ms none bound_ms "
              f"{r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    top = shapes["decode"]
    worst = max(shapes.values(),
                key=lambda r: r["max_abs_err"] / r["tolerance_scale"])
    return dict(max_abs_err=worst["max_abs_err"],
                tolerance_scale=worst["tolerance_scale"],
                ms=top["ms"], device_ms=top["device_ms"],
                plain_ms=top["plain_ms"], library_ms=None,
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                by_shape=shapes)


def visible_pairs(S, causal, prefix_len) -> int:
    """(query, key) pairs a head sees in an unpadded S-token sequence."""
    if not causal:
        return S * S
    return sum(max(i + 1, prefix_len) for i in range(S))


#: other builds of the backward's library timed beside it in check_flash_bwd
#: (``--compare-bwd``): label -> its C entry point
BWD_VARIANTS = {}


def bwd_design(ops, dtype, B, S, H, KV, D) -> dict:
    """The backward's design at a shape, as the library picks it (a query:
    nothing is launched): its body, the dK/dV launch's split of the query
    heads over a cluster, the ring's stages."""
    fn = ops.build()["flash_attention_bwd.cu"].repro_flash_attention_bwd_design
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(ops._DTYPES[dtype], B, S, S, H, KV, D, out)
    if err:
        fail(f"flash_attention_bwd design query: CUDA error {err}")
    return dict(body="wgmma" if out[0] else "cuda cores", splits=out[1],
                stages=out[2])


def build_parent_bwd(ops, parent_src: str) -> None:
    """Build, for this call only, the parent's backward (`parent_src`, its
    .cu beside its own common.cuh) with ops.build's flags into
    build/chip_smoke_variants/, and put it in BWD_VARIANTS."""
    out = os.path.join(ROOT, "build", "chip_smoke_variants")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "parent_bwd.so")
    proc = subprocess.run(
        [ops._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib, parent_src],
        capture_output=True, text=True)
    if proc.returncode:
        fail(f"flash_attention_bwd parent: nvcc failed\n{proc.stdout}"
             f"{proc.stderr}")
    fn = ctypes.CDLL(lib).repro_flash_attention_bwd
    fn.argtypes = ops.KERNELS["flash_attention_bwd"][2]
    fn.restype = ctypes.c_int
    BWD_VARIANTS["parent"] = fn
    print(f"flash_attention_bwd: the parent's source built for this call "
          f"({parent_src})", flush=True)


def check_flash_bwd(ops, ref, dtype, gen, shape):
    """The flash backward (in bf16 two launches, dQ with delta then dK/dV;
    in float32 three: delta, dK/dV, dQ) at a training shape, against its plain version on the same forward (the plain one's
    output and lse), and the forward at that shape with its lse (kernel 1's
    training launch) against the plain forward, with its bound and SDPA's
    forward beside it.  Each of dq, dk and dv is held against the
    tolerance times its own largest |value| (dq and dk carry the 1/sqrt(D)
    scale, dv does not): the two sum the same fp32 products in another
    order.  Two calls must give the same gradients to the bit.  device_ms
    sums the launches; library_ms is the backward of PyTorch's SDPA
    with a bool mask (the yardstick), timed by autograd.grad on a kept
    graph; beside it SDPA's backward with the least-masked arguments that
    compute the same function (is_causal at a causal shape with positions
    0..S-1 and no prefix, no mask at a bidirectional one), which lets
    PyTorch choose its flash backend.  With --compare-bwd, the parent's
    build runs through the same wrapper: its errors, and its times in turns
    with this build's."""
    B, S, H, KV, D = (shape[k] for k in ("B", "S", "H", "KV", "D"))
    mask = dict(causal=shape["causal"], prefix_len=shape["prefix_len"])
    dev = "cuda"
    dt = str(dtype)[6:]
    pos = torch.arange(S, device=dev, dtype=torch.int32).repeat(B, 1)
    s = torch.tensor([], dtype=dtype).element_size()
    # q, k, v, o, dO and lse read; dq, dk, dv written; the positions
    nbytes = (4 * B * S * H * D + 4 * B * S * KV * D) * s + B * S * H * 4 \
        + 2 * pos.numel() * 4
    pairs = B * H * visible_pairs(S, mask["causal"], mask["prefix_len"])
    b_ms, b_by = bound(nbytes, 5 * 2 * pairs * D, dtype)
    design = bwd_design(ops, dtype, B, S, H, KV, D)
    print(f"  flash_attention_bwd {dt} design at B {B} S {S} {H}x{D} on {KV} "
          f"kv heads: {design}"
          + (", P and dS with their low half" if design["body"] == "wgmma"
             else ""), flush=True)
    sets = []
    for _ in range(rotations(nbytes)):
        q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        g = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
        out, lse = ref.flash_attention_fwd_ref(q, k, v, pos, pos, **mask)
        sets.append((q, k, v, pos, pos, out, lse, g))
    kernel = functools.partial(ops.flash_attention_bwd, **mask)
    plain = functools.partial(ref.flash_attention_bwd_ref, **mask)
    want = plain(*sets[0])

    def errors(label, got):
        """Each gradient's error against the plain version's, beside its
        tolerance; the worst (err, scale) pair."""
        worst = (0.0, 1.0)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - b.float()).abs().max().item()
            scale = max(1e-30, b.float().abs().max().item())
            rms = b.float().pow(2).mean().sqrt().item()
            margin = f"{TOL[dtype] * scale / err:.1f}x" if err else "exact"
            print(f"  flash_attention_bwd {dt} {label}{name}: max_abs_err "
                  f"{err} (tolerance {TOL[dtype] * scale}: {TOL[dtype]} x "
                  f"its largest |value| {scale}; rms {rms:.4g}; inside it "
                  f"{margin})", flush=True)
            if err / scale >= worst[0] / worst[1]:
                worst = (err, scale)
        return worst
    got = kernel(*sets[0])
    worst = errors("", got)
    again = kernel(*sets[0])
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"flash_attention_bwd {dtype}: two calls differ")

    # the forward's training launch at this shape: output and lse, its
    # bound (q, k, v read, out and lse written, the positions) and SDPA's
    # forward with the same mask
    q, k, v = sets[0][:3]
    lse = torch.empty(B, S, H, dtype=torch.float32, device=dev)

    def fwd(q, k, v, *_):
        return ops._flash_forward(q, k, v, pos, pos, mask["causal"], 0,
                                  mask["prefix_len"], ref.FLASH_KV_BLOCK, lse)
    out_k = fwd(q, k, v)
    out_r, lse_r = sets[0][5], sets[0][6]
    fwd_err = (out_k.float() - out_r.float()).abs().max().item()
    lse_err = (lse - lse_r).abs().max().item()
    fwd_dev = device_ms(fwd, sets[0], "flash_attention_kernel")
    fwd_bytes = (2 * B * S * H * D + 2 * B * S * KV * D) * s + B * S * H * 4 \
        + 2 * pos.numel() * 4
    fwd_b, fwd_by = bound(fwd_bytes, 2 * 2 * pairs * D, dtype)
    ok = ref.attention_mask(pos, pos, **mask)[:, None]
    # the least-masked SDPA arguments that compute the same function here
    least = {} if not mask["causal"] else \
        dict(is_causal=True) if not mask["prefix_len"] else None
    lib_args = [tuple(x.transpose(1, 2) for x in st[:3]) for st in sets]

    def sdpa(q, k, v, masked=True):
        kw = dict(attn_mask=ok) if masked else least
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, enable_gqa=H != KV, **kw)
    fwd_lib = time_ms(sdpa, lib_args)
    fwd_lib_least = None if least is None else \
        time_ms(functools.partial(sdpa, masked=False), lib_args)
    print(f"  flash_attention {dt} training forward (with lse) "
          f"B {B} S {S} {H}x{D} on {KV} kv heads {mask}: max_abs_err "
          f"{fwd_err} (tolerance {TOL[dtype]}) lse max_abs_err {lse_err} "
          f"(tolerance 1e-4) ms {time_ms(fwd, sets):.4f} (device_ms "
          f"{fmt_ms(fwd_dev)}) bound_ms {fwd_b:.5f} ({fwd_by}) library_ms "
          f"{fwd_lib:.4f} (SDPA, bool mask), {fmt_ms(fwd_lib_least)} "
          f"(SDPA, least-masked {least})", flush=True)
    if not (fwd_err <= TOL[dtype] and lse_err <= 1e-4):
        fail(f"flash_attention {dtype} training forward disagrees with the "
             "plain version")

    # the library yardsticks: SDPA's backward through a kept graph, with
    # the bool mask and least-masked
    def graphs(masked):
        out = []
        for st in sets:
            leaves = [x.transpose(1, 2).detach().requires_grad_(True)
                      for x in st[:3]]
            out.append((sdpa(*leaves, masked=masked), leaves,
                        st[7].transpose(1, 2)))
        return out

    def library(o, leaves, g):
        return torch.autograd.grad(o, leaves, g, retain_graph=True)
    lib_ms = time_ms(library, graphs(True))
    lib_least = None if least is None else time_ms(library, graphs(False))
    # the wgmma body computes delta inside its dQ launch
    launches = ("dq", "dkdv") if design["body"] == "wgmma" else \
        ("delta", "dkdv", "dq")
    parts = {k: device_ms(kernel, sets[0], f"flash_bwd_{k}")
             for k in launches}
    print(f"  flash_attention_bwd {dt} device_ms by launch: "
          + ", ".join(f"{k} {fmt_ms(v)}" for k, v in parts.items())
          + f"; SDPA backward ms {lib_ms:.4f} (bool mask), "
          f"{fmt_ms(lib_least)} (least-masked {least})", flush=True)
    r = dict(max_abs_err=worst[0], tolerance_scale=worst[1],
             ms=time_ms(kernel, sets),
             device_ms=device_ms(kernel, sets[0], "flash_bwd_"),
             device_ms_by_launch=parts,
             plain_ms=time_ms(plain, sets, iters=10),
             library_ms=lib_ms,
             bound_ms=b_ms, bound_by=b_by,
             forward=dict(max_abs_err=fwd_err, lse_max_abs_err=lse_err,
                          device_ms=fwd_dev))
    if dtype == torch.bfloat16 and BWD_VARIANTS:
        own = ops._fns["flash_attention_bwd"]
        try:
            for label, fn in BWD_VARIANTS.items():
                ops._fns["flash_attention_bwd"] = fn
                errors(f"{label}: ", kernel(*sets[0]))
            times = {label: [] for label in ("this", *BWD_VARIANTS)}
            for _ in range(2):      # this, variants, this, variants
                for label in times:
                    ops._fns["flash_attention_bwd"] = \
                        own if label == "this" else BWD_VARIANTS[label]
                    times[label].append((time_ms(kernel, sets), device_ms(
                        kernel, sets[0], "flash_bwd_")))
        finally:
            ops._fns["flash_attention_bwd"] = own
        print(f"  flash_attention_bwd {dt} in turns, ms (device_ms): "
              + "; ".join(f"{label} " + ", ".join(
                  f"{m:.4f} ({fmt_ms(d)})" for m, d in ts)
                  for label, ts in times.items()), flush=True)
    del sets
    return r


# name, TPU kernel it replaces, check, the dtype the SQL path gives it
# (bfloat16 q/k/v and caches, the compute dtype; float32 logits, which the
# engine casts before sampling), source, the SQL path that ported it, and
# the configs whose SQL paths run it: the check runs at each one's shapes
# (path_shapes).  The JSON line reports the path dtype's run at the first
# config's shapes and each config's under "by_config"; its "launches" are
# those of the porting path, "launches_by_path" those of each path.
BOTH = (DENSE_ARCH, MOE_ARCH)
ALL = BOTH + (SSM_ARCH, HYBRID_ARCH)
#: a kernel's symbols in a profile, where not "<name>_kernel"
SYMBOL = {"flash_attention_bwd": "flash_bwd_"}
KERNELS = [
    ("flash_attention", "src/repro/kernels/flash_attention.py:89", check_flash,
     torch.bfloat16, "flash_attention.cu", "dense", BOTH + (HYBRID_ARCH,)),
    ("decode_attention", "src/repro/kernels/decode_attention.py:65",
     check_decode, torch.bfloat16, "decode_attention.cu", "dense",
     BOTH + (HYBRID_ARCH,)),
    ("constrained_sample", "src/repro/kernels/constrained_logits.py:53",
     check_sample, torch.float32, "constrained_sample.cu", "dense", ALL),
    ("decode_attention_paged", "src/repro/kernels/decode_attention.py:138",
     check_decode_paged, torch.bfloat16, "decode_attention_paged.cu",
     "paged", BOTH),
    ("decode_attention_paged_quant",
     "src/repro/kernels/decode_attention.py:234",
     functools.partial(check_decode_paged, quant=True),
     torch.bfloat16, "decode_attention_paged.cu", "paged", BOTH),
    # the prefix extension of kernel 1 (the JAX package's paged prefill,
    # layers.prefix_suffix_attention, is plain jnp)
    ("flash_attention_prefix", "src/repro/kernels/flash_attention.py:89",
     check_flash_prefix, torch.bfloat16, "flash_attention.cu", "paged", BOTH),
    ("gmm", "src/repro/kernels/moe_gmm.py:38", check_gmm, torch.bfloat16,
     "gmm.cu", "moe", (MOE_ARCH,)),
    ("selective_scan", "src/repro/kernels/selective_scan.py:49", check_scan,
     torch.bfloat16, "selective_scan.cu", "ssm", (SSM_ARCH, HYBRID_ARCH)),
    # no Pallas twin: the JAX package's jnp custom_vjp backward
    ("flash_attention_bwd", "src/repro/models/layers.py:210", check_flash_bwd,
     torch.bfloat16, "flash_attention_bwd.cu", "train", tuple(TRAIN)),
]


# ------------------------------ phase 3: full width ----------------------------
def check_forward_full_width(C, MDL, init_params, ref, arch, seed,
                             num_layers=None):
    """`arch` at full width in float32 (`num_layers` of its layers, or all):
    prefill of a prompt left-padded into the 256-token bucket (its pad rows
    hold the pad token; the MoE block routes them and they take capacity;
    the mixer's conv and scan run through them) and three decode steps,
    once through the kernels and once through the plain versions
    (attention, and the grouped matmul or the selective scan where the
    family has them), from the same weights and cache state."""
    cfg = C.get_config(arch).replace(compute_dtype="float32")
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED), "cuda")
    S, n = 256, PRE["prompt"]
    gen = torch.Generator("cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    pos = (torch.arange(S, device="cuda", dtype=torch.int32) - (S - n))[None]
    pos[pos < 0] = -1
    toks[pos < 0] = 0                   # the engine's pad token
    nxt = torch.randint(0, cfg.vocab_size, (3, 1, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    plain = {}
    if cfg.has_attention:
        plain.update(attn_fn=ref.flash_attention_ref,
                     decode_attn_fn=ref.decode_attention_ref)
    if cfg.has_moe:
        plain["gmm_fn"] = ref.gmm_ref
    if cfg.has_ssm:
        plain["scan_fn"] = ref.selective_scan_ref
    runs = []
    for fns in ({}, plain):
        cache = MDL.init_cache(cfg, 1, 512, device="cuda")
        lg, cache = MDL.forward(cfg, params, {"tokens": toks, "positions": pos},
                                mode="prefill", cache=cache, last_only=True,
                                **fns)
        out = [lg[:, -1]]
        for i in range(3):
            p = torch.full((1, 1), n + i, device="cuda", dtype=torch.int32)
            lg, cache = MDL.forward(cfg, params, {"tokens": nxt[i],
                                                  "positions": p},
                                    mode="decode", cache=cache, **fns)
            out.append(lg[:, 0])
        runs.append(torch.cat(out))
    err = (runs[0] - runs[1]).abs().max().item()
    tol = 1e-3
    depth = f"{cfg.num_layers} of {C.get_config(arch).num_layers} layers"
    print(f"full-width forward ({arch}, {depth}, float32, prefill {n}/{S} + 3 "
          f"decode steps): logits through the kernels vs the plain versions "
          f"({', '.join(plain)}) max_abs_err={err} (tolerance {tol}; logit "
          f"std {runs[1].std().item()})", flush=True)
    if not err < tol:
        fail(f"{arch} full-width forward disagrees with the plain versions")
    del params


def check_paged_forward_full_width(C, init_params, ref, arch, num_layers=None):
    """`arch` at full width in float32 through the engine's paged layout:
    a paged prefill writes the prefix pages, which are committed to the
    radix tree; a second paged prefill of the rest of the prompt reads them
    in place (kernel C, as a radix match makes it); then three decode steps
    (kernel A, or B where int8 pages freeze the committed prefix).  Each
    layout's logits are held against the same run through the plain
    versions (attention and, for the MoE family, the grouped matmul).  For
    the dense family the fp pages' logits are also held against the dense
    path's (kernels 1 and 2) on the same weights, and int8 pages are run;
    the MoE family routes the prefix and the suffix in two calls, with
    other capacities than the dense path's one call, so its drops differ
    there, and its SQL path runs no int8 pages."""
    from repro_torch.serving.engine import InferenceEngine
    cfg = C.get_config(arch).replace(compute_dtype="float32")
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    moe = cfg.family == "moe"
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED), "cuda")
    ps, npre, n = PRE_PAGED["ps"], PRE_PAGED["npre"], PRE["prompt"]
    plen = npre * ps
    gen = torch.Generator().manual_seed(SEED + 2)
    ids = torch.randint(0, cfg.vocab_size, (n + 3,), generator=gen).tolist()
    prompt, nxt = ids[:n], ids[n:]
    plain = {"attn_fn": ref.flash_attention_ref,
             "prefix_attn_fn": ref.flash_attention_prefix_ref,
             "paged_decode_attn_fn": ref.decode_attention_paged_ref}
    if moe:
        plain["gmm_fn"] = ref.gmm_ref

    def paged(quant, fns):
        eng = InferenceEngine(cfg, params, max_len=512, kv_layout="paged",
                              page_size=ps, kv_quant=quant)
        eng._ensure_pool(eng.num_table_blocks)
        table = np.full((1, eng.num_table_blocks), -1, np.int32)
        table[0] = eng.alloc_pages(eng.num_table_blocks)
        eng.paged_prefill([prompt[:plen]], table, [], 0, **fns)
        eng.radix_insert(prompt[:plen], list(table[0, :npre]))
        lg, lens, _, _ = eng.paged_prefill([prompt[plen:]], table,
                                           list(table[0, :npre]), plen, **fns)
        got = [lg]
        pos = lens.copy()
        for t in nxt:
            got.append(eng.paged_decode(np.array([t]), pos, table,
                                        eng.active_blocks(pos), **fns)[0])
            pos += 1
        return torch.cat(got)
    fp = paged("none", {})
    want = paged("none", plain)
    errs = {"fp pages vs the plain versions": (fp - want).abs().max().item()}
    if not moe:
        dense = InferenceEngine(cfg, params, max_len=512)
        lg, cache, lens, _ = dense._prefill([prompt], row_idx_mode=True)
        got = [lg]
        pos = lens.copy()
        for t in nxt:
            lg, cache = dense.decode_step(np.array([t]), pos, cache)
            got.append(lg)
            pos += 1
        errs["fp pages vs the dense path"] = (
            fp - torch.cat(got)).abs().max().item()
        del dense, cache
        errs["int8 pages vs the plain versions"] = (
            paged("int8", {}) - paged("int8", plain)).abs().max().item()
    tol = 1e-3
    depth = f"{cfg.num_layers} of {C.get_config(arch).num_layers} layers"
    print(f"full-width paged forward ({arch}, {depth}, float32, {plen}-token "
          f"prefix in {npre} radix-committed pages + {n - plen}-token suffix "
          f"prefill + 3 decode steps): max_abs_err of the logits "
          + ", ".join(f"{k} {v}" for k, v in errs.items())
          + f" (tolerance {tol}; logit std {want.std().item()})", flush=True)
    for k, v in errs.items():
        if not v < tol:
            fail(f"{arch} paged full-width forward: {k} disagree")
    del params


def build_engine_weights(C, init_params, arch):
    """`arch`'s full configuration in bfloat16 with random weights from the
    seeded generator; prints its shape and weight bytes.  Returns (cfg,
    params, weight bytes)."""
    cfg = C.get_config(arch)
    t0 = time.time()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED), "cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size()
                 for t in [*params["layers"].values(),
                           *(v for k, v in params.items() if k != "layers")])
    parts = [f"{cfg.num_layers} layers d_model {cfg.d_model} vocab "
             f"{cfg.vocab_size}"]
    if cfg.has_attention:
        parts.append(f"heads {cfg.num_heads}x{cfg.head_dim} on "
                     f"{cfg.num_kv_heads} kv heads window "
                     f"{cfg.sliding_window or 'none'}")
    if cfg.has_ssm:
        parts.append(f"d_inner {cfg.d_inner} state {cfg.ssm_state} dt_rank "
                     f"{cfg.dt_rank_eff}")
    if cfg.has_mlp:
        parts.append(f"d_ff {cfg.d_ff}")
    if cfg.has_moe:
        parts.append(f"{cfg.num_experts} experts top-{cfg.top_k} d_ff "
                     f"{cfg.d_ff}")
    print(f"engine: {cfg.name} ({cfg.family}) {', '.join(parts)}, "
          f"{cfg.compute_dtype}: {nbytes / 1e9:.2f} GB of weights built in "
          f"{time.time() - t0:.1f} s", flush=True)
    return cfg, params, nbytes


def sql_session(cfg, params, label, **engine_kw):
    """repro_torch's IPDB over an engine on `cfg` (max_len 512, on the card,
    `engine_kw` for the KV layout), with tables Items (16 rows), One (1
    row), Few (4 rows) and More/Extra (16 new rows each, for steady-state
    queries without prompt-cache hits), and two models: m (8 slots, 64 new
    tokens) and m3 (the same with n_samples 3 at temperature 0.7).  Returns
    query(table, path, nrows, model), which runs the semantic SQL query
    over `table`, checks that every answer parses under the grammar (the
    predict operator's parse yields a string) and returns its counters."""
    import repro_torch.core.database as D
    from repro_torch.core.executors import TorchExecutor
    from repro_torch.relational.table import Table
    from repro_torch.serving.engine import InferenceEngine

    eng = InferenceEngine(cfg, params, max_len=512, seed=SEED, **engine_kw)
    db = D.IPDB()
    kinds = ("bolt", "nut", "gear", "washer")
    db.register_table("Items", Table.from_rows(
        [{"name": f"item {i:02d}", "kind": kinds[i % 4]} for i in range(16)]))
    db.register_table("One", Table.from_rows([{"name": "item 99",
                                               "kind": "spring"}]))
    for table, n in (("Few", 4), ("More", 16), ("Extra", 16)):
        db.register_table(table, Table.from_rows(
            [{"name": f"{table} {i:02d}", "kind": kinds[i % 4]}
             for i in range(n)]))

    def factory(entry):
        ex = TorchExecutor(eng)
        ex.configure(dict(entry.options))
        return ex

    db.register_executor("local", factory)
    opts = "'batch_size': 1, 'num_slots': 8, 'max_tokens': 64, 'max_str': 8"
    db.sql(f"CREATE LLM MODEL m PATH 'custom:local' ON PROMPT OPTIONS "
           f"{{ {opts} }}")
    db.sql(f"CREATE LLM MODEL m3 PATH 'custom:local' ON PROMPT OPTIONS "
           f"{{ {opts}, 'n_samples': 3, 'temperature': 0.7 }}")
    db.set_option("batch_size", 1)
    # the marshaled prompt is ~225 tokens: the 256-token prefill bucket
    prompt = "the most likely colour {color VARCHAR} of the {{kind}} named {{name}}"

    def query(table, path, nrows, model="m"):
        before = dataclasses.replace(eng.total)
        t = time.time()
        r = db.sql(f"SELECT name, LLM {model} (PROMPT '{prompt}') AS color "
                   f"FROM {table}")
        torch.cuda.synchronize()
        wall = time.time() - t
        colors = r.table.column("color")
        if len(colors) != nrows or not all(isinstance(c, str) for c in colors):
            fail(f"{path} query: rows did not parse under the grammar: "
                 f"{r.table.rows()}")
        got = {k: getattr(eng.total, k) - getattr(before, k)
               for k in ("prefill_tokens", "output_tokens",
                         "radix_hit_tokens", "cow_copies")}
        got.update(wall_s=wall, llm_calls=r.stats.llm_calls,
                   kv_bytes=eng.kv_peak_bytes if eng.kv_layout == "paged"
                   else eng.total.kv_bytes)
        print(f"sql {path}: {nrows} rows parsed, llm_calls "
              f"{r.stats.llm_calls}, dispatch_batches "
              f"{r.stats.dispatch_batches}, prefill_tokens "
              f"{got['prefill_tokens']}, decode_tokens "
              f"{got['output_tokens']}, radix_hit_tokens "
              f"{got['radix_hit_tokens']}, cow_copies {got['cow_copies']}, "
              f"peak kv_bytes {got['kv_bytes']}, wall_s {wall:.3f}, decode "
              f"tokens/s {got['output_tokens'] / wall:.1f} [{label}]",
              flush=True)
        print(f"  answers: {r.table.rows()[:3]}", flush=True)
        return got
    return query


def profile(run_query) -> None:
    """Where the time of one batcher query (or train step) goes: device busy
    time (the sum of the device-side events -- kernels and copies, one
    stream) against wall time, by category, and the kernels that take the
    most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        wall = run_query()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    print(f"profile: wall_s {wall:.3f} device_busy_s {busy:.3f} "
          f"idle_share {1 - busy / wall:.3f} ({len(rows)} device event kinds; "
          f"profiler on)", flush=True)
    cats = {}
    for e in rows:
        k = e.key
        cat = next((n[0] for n in KERNELS if SYMBOL.get(n[0], n[0] + "_kernel")
                    in k), None)
        if cat is None:
            cat = ("memcpy/memset" if k.startswith("Mem") else
                   "gemm" if any(t in k for t in ("nvjet", "gemm", "cutlass",
                                                  "xmma")) else
                   "other kernels")
        ms, n = cats.get(cat, (0.0, 0))
        cats[cat] = (ms + e.self_device_time_total / 1e3, n + e.count)
    print("  by category (ms, launches): " + ", ".join(
        f"{c} {t:.2f} ({n})" for c, (t, n) in
        sorted(cats.items(), key=lambda x: -x[1][0])), flush=True)
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:10]:
        print(f"  {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d} x "
              f"{e.key[:90]}", flush=True)


# ------------------------------- phase 6: training ------------------------------
def check_train_full_width(C, MDL, ref, arch, num_layers):
    """One train step's float32 logits, loss and gradients of every master
    leaf at `arch`'s full width and `num_layers` layers, at its training
    batch and length, through the kernels (kernel 1 with its lse and the
    backward) against the plain autograd function
    (ref.flash_attention_grad_ref), from the same weights and batch."""
    from repro_torch.launch import steps as ST
    from repro_torch.training import optim as OPT
    from repro_torch.training.data import DataConfig, synthetic_batch
    cfg = C.get_config(arch).replace(compute_dtype="float32",
                                     num_layers=num_layers)
    state = ST.init_train_state(cfg, torch.Generator("cuda").manual_seed(SEED),
                                "cuda")
    params = state["params"]
    leaves = OPT.leaves(params)
    shp = TRAIN[arch]
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in synthetic_batch(
        cfg, DataConfig(batch=shp["B"], seq_len=shp["S"]), 0).items()}
    runs = []
    for attn_fn in (None, ref.flash_attention_grad_ref):
        for p in leaves:
            p.requires_grad_(True)
        logits, _ = MDL.forward(cfg, params, batch, mode="train",
                                attn_fn=attn_fn)
        loss = MDL.lm_loss(cfg, logits, batch["labels"], batch["mask"])
        grads = torch.autograd.grad(loss, leaves)
        runs.append((logits.detach(), loss.detach(), grads))
        del logits, loss
        for p in leaves:
            p.requires_grad_(False)
    (lk, sk, gk), (lp, sp, gp) = runs
    lerr = (lk - lp).abs().max().item()
    gerr = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
               for a, b in zip(gk, gp))
    tol = 1e-3
    print(f"train step float32 ({arch}, full width, {num_layers} of "
          f"{C.get_config(arch).num_layers} layers, B {shp['B']} S "
          f"{shp['S']}): kernels vs plain attention: logits max_abs_err "
          f"{lerr} (tolerance {tol}; logit std {lp.std().item()}), loss "
          f"{sk.item()} vs {sp.item()}, gradients' largest error relative "
          f"to the leaf's largest |gradient| {gerr} over {len(gk)} leaves "
          f"(tolerance {tol})", flush=True)
    if not (lerr < tol and gerr < tol):
        fail(f"{arch} float32 train step: kernels disagree with the plain "
             "attention")


def train_run(TR, arch, steps, *extra):
    """repro_torch.launch.train at `arch`'s training batch and length, with
    the driver's own schedule (peak 3e-3 after 20 warm-up steps)."""
    shp = TRAIN[arch]
    return TR.train(["--arch", arch, "--steps", str(steps), "--batch",
                     str(shp["B"]), "--seq-len", str(shp["S"]),
                     "--log-every", "1", *extra])


def model_flops(cfg, tokens, S) -> float:
    """6 N per token for the weights (N without the embedding, which is a
    gather, but with the tied or separate LM head), plus the attention's
    score and value products: 6 x 2 L H D x the visible keys per token
    (forward 2 products of 2 flops, backward twice that)."""
    n = cfg.param_count()
    if cfg.family != "encoder":
        n -= cfg.vocab_size * cfg.d_model          # the embedding gather
        if cfg.tie_embeddings:
            n += cfg.vocab_size * cfg.d_model      # ... used as the LM head
    P = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
    keys = visible_pairs(S, cfg.causal, P) / S
    return tokens * (6 * n + 12 * cfg.num_layers * cfg.num_heads
                     * cfg.head_dim * keys)


def warm_step(ST, cfg, arch, state, step):
    """One more train step of `state` at `arch`'s training batch and length
    (the synthetic data's batch `step`), between two device
    synchronisations: a function of no arguments that returns its wall
    seconds."""
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training import optim as OPT
    from repro_torch.training.data import DataConfig, synthetic_batch
    shp = TRAIN[arch]
    step_fn = ST.make_train_step(
        cfg, ShapeSpec("p", shp["S"], shp["B"], "train"),
        opt_cfg=OPT.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=100))
    batch = synthetic_batch(cfg, DataConfig(batch=shp["B"],
                                            seq_len=shp["S"]), step)

    def one_step():
        torch.cuda.synchronize()
        t0 = time.time()
        step_fn(state, batch)
        torch.cuda.synchronize()
        return time.time() - t0
    return one_step


def compare_bwd_steps(ops):
    """With --compare-bwd: warm bfloat16 train steps of each training
    configuration at full width and depth, with this build's backward and
    the other builds' in turns (this, others, others reversed, this; a
    warm-up step after each switch, then 3 timed steps), and one profiled
    step with each: what the backward's change does to the step."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    own = ops._fns["flash_attention_bwd"]
    builds = {"this": own, **BWD_VARIANTS}
    try:
        for arch in TRAIN:
            h = train_run(TR, arch, 1)
            step = warm_step(ST, h["cfg"], arch, h["state"], 1)
            times = {label: [] for label in builds}
            for label in [*builds, *reversed(builds)]:
                ops._fns["flash_attention_bwd"] = builds[label]
                step()
                times[label] += [step() for _ in range(3)]
            print(f"train step {arch} bfloat16 (full width and depth) with "
                  f"each backward in turns, s: " + "; ".join(
                      f"{label} median {np.median(ts):.4f} ("
                      + ", ".join(f"{t:.4f}" for t in ts) + ")"
                      for label, ts in times.items()), flush=True)
            for label in builds:
                ops._fns["flash_attention_bwd"] = builds[label]
                print(f"profile of one warm {arch} train step, {label} "
                      f"backward:", flush=True)
                profile(step)
            del h, step
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        ops._fns["flash_attention_bwd"] = own


def report_train(label, hist, cfg, shp, smi):
    """Step times (the first, which builds nothing but warms the caches,
    left out), tokens/s, model FLOP/s over the bf16 peak."""
    steady = hist["step_s"][1:] or hist["step_s"]
    step_s = float(np.median(steady))
    tokens = shp["B"] * shp["S"]
    fl = model_flops(cfg, tokens, shp["S"])
    print(f"train {label}: losses {[round(x, 4) for x in hist['losses']]}, "
          f"step_s median {step_s:.4f} (first {hist['step_s'][0]:.4f}), "
          f"tokens/s {tokens / step_s:.1f}, model TFLOP/s "
          f"{fl / step_s / 1e12:.2f} = {fl / step_s / PEAK_FLOPS[torch.bfloat16]:.4f} "
          f"of the bf16 peak [{smi}]", flush=True)
    if not all(np.isfinite(hist["losses"])):
        fail(f"train {label}: non-finite loss")
    return step_s


def train_path(C, smi):
    """The training path through repro_torch.launch.train, in bfloat16
    compute with float32 master weights and AdamW state: olmo-1b at full
    width and depth for 8 steps in the driver's default mode (the loss must
    fall); the same 8 steps deterministic, and 4 steps, a checkpoint, a
    restore and 4 more, deterministic, which must equal them to the bit;
    then hubert-xlarge at full width and depth and paligemma-3b at full
    width and depth for 4 steps each.  One more step of each is
    profiled."""
    import shutil
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    out = {}
    torch.cuda.reset_peak_memory_stats()
    n = train_run(TR, DENSE_ARCH, 8)
    peak = torch.cuda.max_memory_allocated()
    out["olmo"] = report_train(f"{DENSE_ARCH} (full width and depth)", n,
                               n["cfg"], TRAIN[DENSE_ARCH], smi)
    print(f"  peak device memory {peak / 2**30:.2f} GiB", flush=True)
    if not n["losses"][-1] < n["losses"][0]:
        fail(f"{DENSE_ARCH}: the loss did not fall: {n['losses']}")
    del n
    gc.collect()
    torch.cuda.empty_cache()
    a = train_run(TR, DENSE_ARCH, 8, "--deterministic")
    out["olmo_deterministic"] = report_train(
        f"{DENSE_ARCH} (full width and depth, deterministic)", a, a["cfg"],
        TRAIN[DENSE_ARCH], smi)

    ck = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    t = time.time()
    train_run(TR, DENSE_ARCH, 4, "--deterministic", "--ckpt-dir", ck,
              "--ckpt-every", "1000")
    b = train_run(TR, DENSE_ARCH, 8, "--deterministic", "--ckpt-dir", ck,
                  "--resume")
    same, where = ST.state_equal(a["state"], b["state"])
    print(f"resume: 4 steps, checkpoint, restore, 4 steps vs 8 steps: "
          f"{'equal to the bit' if same else 'DIFFERENT at ' + where} "
          f"(losses {b['losses']} vs {a['losses'][4:]}; started at step "
          f"{b['start']}; {time.time() - t:.1f} s with two checkpoints)",
          flush=True)
    shutil.rmtree(ck, ignore_errors=True)
    if not (same and b["start"] == 4 and b["losses"] == a["losses"][4:]):
        fail("resumed training differs from the uninterrupted run")

    # where a warm step's time goes (one more step of the state)
    print(f"profile of one warm {DENSE_ARCH} train step:", flush=True)
    profile(warm_step(ST, a["cfg"], DENSE_ARCH, b["state"], 8))
    del a, b
    gc.collect()
    torch.cuda.empty_cache()

    for arch in (ENC_ARCH, VLM_ARCH):
        torch.cuda.reset_peak_memory_stats()
        h = train_run(TR, arch, 4)
        cfg = h["cfg"]
        depth = f"{cfg.num_layers} of {C.get_config(arch).num_layers} layers"
        out[arch] = report_train(f"{arch} (full width, {depth})", h, cfg,
                                 TRAIN[arch], smi)
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        print(f"profile of one warm {arch} train step:", flush=True)
        profile(warm_step(ST, cfg, arch, h["state"], 4))
        del h
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ------------------------------------ main -------------------------------------
def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", metavar="KERNEL[,KERNEL]",
                    help="run phases 1-2 for these kernels only and print "
                    "their JSON line (no SQL paths, no last 'ok' line)")
    ap.add_argument("--compare-bwd", metavar="PARENT_CU",
                    help="also build the given flash_attention_bwd.cu (the "
                    "parent's, beside its common.cuh) and time it in turns "
                    "with this build at the training shapes")
    args = ap.parse_args(argv)
    only = args.only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.configs as C
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as MDL
    from repro_torch.models.params import init_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}",
          flush=True)
    t = time.time()
    ops.build()
    print(f"kernels built in {time.time() - t:.1f} s (nvcc sm_90a, one process "
          f"per source)", flush=True)
    for src in PTXAS_SOURCES:
        for line in ptxas_resources(ops.build_log(src)):
            print(f"ptxas {src} {line}", flush=True)

    if args.compare_bwd:
        build_parent_bwd(ops, os.path.abspath(args.compare_bwd))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("comparisons: torch.backends.cuda.matmul.allow_tf32 = False, "
          "cudnn.allow_tf32 = False", flush=True)
    gen = torch.Generator("cuda").manual_seed(SEED)
    shapes = {a: path_shapes(C.get_config(a)) for a in ALL + tuple(TRAIN)}
    report = {}
    for kname, replaces, check, path_dtype, src, path, archs in KERNELS:
        if only and kname not in only.split(","):
            continue
        for arch in archs:
            for dtype in (torch.bfloat16, torch.float32):
                r = check(ops, ref, dtype, gen, shapes[arch][kname])
                tol = 0.0 if kname == "constrained_sample" else \
                    TOL[dtype] * r.get("tolerance_scale", 1.0)
                ok = r["max_abs_err"] <= tol
                lib = "none" if r["library_ms"] is None else \
                    f"{r['library_ms']:.4f}"
                dev = "" if "device_ms" not in r else \
                    f" (device_ms {fmt_ms(r['device_ms'])})"
                if "splits" in r:
                    dev += f" splits {r['splits']} warps {r['warps']}"
                print(f"kernel {kname} {str(dtype)[6:]} at {arch}'s shapes: "
                      f"max_abs_err {r['max_abs_err']} (tolerance {tol}) ms "
                      f"{r['ms']:.4f}{dev} plain_ms {r['plain_ms']:.4f} "
                      f"library_ms {lib} bound_ms {r['bound_ms']:.5f} "
                      f"({r['bound_by']})", flush=True)
                if not ok:
                    fail(f"{kname} {dtype} at {arch}'s shapes: kernel "
                         f"disagrees with its plain version")
                if dtype != path_dtype:
                    continue
                if arch == archs[0]:
                    report[kname] = dict(
                        name=kname, route="cuda",
                        source=f"src/repro_torch/kernels/csrc/{src}",
                        replaces=replaces, path=path, launches_by_path={},
                        by_config={}, **r)
                report[kname]["by_config"][arch] = {
                    k: r[k] for k in ("max_abs_err", "ms", "device_ms",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "splits", "warps",
                                      "int8_pages", "forward",
                                      "device_ms_by_launch") if k in r}

    if args.compare_bwd and "flash_attention_bwd" in report:
        compare_bwd_steps(ops)
    if only:
        print(json.dumps({"kernels": list(report.values())}), flush=True)
        return 0

    check_forward_full_width(C, MDL, init_params, ref, DENSE_ARCH, SEED + 1)
    torch.cuda.empty_cache()
    check_paged_forward_full_width(C, init_params, ref, DENSE_ARCH)
    torch.cuda.empty_cache()
    # full depth in float32 would need ~120 GB
    check_forward_full_width(C, MDL, init_params, ref, MOE_ARCH, SEED + 3,
                             num_layers=4)
    torch.cuda.empty_cache()
    check_paged_forward_full_width(C, init_params, ref, MOE_ARCH, num_layers=4)
    torch.cuda.empty_cache()
    check_forward_full_width(C, MDL, init_params, ref, SSM_ARCH, SEED + 4,
                             num_layers=4)
    torch.cuda.empty_cache()
    check_forward_full_width(C, MDL, init_params, ref, HYBRID_ARCH, SEED + 5)
    torch.cuda.empty_cache()

    cfg, params, _ = build_engine_weights(C, init_params, DENSE_ARCH)

    def count(path, runs, needed):
        """Drive one main path with every launch count set to 0 just
        before it; read the counts just after."""
        ops.reset_launches()
        out = runs()
        launches = {k: w.launches for k, w in ops.WRAPPERS.items()}
        print(f"launches during the {path} path: {launches}", flush=True)
        for k in needed:
            if launches[k] <= 0:
                fail(f"{k}: no launch on the {path} path")
        for k, n in launches.items():
            report[k]["launches_by_path"][path] = n
        return out

    # the dense path: the batcher, generate, and n_samples as 3 jobs a row
    dense = sql_session(cfg, params, smi)
    d_rows = count("dense", lambda: {
        "Items": dense("Items", "batcher", 16),
        "One": dense("One", "generate", 1),
        "Few": dense("Few", "batcher n_samples 3", 4, "m3")},
        ("flash_attention", "decode_attention", "constrained_sample"))
    dense("More", "batcher over More (warm)", 16)
    torch.cuda.reset_peak_memory_stats()
    profile(lambda: dense("Extra", "batcher over Extra (warm)", 16)["wall_s"])
    print(f"peak device memory during the profiled query: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # the paged path, fp pages and int8 pages: radix matches, COW forks
    paged = {q: sql_session(cfg, params, f"{smi}, kv_quant {q}",
                            kv_layout="paged", page_size=PAGED["ps"],
                            kv_quant=q) for q in ("none", "int8")}

    def paged_runs():
        out = {}
        for q, query in paged.items():
            for table, path, n, model in (("Items", "batcher", 16, "m"),
                                          ("Few", "batcher n_samples 3", 4,
                                           "m3")):
                got = query(table, f"paged {path} kv_quant {q}", n, model)
                print(f"  dense prefill_tokens over the same rows: "
                      f"{d_rows[table]['prefill_tokens']} (paged "
                      f"{got['prefill_tokens']})", flush=True)
                if got["radix_hit_tokens"] <= 0:
                    fail(f"paged {table} kv_quant {q}: no radix hit")
                if model == "m3" and got["cow_copies"] <= 0:
                    fail(f"paged {table} kv_quant {q}: no copy-on-write fork")
                out[(q, table)] = got
        return out
    count("paged", paged_runs,
          ("flash_attention", "flash_attention_prefix",
           "decode_attention_paged", "decode_attention_paged_quant",
           "constrained_sample"))
    torch.cuda.reset_peak_memory_stats()
    profile(lambda: paged["none"]("More", "paged batcher over More (warm)",
                                  16)["wall_s"])
    print(f"peak device memory during the profiled query: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()
    profile(lambda: paged["int8"]("More", "paged batcher over More (warm) "
                                  "kv_quant int8", 16)["wall_s"])
    print(f"peak device memory during the profiled query: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # the MoE family at full width and depth: free the olmo sessions first
    del dense, paged, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, nbytes = build_engine_weights(C, init_params, MOE_ARCH)
    moe = sql_session(cfg, params, f"{smi}, {MOE_ARCH}")
    moe_paged = sql_session(cfg, params, f"{smi}, {MOE_ARCH}, kv_quant none",
                            kv_layout="paged", page_size=PAGED["ps"])

    def moe_runs():
        out = {"Items": moe("Items", "moe batcher", 16),
               "One": moe("One", "moe generate", 1),
               "paged": moe_paged("Items", "moe paged batcher", 16)}
        if out["paged"]["radix_hit_tokens"] <= 0:
            fail("moe paged Items: no radix hit")
        return out
    count("moe", moe_runs,
          ("gmm", "flash_attention", "decode_attention",
           "decode_attention_paged", "flash_attention_prefix",
           "constrained_sample"))
    torch.cuda.reset_peak_memory_stats()
    profile(lambda: moe("More", "moe batcher over More (warm)", 16)["wall_s"])
    print(f"peak device memory during the profiled query: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (weights "
          f"{nbytes / 2**30:.2f} GiB)", flush=True)

    # the ssm and hybrid families at full width and depth, dense layout:
    # free the MoE sessions first
    del moe, moe_paged, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, nbytes = build_engine_weights(C, init_params, SSM_ARCH)
    ssm = sql_session(cfg, params, f"{smi}, {SSM_ARCH}")
    count("ssm", lambda: {
        "Items": ssm("Items", "ssm batcher", 16),
        "One": ssm("One", "ssm generate", 1),
        "Few": ssm("Few", "ssm batcher n_samples 3", 4, "m3")},
        ("selective_scan", "constrained_sample"))
    torch.cuda.reset_peak_memory_stats()
    profile(lambda: ssm("More", "ssm batcher over More (warm)", 16)["wall_s"])
    print(f"peak device memory during the profiled query: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (weights "
          f"{nbytes / 2**30:.2f} GiB)", flush=True)
    del ssm, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, nbytes = build_engine_weights(C, init_params, HYBRID_ARCH)
    hybrid = sql_session(cfg, params, f"{smi}, {HYBRID_ARCH}")
    count("hybrid", lambda: {
        "Items": hybrid("Items", "hybrid batcher", 16),
        "One": hybrid("One", "hybrid generate", 1)},
        ("selective_scan", "flash_attention", "decode_attention",
         "constrained_sample"))
    del hybrid, params
    gc.collect()
    torch.cuda.empty_cache()

    # the training path: float32 train steps at reduced depth (kernels vs
    # plain), then the trainer in bfloat16
    for arch in TRAIN:
        check_train_full_width(C, MDL, ref, arch, 2)
        torch.cuda.empty_cache()
    count("train", lambda: train_path(C, smi),
          ("flash_attention", "flash_attention_bwd"))

    for r in report.values():
        r["launches"] = r["launches_by_path"][r["path"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print("kernels: " + ", ".join(report), flush=True)
    print(json.dumps({"kernels": [
        {k: report[n][k] for k in keys + ("device_ms", "splits", "warps",
                                          "int8_pages", "by_shape",
                                          "by_config")
         if k in report[n]}
        for n in report]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
