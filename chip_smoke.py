#!/usr/bin/env python3
"""Drive repro_torch's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root; needs one GPU
    python3 chip_smoke.py --only gmm,flash_attention   # phases 1-2 only
    python3 chip_smoke.py --only selective_scan,decode_attention_paged_quant
    python3 chip_smoke.py --only flash_attention_bwd
    python3 chip_smoke.py --only gmm_bwd,selective_scan_bwd
    python3 chip_smoke.py --only gmm,gmm_bwd,selective_scan,selective_scan_bwd \
        --compare-bwd build/parent/src/repro_torch/kernels/csrc
    python3 chip_smoke.py --only dist      # the build and phase 7 only
    python3 chip_smoke.py --only serve     # the build and phase 8 only
    python3 chip_smoke.py --only serve_b1  # the build and phase 8's batch 1
    python3 chip_smoke.py --only serve_vlm # the build, phase 8's VLM/encoder

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
   backward kernels at the training path's shapes, phase 6: the flash
   backward (and kernel 1's training launch) at each trained config with
   attention, the grouped matmul's backward at qwen3-moe-30b-a3b's, the
   selective scan's (and kernel 7's training launch with its carries) at
   falcon-mamba-7b's and hymba-1.5b's): its
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
   bool mask and with the least-masked arguments; for the scan's backward
   its device time per launch, the training forward's with its carries,
   and the floor of its exponentials on the special-function units
   (``--compare-bwd`` also builds the parent's training-path sources for
   that call and times them in turns with this build through the same
   wrappers: the three backwards at their training shapes, kernels 6 and
   7 at their serving shapes, and warm train steps of the configs whose
   backward was checked, with one profiled step of each);
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
   c. the HTTP front door (``repro_torch.frontdoor``) on localhost over
      the IPDB with ``PATH 'torch:olmo-1b'`` (``'config': 'full'``) at the
      dense path's settings, chunks of 8 rows: 2 tenants x 3 concurrent
      sessions of 8 rows and one session of 32 rows cancelled by ``DELETE
      /query/<id>`` after its first chunk; every stream ends with its
      ExecStats trailer, every value parses, the cancelled session
      dispatches at most the flush in flight; launches counted as the
      ``frontdoor`` path (the engine runs on the inference service's
      worker thread);
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
6. the training path (every family; kernel 1 with its lse and the flash
   backward, ``flash_attention_bwd.cu``; the grouped matmul and its
   backward, ``gmm.cu``; kernel 7 with its carries and its backward,
   ``selective_scan_bwd.cu``; phase 2 checks each at the trained configs'
   shapes: olmo-1b's B 8 x 512 tokens of 16 heads x 128, causal;
   paligemma-3b's B 4 x (256 image + 128 text) of 8 x 256 on 1 kv head,
   prefix-LM; hubert-xlarge's B 8 x 512 of 16 x 80, bidirectional;
   qwen3-moe-30b-a3b's B 8 x 512 of 32 x 64 on 4 kv heads and its 128
   experts; falcon-mamba-7b's B 4 x 512 of 8192 channels; hymba-1.5b's B 2
   x 2048 of 25 x 64 on 5 kv heads, window 1024, and 3200 channels), after
   the hybrid session is freed:
   a. one train step in float32 at full width and 2 layers of each of the
      six configs: logits, loss and the gradient of every master leaf
      through the kernels against the plain autograd functions;
   b. ``repro_torch.launch.train`` in bfloat16 compute with float32 master
      weights and AdamW state: olmo-1b at full width and depth for 8 steps,
      deterministic (the loss must fall); 4 steps, a checkpoint, a restore
      and 4 more, which must equal the 8 to the bit; hubert-xlarge at full
      width and depth and paligemma-3b at full width and depth for 4 steps
      each (at the driver's own 20 warm-up steps); then qwen3-moe-30b-a3b
      (5 of 48 layers), falcon-mamba-7b (32 of 64 layers) and hymba-1.5b
      (full depth) for 8 steps each, whose loss must fall, and qwen3-moe
      and hymba 4 steps twice in deterministic mode, equal to the bit;
      step times, tokens/s, model FLOP/s over the bf16 peak and peak
      memory, one warm step of each profiled; the launches counted as the
      ``train`` path, and checked against those of the steps run (each
      layer's forward kernels twice a step: ``launch.train`` remats every
      layer, ``remat_policy`` "nothing");
   c. remat: olmo-1b, qwen3-moe-30b-a3b and hymba-1.5b (their training
      batches, lengths and depths) 2 deterministic steps each with remat
      off, "nothing" and "dots" from one state, equal to the bit, each
      run's peak memory printed; then olmo-1b at full width and depth at
      its published 2048-token context, B 16, 4 steps through
      ``launch.train`` (the loss must fall; peak memory printed); launches counted as the
      ``remat`` path;
7. the distribution layer (``launch/dist.py``, ``launch/mesh.py``,
   ``launch.steps.make_train_step(mesh=)``): olmo-1b, qwen3-moe-30b-a3b and falcon-mamba-7b at full width and 2
   layers, bfloat16 over float32 masters, on a 1 x 1 mesh (NCCL, a world
   of one in this process), each step equal to the bit to the one-device
   step; with 2 or more cards, spawned NCCL ranks (one a card) run the
   same configs on (data 2, model 1) and (1, 2), and on 4 cards on (2, 2),
   against the one-device step (bf16 tolerances, DIST_TOL), then
   falcon-mamba-7b at full depth (64 layers) and qwen3-moe-30b-a3b at
   the largest depth measured to fit (DIST_DEEP) for 4 steps each, whose
   losses must fall, and one more step of each profiled on rank 0; per
   rank the step times, peak memory and collective bytes a step.  The
   mesh steps' launches are counted, the one-device references' are not:
   the 1 x 1 mesh's as the ``dist`` path, rank 0's of the spawned ranks as
   the ``dist_ranks`` path.  With one card the phase reports ``"ranks":
   1`` and there is no ``dist_ranks`` path;
8. the serving half of distribution (``launch.steps.make_prefill_step`` /
   ``make_decode_step``, ``launch.mesh.ServeShards``): olmo-1b,
   qwen3-moe-30b-a3b, falcon-mamba-7b and mixtral-8x22b at full width and
   2 layers in bf16, the one-device steps in bf16 and float32 (the
   references), then on a 1 x 1 mesh (NCCL, this process) every prefill
   variant (default, seq_parallel, banded) and decode mode (hd, lc with
   per_row_write, kv, resident) equal to the bit to the one-device
   builders; spawned ranks on (data 2, model 1), (1, 2) and, on 4 cards,
   (2, 2) (NCCL, one a card; with one card two ranks share it over gloo
   on (1, 2)) against the one-device step (SERVE_TOL); on 4 cards
   mixtral-8x22b at full width on (2, 2): the banded B 4 x 8192 prefill at
   the deepest depth that fits, 32 decode steps in each of hd, lc and
   resident, per rank the prefill time, decode ms a token, tokens/s, peak
   and state GiB, collective bytes and the idle share of one profiled
   step, then the sequence-parallel prefill, then the same at batch 1
   (``SERVE_B1_DEEP``: the banded B 1 x 8192 prefill and 32 decode steps
   in hd, lc and resident; rank 0's launches the ``serve_b1_deep`` path).
   Then a batch that does not split over the data axes (``SERVE_B1``,
   JAX's long_500k decode layout: every data rank holds the row, the
   cache's slots split over the data axes): hymba-1.5b at full width and
   depth in bf16, B 1 x 8192 (its 1024-slot ring wraps 8 times), the
   prefill and 32 decode steps in each of hd, lc with per_row_write, kv
   and resident on (2, 2) (four ranks sharing card 0 over gloo with one
   card, 8 steps a mode there; one a card over NCCL with four), then
   falcon-mamba-7b at 2 layers on (2, 1), each step against the one-device
   step in bf16 and float32
   (SERVE_TOL), per rank the prefill s, decode ms a token, peak GiB and
   collective bytes a step; rank 0's launches the ``serve_b1`` path.
   Then the VLM and the encoder (``SERVE_VLM``): paligemma-3b at full
   width and depth in bf16, B 2 x 8192 joined positions (256 image
   embeddings and 7936 text tokens) into 8224 slots, the prefill variants
   default, no_fsdp and seq_parallel, then 32 greedy decode steps in each
   of hd, lc with per_row_write, kv and resident (every run fed the
   one-device bf16 step's greedy tokens); hubert-xlarge at full width and
   depth, B 4 x 2048 frames, the same prefill variants; on the 1 x 1 mesh
   equal to the bit to the one-device builders, then on (1, 2) as two
   ranks sharing card 0 over gloo (8 steps a mode; the sequence-parallel
   prefill gives each rank 4096 joined positions, rank 0 all 256 image
   embeddings) or on four cards (2, 2) over NCCL (32 steps), each step
   within SERVE_TOL of the one-device step, per rank the prefill s, decode
   ms a token, peak and state GiB and collective bytes a step; the 1 x 1
   mesh's and rank 0's launches the ``serve_vlm`` path.
   Kernels (a) and (b) are checked in phase 2 at a (2, 2) rank's share of
   the deep decode, and (b) at the batch-1 ranks' shares (hymba-1.5b's 512
   slots x 32 columns, mixtral-8x22b's 2048 x 64), its output launch with
   each head's lse there; kernels 1, 2, (a) and (b) at SERVE_VLM's shapes
   (``vlm_serve_shapes``: kernel 1 prefix-LM at D 256 over all 8192
   queries and over a sequence-parallel rank's last 4096, and
   hubert-xlarge's bidirectional rank of 1024 of 2048 queries at D 80;
   kernel 2 at D 256 over 8224 slots; (a) over 4112 of them; (b) over 128
   of the 256 columns).  The 1 x 1 mesh's launches are the ``serve``
   path, rank 0's of the spawned ranks ``serve_ranks``;
9. a JSON line with every kernel's numbers at the dtype its path gives it,
   then the last line ``{"ok": true, "device": {...}}``.

Each phase prints the script's elapsed time as it starts.  Any failed
check raises, so the script exits non-zero and prints no last line.  Without a GPU it exits 2 at once.  ``--only`` runs phases 1 and 2
for the named kernels, prints their JSON line and stops, without the last
line (for comparing kernel versions on one card in one call); ``--only
dist`` runs the build and phase 7, ``--only serve`` the build and phase 8,
``--only serve_b1`` the build and phase 8's batch-1 runs (SERVE_B1),
``--only serve_b1_deep`` (four cards) the batch-1 mixtral run alone,
``--only serve_vlm`` the build and phase 8's VLM and encoder runs
(SERVE_VLM).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

# the caching allocator maps memory into segments that grow instead of
# cutting fixed ones: falcon-mamba-7b's train step at its cut depth peaks
# at ~70 GiB of the 80 GB card, and a large block must not fail for want
# of a contiguous hole after the phases before it
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import torch  # noqa: E402

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
#: the serving path's decode on a rank of (2, 2) (kernels (a) and (b)): the
#: deep run's 4 rows over data 2, over mixtral's 4096-slot window
SERVE_DEC_RANK = dict(B=2, L=4096)
DENSE_ARCH = "olmo-1b"
MOE_ARCH = "qwen3-moe-30b-a3b"
SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "hymba-1.5b"
VLM_ARCH = "paligemma-3b"
ENC_ARCH = "hubert-xlarge"
# the training path: global batch and sequence length of each trained config
# (paligemma: 256 image-patch embeddings + 128 text tokens; hymba: 2048
# tokens, so that its 1024-token window is live)
TRAIN = {DENSE_ARCH: dict(B=8, S=512), VLM_ARCH: dict(B=4, S=384),
         ENC_ARCH: dict(B=8, S=512), MOE_ARCH: dict(B=8, S=512),
         SSM_ARCH: dict(B=4, S=512), HYBRID_ARCH: dict(B=2, S=2048)}
#: the trained configs with attention (the flash backward's shapes)
TRAIN_ATTN = tuple(a for a in TRAIN if a != SSM_ARCH)
#: the depth at which the trainer runs a config in bfloat16 where its full
#: depth does not fit the card: fp32 masters, two AdamW moments and the
#: gradients take ~16 bytes a parameter (qwen3-moe-30b-a3b ~0.61 B a layer,
#: falcon-mamba-7b ~0.11 B) and AdamW's temporaries (a stacked leaf's
#: size, 4.25-4.5 GiB) cap the depth on one card; with the trainer's
#: remat the activations add one layer input a layer.  The largest depths
#: measured to fit an 80 GB card (benchmarks/remat_memory_torch.py:
#: qwen3-moe 5 layers at 70.07 GiB, 6 run out; falcon-mamba 32 at 74.22
#: GiB, 34 run out); the trainer phase prints each run's peak memory.  The
#: others run at full depth.
TRAIN_DEPTH = {MOE_ARCH: 5, SSM_ARCH: 32}
#: the configs whose train step runs with each remat setting from one state
#: (at their TRAIN shapes and depths), and the settings
REMAT_CHECK = (DENSE_ARCH, MOE_ARCH, HYBRID_ARCH)
REMAT_POLICIES = (("off", dict(remat=False)), ("nothing", {}),
                  ("dots", dict(remat_policy="dots")))
#: olmo-1b at its published context through launch.train (remat "nothing")
LONG = dict(B=16, S=2048, steps=4)
#: the front door's sessions: tenants x sessions of `rows` rows each, one
#: more session of `long` rows cancelled mid-stream, `chunk` rows a chunk
#: (a chunk fills the batcher's 8 slots: the sessions' dispatches run one
#: after another on the one engine)
FRONTDOOR = dict(tenants=("acme", "zeta"), sessions=3, rows=8, long=32,
                 chunk=8)
#: (arch, layers) → train steps run inside the "train" count (train_run and
#: warm_step tally them; expected_train_launches reads them)
STEPS_RUN = collections.Counter()
T0 = time.time()


def stamp(label: str) -> None:
    """The script's elapsed time at the start of a phase."""
    print(f"[{time.time() - T0:.0f} s] {label}", flush=True)


def path_shapes(cfg) -> dict:
    """Each kernel's shapes on a config's SQL paths: the slots, buckets,
    prompt and pages above with the config's (padded) query heads, kv heads,
    head dim, window and padded vocabulary where it has attention, its
    experts and widths for the grouped matmul where it has experts, and
    its channels and state size for the selective scan where it has a
    mixer; for a trained config, the backward kernels at its training
    batch and length (TRAIN)."""
    out = {"constrained_sample": dict(SAMPLE, V=cfg.padded_vocab)}
    if cfg.has_attention:
        heads = dict(H=cfg.padded_heads, KV=cfg.num_kv_heads, D=cfg.head_dim)
        out.update({
            "flash_attention": dict(
                PRE, window=cfg.sliding_window, causal=cfg.causal,
                prefix_len=cfg.num_prefix_tokens if cfg.family == "vlm"
                else 0, **heads),
            "decode_attention": dict(DEC, **heads),
            "decode_attention_paged": dict(PAGED, **heads),
            "decode_attention_paged_quant": dict(PAGED, **heads),
            "flash_attention_prefix": dict(PRE_PAGED, **heads)})
    if cfg.has_attention and cfg.name in SERVE_KERNEL_ARCHS:
        # a rank's share of the deep serving run's decode on (2, 2): its
        # rows, its half of the slots (lc) or of head_dim (hd)
        heads = dict(H=cfg.padded_heads, KV=cfg.num_kv_heads)
        out["decode_attention_lse"] = dict(
            SERVE_DEC_RANK, L=SERVE_DEC_RANK["L"] // 2, D=cfg.head_dim,
            **heads)
        out["decode_attention_hd_scores"] = out["decode_attention_hd_out"] \
            = dict(SERVE_DEC_RANK, D=cfg.head_dim // 2, **heads)
    if cfg.has_moe:
        out["gmm"] = dict(GMM, E=cfg.num_experts, K=cfg.top_k,
                          d_model=cfg.d_model, d_ff=cfg.d_ff)
    if cfg.has_ssm:
        out["selective_scan"] = dict(SCAN, Di=cfg.d_inner, N=cfg.ssm_state)
    if cfg.name in TRAIN and cfg.has_attention:
        out["flash_attention_bwd"] = dict(
            TRAIN[cfg.name], H=cfg.padded_heads, KV=cfg.num_kv_heads,
            D=cfg.head_dim, causal=cfg.causal, window=cfg.sliding_window,
            prefix_len=cfg.num_prefix_tokens if cfg.family == "vlm" else 0)
    if cfg.name in TRAIN and cfg.has_moe:
        out["gmm_bwd"] = dict(TRAIN[cfg.name], E=cfg.num_experts,
                              K=cfg.top_k, d_model=cfg.d_model,
                              d_ff=cfg.d_ff)
    if cfg.name in TRAIN and cfg.has_ssm:
        out["selective_scan_bwd"] = dict(TRAIN[cfg.name], Di=cfg.d_inner,
                                         N=cfg.ssm_state)
    return out


def b1_rank_shapes(C) -> dict:
    """Kernel (b)'s shapes on a (2, 2) rank of phase 8's batch-1 decode
    (``SERVE_B1``, ``SERVE_B1_DEEP``): one row, the ring's slots (min(cache,
    window): 1024 and 4096) over `data` and head_dim over `model`, keyed
    "<arch> b1"."""
    out = {}
    for arch in B1_RANK_ARCHS:
        cfg = C.get_config(arch)
        cache = SERVE_B1["S"] + SERVE_B1["steps"]
        ring = min(cache, cfg.sliding_window or cache)
        shp = dict(B=1, L=ring // 2, H=cfg.padded_heads, KV=cfg.num_kv_heads,
                   D=cfg.head_dim // 2)
        out[f"{arch} b1"] = {"decode_attention_hd_scores": shp,
                             "decode_attention_hd_out": shp}
    return out


def vlm_serve_shapes(C) -> dict:
    """The kernels' shapes on phase 8's SERVE_VLM runs: "<VLM> serve" its
    one-device (and 1 x 1 mesh) prefill of B x S joined positions
    (prefix-LM over the image prefix) and decode over the S + steps slots
    (rows filled to S + 1 .. S + steps); "<VLM> seq rank" the last rank's
    queries of the sequence-parallel prefill on `model` 2 against the whole
    sequence; "<VLM> rank" a `model`-2 rank's decode share, every row
    filled as on the path: (a) over the last rank's half of the slots (lc),
    (b) over half of head_dim (hd); "<encoder> seq rank" the same rank of
    the encoder's bidirectional prefill."""
    v, e = C.get_config(VLM_ARCH), C.get_config(ENC_ARCH)
    B, S, steps, m = (SERVE_VLM[k] for k in ("B", "S", "steps", "model"))
    L = S + steps
    heads = dict(H=v.padded_heads, KV=v.num_kv_heads)
    flash = dict(B=B, S=S, prompt=S, window=0, causal=True,
                 prefix_len=v.num_prefix_tokens, D=v.head_dim, **heads)
    eB, eS = SERVE_VLM["enc_B"], SERVE_VLM["enc_S"]
    return {
        f"{VLM_ARCH} serve": {
            "flash_attention": flash,
            "decode_attention": dict(B=B, L=L, D=v.head_dim,
                                     fills=(S + 1, L + 1), **heads)},
        f"{VLM_ARCH} seq rank": {
            "flash_attention": dict(flash, q_lo=S - S // m)},
        f"{VLM_ARCH} rank": {
            "decode_attention_lse": dict(
                B=B, L=L // m, D=v.head_dim, empty_row=False,
                fills=(S + 1 - L // m, L + 1 - L // m), **heads),
            "decode_attention_hd_scores": dict(B=B, L=L, D=v.head_dim // m,
                                               **heads),
            "decode_attention_hd_out": dict(
                B=B, L=L, D=v.head_dim // m, empty_row=False,
                fills=(S + 1, L + 1), **heads)},
        f"{ENC_ARCH} seq rank": {
            "flash_attention": dict(
                B=eB, S=eS, prompt=eS, window=0, causal=False, prefix_len=0,
                H=e.padded_heads, KV=e.num_kv_heads, D=e.head_dim,
                q_lo=eS - eS // m)}}


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


def device_ms(fn, args, kernel, iters=20, tries=3):
    """The device time of one launch of `kernel` (a substring of its
    symbol, or a tuple of them) in fn(*args), from the profiler: without
    the host's share,
    which time_ms's events include whenever the wrapper's Python and
    launch take longer than the kernel.  A profiled window that recorded
    no launch of the kernel (the profiler drops a window now and then) is
    taken again; None, printed as "not measured", if all `tries` did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    kernels = (kernel,) if isinstance(kernel, str) else kernel
    fn(*args)
    torch.cuda.synchronize()
    for _ in range(tries):
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn(*args)
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and any(k in e.key for k in kernels))
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
                 "selective_scan.cu", "flash_attention_bwd.cu",
                 "selective_scan_bwd.cu")


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
def max_err(got, want) -> float:
    """The largest |got - want| over a tensor or a tuple of them; equal
    entries (an lse of -inf in both) count 0."""
    if isinstance(got, tuple):
        return max(max_err(g, w) for g, w in zip(got, want))
    got, want = got.float(), want.float()
    d = (got - want).abs()
    d[got == want] = 0
    return d.max().item()


def max_rel_err(got, want, keep=None) -> float:
    """The largest ||got - want|| / ||want|| over the output vectors
    (2-norms along the last dim; `keep` masks the vectors compared; a NaN
    counts as infinite): each error beside the size of its own output.
    Where a softmax spreads over thousands of keys a typical output is a
    few hundredths, the size of bf16's flat tolerance; by this measure bf16
    rounding is ~0.003 off and an output missing one 64-key tile of 8192
    ~0.09."""
    got, want = got.float(), want.float()
    if keep is not None:
        got, want = got[keep], want[keep]
    r = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    return torch.nan_to_num(r, nan=math.inf).max().item()


def dropped_tile_err(plain, args, at, lo, want, keep=None) -> float:
    """max_rel_err of the plain version with the 64 keys from `lo` hidden
    (their positions, args[at], -1) against `want`, the plain output: what
    the check sees of a kernel that skips one 64-key tile.  Phase 2 fails
    where it is inside the tolerance (a check blind to such a fault)."""
    args = list(args)
    args[at] = args[at].clone()
    args[at][:, lo:lo + 64] = -1
    return max_rel_err(plain(*args), want, keep)


def parent_turns(ops, entry, label, fn, sets, kernel, plain):
    """With the parent's build of `entry`'s source (--compare-bwd): the
    parent's largest error against the plain version on sets[0], then fn
    over `sets` timed in turns with this build (this, parent, this,
    parent): CUDA events' ms and the profiler's device ms of `kernel`.
    None without the parent's build."""
    if entry not in PARENT:
        return None
    with build_fns(ops, "parent"):
        err = max_err(fn(*sets[0]), plain(*sets[0]))
    turns = in_turns(ops, lambda: (time_ms(fn, sets),
                                   device_ms(fn, sets[0], kernel)))
    print(f"  {label} parent: max_abs_err {err}; in turns, ms (device_ms): "
          + "; ".join(f"{lab} " + ", ".join(
              f"{m:.4f} ({fmt_ms(d)})" for m, d in ts)
              for lab, ts in turns.items()), flush=True)
    return dict(parent_max_abs_err=err, **turns)


def decode_split_shape(ops, dtype, hd_out, shape) -> dict:
    """The (splits, warps, stages, chunks) with which kernel 2 and (a) (or
    (b)'s launch 2, `hd_out`) launch at `shape`, as the library picks them
    (a query: nothing is launched): a (row, group)'s `chunks` clusters of
    `splits` blocks each."""
    fn = ops.build()["decode_attention.cu"].repro_decode_attention_shape
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    err = fn(ops._DTYPES[dtype], int(hd_out), *(shape[k] for k in (
        "B", "H", "KV", "L", "D")), out)
    if err:
        fail(f"decode_attention shape query: CUDA error {err}")
    return dict(splits=out[0], warps=out[1], stages=out[2], chunks=out[3])


def check_decode(ops, ref, dtype, gen, shape):
    """Kernel 2 at `shape`: B rows of an L-slot ring, each filled to a
    count drawn from `fills` ([lo, hi); the SQL path's 96-320 tokens by
    default)."""
    B, L, H, KV, D = (shape[k] for k in ("B", "L", "H", "KV", "D"))
    dev = "cuda"
    fills = torch.randint(*shape.get("fills", (96, 321)), (B,),
                          generator=gen, device=dev)
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
    want = ref.decode_attention_ref(*sets[0])
    err = (out.float() - want.float()).abs().max()
    mask = (spos >= 0)[:, None, None, :]
    lib_sets = [(q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2))
                for q, kc, vc, _, _ in sets]

    def library(q4, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=H != KV)
    r = dict(max_abs_err=err.item(), max_rel_err=max_rel_err(out, want),
             dropped_tile_err=dropped_tile_err(ref.decode_attention_ref,
                                               sets[0], 3, 0, want),
             ms=time_ms(ops.decode_attention, sets),
             device_ms=device_ms(ops.decode_attention, sets[0],
                                 SYMBOL["decode_attention"]),
             plain_ms=time_ms(ref.decode_attention_ref, sets),
             library_ms=time_ms(library, lib_sets),
             bound_ms=b_ms, bound_by=b_by,
             **decode_split_shape(ops, dtype, False, shape))
    if r["chunks"] > 1:     # the merge launch of the rows' chunk records
        r["merge_device_ms"] = device_ms(ops.decode_attention, sets[0],
                                         "decode_merge_kernel")
    print(f"  decode_attention {str(dtype)[6:]} B {B} L {L} {H}x{D} on {KV} "
          f"kv heads: splits {r['splits']}, warps {r['warps']}, stages "
          f"{r['stages']}, chunks {r['chunks']}; device_ms "
          f"{fmt_ms(r['device_ms'])} (the merge launch "
          f"{fmt_ms(r.get('merge_device_ms'))}), ms {r['ms']:.4f}, SDPA (bool "
          f"mask) ms {r['library_ms']:.4f}, bound_ms {b_ms:.5f}", flush=True)
    if not torch.equal(out, ops.decode_attention(*sets[0])):
        fail(f"decode_attention {dtype}: two calls differ")
    if dtype == torch.bfloat16:
        turns = parent_turns(ops, "decode_attention",
                             f"decode_attention {str(dtype)[6:]}",
                             ops.decode_attention, sets,
                             SYMBOL["decode_attention"],
                             ref.decode_attention_ref)
        if turns:
            r["in_turns"] = turns
    return r


def _rank_decode_inputs(gen, dtype, shape, nbytes_of):
    """Rotating input sets of a rank's decode attention at `shape` (B, L,
    H, KV, D: a rank's rows, slots and head_dim columns): rows filled to
    a count drawn from `fills` ([lo, hi); L/2..L by default), the last row
    empty where there is more than one and the shape does not say
    ``empty_row=False`` (at batch 1 the one row is the main path's:
    filled); the valid slots, and the slots of the rows with none (whose
    output, the mean of V, reads every V row); nbytes_of(valid, empty) the
    bytes the launch moves."""
    B, L, H, KV, D = (shape[k] for k in ("B", "L", "H", "KV", "D"))
    dev = "cuda"
    fills = torch.randint(*shape.get("fills", (L // 2, L + 1)), (B,),
                          generator=gen, device=dev)
    spos = torch.arange(L, device=dev, dtype=torch.int32).repeat(B, 1)
    spos[spos >= fills[:, None]] = -1
    if B > 1 and shape.get("empty_row", True):
        spos[-1] = -1
    qpos = (fills - 1).to(torch.int32)
    valid = (spos >= 0).sum().item()
    empty = L * ((spos >= 0).sum(1) == 0).sum().item()
    nbytes = nbytes_of(valid, empty)
    sets = []
    for _ in range(rotations(nbytes)):
        q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
        kc = torch.randn(B, L, KV, D, generator=gen, device=dev).to(dtype)
        vc = torch.randn(B, L, KV, D, generator=gen, device=dev).to(dtype)
        sets.append((q, kc, vc, spos, qpos))
    return sets, valid, empty, nbytes


def check_decode_lse(ops, ref, dtype, gen, shape):
    """Kernel (a): kernel 2 with each head's lse, over a rank's slot range
    of a cache split over its length (the lc decode mode)."""
    B, L, H, KV, D = (shape[k] for k in ("B", "L", "H", "KV", "D"))
    s = torch.tensor([], dtype=dtype).element_size()
    sets, valid, empty, nbytes = _rank_decode_inputs(
        gen, dtype, shape, lambda valid, empty: 2 * B * H * D * s + B * H * 4
        + (2 * valid + empty) * KV * D * s + B * L * 4 + B * 4)
    b_ms, b_by = bound(nbytes, (4 * valid + 2 * empty) * H * D, dtype)
    out, lse = ops.decode_attention_lse(*sets[0])
    want = ref.decode_attention_lse_ref(*sets[0])
    err = max_err((out, lse), want)
    again = ops.decode_attention_lse(*sets[0])
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        fail(f"decode_attention_lse {dtype}: two calls differ")
    if torch.isneginf(lse[-1]).all() != (empty > 0):
        fail(f"decode_attention_lse: the last row's lse is "
             f"{lse[-1, :4].tolist()}..., with {empty} slots of rows with "
             "no valid slot")
    # no PyTorch call returns a masked GQA decode's output with its lse
    fn, name = ops.decode_attention_lse, SYMBOL["decode_attention"]
    plain = ref.decode_attention_lse_ref
    r = dict(max_abs_err=err, max_rel_err=max_rel_err(out, want[0]),
             dropped_tile_err=dropped_tile_err(lambda *a: plain(*a)[0],
                                               sets[0], 3, 0, want[0]),
             ms=time_ms(fn, sets), device_ms=device_ms(fn, sets[0], name),
             plain_ms=time_ms(plain, sets),
             library_ms=None, bound_ms=b_ms, bound_by=b_by,
             **decode_split_shape(ops, dtype, False, shape))
    print(f"  decode_attention_lse {str(dtype)[6:]} B {B} L {L} {H}x{D} on "
          f"{KV} kv heads: splits {r['splits']}, warps {r['warps']}, stages "
          f"{r['stages']}, chunks {r['chunks']}; device_ms "
          f"{fmt_ms(r['device_ms'])}, ms {r['ms']:.4f}, bound_ms {b_ms:.5f}",
          flush=True)
    if dtype == torch.bfloat16:
        turns = parent_turns(ops, "decode_attention_lse",
                             f"decode_attention_lse {str(dtype)[6:]}", fn,
                             sets, name, plain)
        if turns:
            r["in_turns"] = turns
    if not empty:
        return r
    # beside the yardstick: the same inputs with the last row filled as
    # its qpos says (every row has a valid slot)
    spos = sets[0][3].clone()
    spos[-1] = torch.arange(L, device=spos.device, dtype=torch.int32)
    spos[-1][spos[-1] > sets[0][4][-1]] = -1
    full = [st[:3] + (spos, st[4]) for st in sets]
    r["no_empty_row"] = dict(ms=time_ms(fn, full),
                             device_ms=device_ms(fn, full[0], name))
    print(f"  decode_attention_lse {str(dtype)[6:]} without the empty row: "
          f"ms {r['no_empty_row']['ms']:.4f} (device_ms "
          f"{fmt_ms(r['no_empty_row']['device_ms'])}); with it ms "
          f"{r['ms']:.4f} (device_ms {fmt_ms(r['device_ms'])})", flush=True)
    if "in_turns" in r:
        r["no_empty_row"]["in_turns"] = parent_turns(
            ops, "decode_attention_lse", f"decode_attention_lse "
            f"{str(dtype)[6:]} without the empty row", fn, full, name, plain)
    return r


def hd_scores_shape(ops, dtype, shape) -> dict:
    """The (slots a tile, warps a block, tiles a warp, stages) of kernel
    (b)'s scores launch at `shape`, and its blocks (a query: nothing is
    launched)."""
    fn = ops.build()["decode_attention.cu"].repro_decode_attention_hd_scores_shape
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    B, L, H, KV, D = (shape[k] for k in ("B", "L", "H", "KV", "D"))
    err = fn(ops._DTYPES[dtype], B, H, KV, L, D, out)
    if err:
        fail(f"decode_attention_hd_scores shape query: CUDA error {err}")
    tiles = -(-L // out[0])
    return dict(tile=out[0], warps=out[1], tiles_per_warp=out[2],
                stages=out[3],
                blocks=-(-tiles // (out[1] * out[2])) * KV * B)


def check_decode_hd_scores(ops, ref, dtype, gen, shape):
    """Kernel (b), launch 1: the partial scores of a rank's head_dim
    columns, every slot; in bf16 timed in turns with the parent's build
    (--compare-bwd)."""
    B, L, H, KV, D = (shape[k] for k in ("B", "L", "H", "KV", "D"))
    s = torch.tensor([], dtype=dtype).element_size()
    sets, _, _, nbytes = _rank_decode_inputs(
        gen, dtype, shape, lambda *_: B * H * D * s + B * L * KV * D * s
        + B * H * L * 4)
    scale = 1.0 / math.sqrt(2 * D)
    b_ms, b_by = bound(nbytes, 2 * B * L * H * D, dtype)
    args = [(q, kc, scale) for q, kc, _, _, _ in sets]
    got = ops.decode_attention_hd_scores(*args[0])
    err = (got - ref.decode_attention_hd_scores_ref(*args[0])).abs().max()
    if not torch.equal(got, ops.decode_attention_hd_scores(*args[0])):
        fail("decode_attention_hd_scores: two calls differ")
    G = H // KV
    lib = [((q.reshape(B, KV, G, D) * scale), kc.permute(0, 2, 3, 1))
           for q, kc, _, _, _ in sets]
    fn, name = ops.decode_attention_hd_scores, "decode_hd_scores_kernel"
    design = hd_scores_shape(ops, dtype, shape)
    r = dict(max_abs_err=err.item(), ms=time_ms(fn, args),
             device_ms=device_ms(fn, args[0], name),
             plain_ms=time_ms(ref.decode_attention_hd_scores_ref, args),
             library_ms=time_ms(torch.matmul, lib),
             # every kernel the product launches (cuBLAS picks them)
             library_device_ms=device_ms(torch.matmul, lib[0], ""),
             bound_ms=b_ms, bound_by=b_by, design=design)
    print(f"  decode_attention_hd_scores {str(dtype)[6:]} B {B} L {L} H {H} "
          f"KV {KV} D {D}: {design}; device_ms {fmt_ms(r['device_ms'])}, "
          f"bmm device_ms {fmt_ms(r['library_device_ms'])}", flush=True)
    if dtype == torch.bfloat16:
        turns = parent_turns(ops, "decode_attention_hd_scores",
                             f"decode_attention_hd_scores {str(dtype)[6:]} "
                             f"B {B} L {L} D {D}", fn, args, name,
                             ref.decode_attention_hd_scores_ref)
        if turns:
            r["in_turns"] = turns
    return r


def check_decode_hd_out(ops, ref, dtype, gen, shape):
    """Kernel (b), launch 2: the masked softmax of the summed scores and
    P.V over a rank's head_dim columns, and each head's lse (by which the
    slot ranges of a cache split over its slots too are merged); -inf for
    a row with no valid slot.  In bf16 timed in turns with the parent's
    build (--compare-bwd; a parent whose launch wrote no lse is called
    without it)."""
    B, L, H, KV, D = (shape[k] for k in ("B", "L", "H", "KV", "D"))
    s = torch.tensor([], dtype=dtype).element_size()
    sets, valid, empty, nbytes = _rank_decode_inputs(
        gen, dtype, shape, lambda valid, empty: B * H * L * 4
        + (valid + empty) * KV * D * s + B * L * 4 + B * 4 + B * H * D * s
        + B * H * 4)
    b_ms, b_by = bound(nbytes, 2 * (valid + empty) * H * D, dtype)
    args = [(torch.randn(B, H, L, generator=gen, device="cuda") * 3, vc,
             spos, qpos) for _, _, vc, spos, qpos in sets]
    fn, plain = ops.decode_attention_hd_out, ref.decode_attention_hd_out_ref
    out, lse = fn(*args[0])
    want = plain(*args[0])
    err = max_err((out, lse), want)
    if torch.isneginf(lse[-1]).all() != (empty > 0):
        fail("decode_attention_hd_out: the last row's lse is "
             f"{lse[-1, :4].tolist()}..., with {empty} slots of rows with "
             "no valid slot")
    # softmax then a product: no single PyTorch call
    name = ("decode_hd_out_kernel", "decode_merge_kernel")
    r = dict(max_abs_err=err, max_rel_err=max_rel_err(out, want[0]),
             dropped_tile_err=dropped_tile_err(lambda *a: plain(*a)[0],
                                               args[0], 2, 0, want[0]),
             ms=time_ms(fn, args), device_ms=device_ms(fn, args[0], name),
             plain_ms=time_ms(plain, args),
             library_ms=None, bound_ms=b_ms, bound_by=b_by,
             valid_slots=valid, empty_row_slots=empty,
             **decode_split_shape(ops, dtype, True, shape))
    print(f"  decode_attention_hd_out {str(dtype)[6:]} B {B} L {L} H {H} KV "
          f"{KV} D {D}: {valid} valid slots, {empty} of empty rows; "
          f"max_abs_err {err}, device_ms {fmt_ms(r['device_ms'])}, bound_ms "
          f"{b_ms:.5f}", flush=True)
    if dtype == torch.bfloat16:
        # the output alone: a parent without lse leaves it unwritten
        turns = parent_turns(ops, "decode_attention_hd_out",
                             f"decode_attention_hd_out {str(dtype)[6:]} B "
                             f"{B} L {L} D {D}", lambda *a: fn(*a)[0], args,
                             name, lambda *a: plain(*a)[0])
        if turns:
            r["in_turns"] = turns
    return r


def check_flash(ops, ref, dtype, gen, shape):
    """Kernel 1's serving launch (no lse) at `shape`: B rows of S keys,
    the last `prompt` of them real (left pads before them), causal (the
    default) or bidirectional, with a window and a prefix-LM prefix where
    the shape has them; the queries are the keys' positions from `q_lo` on
    (a sequence-parallel rank's chunk against the whole sequence; 0 by
    default).  The bound counts the visible (query, key) pairs of this
    run's positions."""
    B, S, H, KV, D, n, W = (shape[k] for k in ("B", "S", "H", "KV", "D",
                                                "prompt", "window"))
    mask_kw = dict(causal=shape.get("causal", True), window=W,
                   prefix_len=shape.get("prefix_len", 0))
    lo = shape.get("q_lo", 0)
    dev = "cuda"
    pos = (torch.arange(S, device=dev, dtype=torch.int32) - (S - n)).repeat(B, 1)
    pos[pos < 0] = -1                   # left padding, as engine._prefill
    qpos = pos[:, lo:].contiguous()
    Sq = S - lo
    valid = qpos >= 0
    s = torch.tensor([], dtype=dtype).element_size()
    mask = ref.attention_mask(qpos, pos, **mask_kw)
    pairs = int(mask.sum())             # per head
    # q rows of real tokens, k/v rows of real keys (pad rows are never
    # needed), the whole output, and the positions (once where the queries
    # are the keys)
    nbytes = (int(valid.sum()) * H + int((pos >= 0).sum()) * 2 * KV) * D * s \
        + B * Sq * H * D * s + (pos.numel() + (qpos.numel() if lo else 0)) * 4
    b_ms, b_by = bound(nbytes, 4 * pairs * H * D, dtype)
    sets = []
    for _ in range(rotations(nbytes)):
        q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
        sets.append((q, k, v, qpos, pos))
    kernel = functools.partial(ops.flash_attention, **mask_kw)
    plain = functools.partial(ref.flash_attention_ref, **mask_kw)
    out = kernel(*sets[0])
    want = plain(*sets[0])
    err = (out[valid].float() - want[valid].float()).abs().max()
    # a tile of keys half way through the real ones, where no row is left
    # without a visible key (a window would leave some: not checked there)
    drop = None if W else dropped_tile_err(
        plain, sets[0], 4, (S - n + n // 2) // 64 * 64, want, valid)
    if not torch.isfinite(out.float()).all():
        fail("flash_attention: non-finite output on pad rows")

    def library(q, k, v, _qpos, _kpos):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=H != KV)
    # a launch of milliseconds (SERVE_VLM's prefill shapes: ~10 ms in bf16
    # and ~0.2 s in float32 on an H100) is timed over fewer calls
    n = 10 if 4 * pairs * H * D > 1e13 else 40
    r = dict(max_abs_err=err.item(),
             max_rel_err=max_rel_err(out, want, valid),
             **({} if drop is None else dict(dropped_tile_err=drop)),
             ms=time_ms(kernel, sets, iters=n),
             device_ms=device_ms(kernel, sets[0], "flash_attention_kernel",
                                 iters=n // 2),
             plain_ms=time_ms(plain, sets, iters=n),
             library_ms=time_ms(library, sets, iters=n),
             bound_ms=b_ms, bound_by=b_by,
             body=FLASH_BODY[dtype])
    dt = str(dtype)[6:]
    print(f"  flash_attention {dt} B {B} S {S} (queries from {lo}) {H}x{D} "
          f"on {KV} kv heads {mask_kw}: {r['body']}; device_ms "
          f"{fmt_ms(r['device_ms'])} ({4 * pairs * H * D / 1e9 / (r['device_ms'] or 1e30):.1f}"
          f" TFLOP/s of visible pairs), SDPA (bool mask) ms "
          f"{r['library_ms']:.4f}, bound_ms {b_ms:.5f} ({b_by}); "
          f"max_rel_err {r['max_rel_err']:.5f}", flush=True)
    if dtype == torch.bfloat16:
        turns = parent_turns(ops, "flash_attention",
                             f"flash_attention {dt} B {B} S {S} (queries from "
                             f"{lo}) D {D}", kernel, sets,
                             "flash_attention_kernel", plain)
        if turns:
            r["in_turns"] = turns
    return r


#: kernel 1's bodies by dtype (flash_attention.cu)
FLASH_BODY = {torch.bfloat16: "wgmma, warp-specialised (3 warpgroups, TMA ring)",
              torch.float32: "CUDA cores"}


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
    r = dict(max_abs_err=err.item(), ms=time_ms(fn, sets),
             device_ms=device_ms(fn, sets[0], name),
             plain_ms=time_ms(plain, sets),
             library_ms=time_ms(library, sets),
             bound_ms=b_ms, bound_by=b_by, splits=splits, warps=warps)
    if dtype == torch.bfloat16:
        entry = name.removesuffix("_kernel")
        turns = parent_turns(ops, entry, f"{entry} {str(dtype)[6:]}", fn,
                             sets, name, plain)
        if turns:
            r["in_turns"] = turns
    return r


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
    r = dict(max_abs_err=err, ms=time_ms(fn, sets),
             device_ms=device_ms(fn, sets[0], name),
             plain_ms=time_ms(ref.flash_attention_prefix_ref, sets),
             library_ms=time_ms(library, sets),
             bound_ms=b_ms, bound_by=b_by, int8_pages=int8)
    if dtype == torch.bfloat16:
        turns = parent_turns(ops, "flash_attention_prefix",
                             f"flash_attention_prefix {str(dtype)[6:]}", fn,
                             sets, name, ref.flash_attention_prefix_ref)
        if turns:
            r["in_turns"] = turns
    return r


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
            if "gmm" in PARENT and dtype == torch.bfloat16:
                turns = in_turns(ops, lambda: (
                    time_ms(ops.gmm, [args]),
                    device_ms(ops.gmm, args, "gmm_kernel")))
                shapes[f"{phase}_{orient}"]["in_turns"] = turns
                print(f"  gmm {str(dtype)[6:]} {phase}_{orient} in turns, ms "
                      "(device_ms): " + "; ".join(
                          f"{label} " + ", ".join(
                              f"{m:.4f} ({fmt_ms(d)})" for m, d in ts)
                          for label, ts in turns.items()), flush=True)
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
        if "selective_scan" in PARENT and dtype == torch.bfloat16:
            turns = in_turns(ops, lambda: (
                time_ms(kernel, sets),
                device_ms(kernel, sets[0], "selective_scan_kernel")))
            shapes[phase]["in_turns"] = turns
            print(f"  selective_scan {str(dtype)[6:]} {phase} in turns, ms "
                  "(device_ms): " + "; ".join(
                      f"{label} " + ", ".join(
                          f"{m:.4f} ({fmt_ms(d)})" for m, d in ts)
                      for label, ts in turns.items()), flush=True)
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


def worst_error(label, got, want, names, tol):
    """Each output's largest error against the plain version's, printed
    beside its largest |value|; the (err, scale) pair with the largest
    err / scale: each output is held against the tolerance times its own
    largest |value|."""
    worst = (0.0, 1.0)
    for name, a, b in zip(names, got, want):
        err = (a.float() - b.float()).abs().max().item()
        scale = max(1e-30, b.float().abs().max().item())
        print(f"  {label} {name}: max_abs_err {err} (largest |value| "
              f"{scale:.4g}; tolerance {tol * scale:.4g})", flush=True)
        if err / scale >= worst[0] / worst[1]:
            worst = (err, scale)
    return worst


#: the grouped matmul's backward launches by their symbols in a profile
#: (the bf16 bodies on wgmma, the f32 bodies on the CUDA cores)
GMM_BWD_LAUNCHES = {"dx": ("gmm_bwd_wgmma_kernel<false>", "gmm_kernel<true>"),
                    "dw": ("gmm_bwd_wgmma_kernel<true>", "gmm_dw_kernel")}


def check_gmm_bwd(ops, ref, dtype, gen, shape):
    """The grouped matmul's backward (bf16: dx and dw on wgmma in 128 x 256
    tiles, reading w and x in place; f32 on the CUDA cores) at the MoE
    training path's two shapes -- qwen3-moe-30b-a3b at B 8 x 512: 4096
    tokens x top-8 = 32768 choices over 128 experts, each capped at the
    capacity 320, the dropped ones past the kept; gate/up 2048 -> 768 and
    down 768 -> 2048 -- against the plain pair.  dx and dw are each held
    against the tolerance times their own largest |value|; two calls must
    give the same bits.  The reported numbers are the gate/up call's (2 of
    the 3 products of a layer); both shapes are printed and kept under
    "by_shape".  library_ms: the two torch.bmm calls of the JAX block's own
    formulation over the (E, C, .) capacity buffers (dy times w^T, x^T
    times dy)."""
    E, dm, dff = shape["E"], shape["d_model"], shape["d_ff"]
    tokens = shape["B"] * shape["S"]
    shapes = {}
    for orient, (M, N) in (("gate_up", (dm, dff)), ("down", (dff, dm))):
        x, w, gs, C = gmm_case(gen, shape, tokens, M, N, dtype)
        dy = torch.randn(x.shape[0], N, generator=gen, device="cuda").to(dtype)
        args = (x, w, gs, dy)
        got = ops.gmm_bwd(*args)
        err, scale = worst_error(f"gmm_bwd {str(dtype)[6:]} {orient}", got,
                                 ref.gmm_bwd_ref(*args), ("dx", "dw"),
                                 TOL[dtype])
        if not all(torch.equal(a, b) for a, b in zip(got, ops.gmm_bwd(*args))):
            fail(f"gmm_bwd {dtype} {orient}: two calls differ")
        del got
        kept, live = int(gs.sum()), int((gs > 0).sum())
        s = x.element_size()
        # x and dy of the kept rows and the live experts' weights read; dx
        # (every row) and dw (every expert) written
        nbytes = (kept * (M + N) * s + live * M * N * s + x.shape[0] * M * s
                  + E * M * N * s + E * 4)
        b_ms, b_by = bound(nbytes, 4 * kept * M * N, dtype)
        xb = torch.zeros(E, C, M, dtype=dtype, device="cuda")
        db = torch.zeros(E, C, N, dtype=dtype, device="cuda")
        starts = torch.cumsum(gs, 0).tolist()
        for e, (a, b) in enumerate(zip([0] + starts[:-1], starts)):
            xb[e, :b - a] = x[a:b]
            db[e, :b - a] = dy[a:b]

        def library(xb, db, w):
            return (torch.bmm(db, w.transpose(1, 2)),
                    torch.bmm(xb.transpose(1, 2), db))
        shapes[orient] = dict(
            rows=x.shape[0], M=M, N=N, kept=kept, capacity=C,
            nonempty_experts=live, max_abs_err=err, tolerance_scale=scale,
            ms=time_ms(ops.gmm_bwd, [args]),
            device_ms=device_ms(ops.gmm_bwd, args, SYMBOL["gmm_bwd"]),
            device_ms_by_launch={
                k: device_ms(ops.gmm_bwd, args, sym)
                for k, sym in GMM_BWD_LAUNCHES.items()},
            plain_ms=time_ms(ref.gmm_bwd_ref, [args], iters=5, warmup=1),
            library_ms=time_ms(library, [(xb, db, w)]),
            bound_ms=b_ms, bound_by=b_by)
        if "gmm_bwd" in PARENT and dtype == torch.bfloat16:
            with build_fns(ops, "parent"):
                worst_error(f"gmm_bwd parent {str(dtype)[6:]} {orient}",
                            ops.gmm_bwd(*args), ref.gmm_bwd_ref(*args),
                            ("dx", "dw"), TOL[dtype])
            turns = in_turns(ops, lambda: (
                time_ms(ops.gmm_bwd, [args]),
                device_ms(ops.gmm_bwd, args, SYMBOL["gmm_bwd"]),
                {k: device_ms(ops.gmm_bwd, args, sym)
                 for k, sym in GMM_BWD_LAUNCHES.items()}))
            shapes[orient]["in_turns"] = turns
            print(f"  gmm_bwd {str(dtype)[6:]} {orient} in turns, ms "
                  "(device_ms: dx, dw): " + "; ".join(
                      f"{label} " + ", ".join(
                          f"{m:.4f} ({fmt_ms(d)}: {fmt_ms(p['dx'])}, "
                          f"{fmt_ms(p['dw'])})" for m, d, p in ts)
                      for label, ts in turns.items()), flush=True)
        del x, w, dy, xb, db, args
    for k, r in shapes.items():
        print(f"  gmm_bwd {str(dtype)[6:]} {k}: rows {r['rows']} ({r['kept']} "
              f"kept, capacity {r['capacity']}, {r['nonempty_experts']} "
              f"experts) M {r['M']} N {r['N']}: ms {r['ms']:.4f} (device_ms "
              f"{fmt_ms(r['device_ms'])}: dx "
              f"{fmt_ms(r['device_ms_by_launch']['dx'])}, dw "
              f"{fmt_ms(r['device_ms_by_launch']['dw'])}) plain_ms "
              f"{r['plain_ms']:.4f} "
              f"library_ms (two bmm over the capacity buffers) "
              f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
              f"({r['bound_by']})", flush=True)
    top = shapes["gate_up"]
    worst = max(shapes.values(),
                key=lambda r: r["max_abs_err"] / r["tolerance_scale"])
    return dict(max_abs_err=worst["max_abs_err"],
                tolerance_scale=worst["tolerance_scale"],
                **{k: top[k] for k in ("ms", "device_ms", "plain_ms",
                                       "library_ms", "bound_ms",
                                       "bound_by")}, by_shape=shapes)


#: the selective scan's backward launches (this build's) by their symbols
SCAN_BWD_LAUNCHES = ("scan_bwd_sweep", "scan_bwd_combine", "scan_bwd_reverse",
                     "scan_bwd_reduce")


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's largest SM clock (``nvidia-smi clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


def sfu_floor_ms(ex2_count: float) -> float:
    """The least time of `ex2_count` exponentials on the special-function
    units: 16 a clock an SM at the largest SM clock.  A floor beside the
    bound, not folded into it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return ex2_count / (16 * sms * sm_clock_hz()) * 1e3


def check_scan_bwd(ops, ref, dtype, gen, shape):
    """The selective scan's backward at a trained config's batch, length
    and channels (falcon-mamba-7b: B 4 x 512, Di 8192; hymba-1.5b: B 2 x
    2048, Di 3200; N 16), from the carries of kernel 7's training launch
    (the state entering each of the backward's ~32-step chunks), which are
    first held against the plain forward's; then du, d(dt), dA, dB, dC and
    dD against the plain reverse recurrence from the same carries, each
    against the tolerance times its own largest |value|; two calls must
    give the same bits.  u, B, C, du, dB and dC in `dtype`, the rest
    float32.  Printed beside the bound: the floor of its exponentials on
    the special-function units (two a (b, t, d, n): the sweep's and the
    reverse's recompute).  With --compare-bwd, the parent's pair (its
    training forward at its own chunk count, then its backward) and this
    one in turns: each backward's device time, the forward's with its
    carries, and the pair's sum.  No single PyTorch call computes it:
    library_ms is None."""
    Bz, S, Di, N, R = shape["B"], shape["S"], shape["Di"], shape["N"], 16
    dev = "cuda"
    dt_ = str(dtype)[6:]
    T = ops._fn("selective_scan_train_chunks")(Bz, S, Di, N)
    s = torch.tensor([], dtype=dtype).element_size()
    # u, dt, dy read and du, d(dt) written; the B/C rows read and dB/dC
    # written; A, D read and dA, dD written; one entering state a (b, d,
    # n) read: the function's own bytes, whatever chunks a design keeps
    # carries for (its count of them would move the yardstick with the
    # design).  About 15 float32 operations a (b, t, d, n): the state
    # recomputed (3), the adjoint and the five gradient terms (12)
    nbytes = (Bz * S * Di * (2 * s + 12) + 4 * Bz * S * N * s
              + 2 * (Di * N + Di) * 4 + Bz * Di * N * 4)
    b_ms, b_by = bound(nbytes, 15 * Bz * S * Di * N, torch.float32)
    sfu_ms = sfu_floor_ms(2 * Bz * S * Di * N)
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
        dy = torch.randn(Bz, S, Di, generator=gen, device=dev)
        args = (u, dt, A.contiguous(), dbc[..., R:R + N], dbc[..., R + N:], D)
        carries = ops._scan_forward(*args, None, None, True)[2]
        sets.append(args + (carries, dy))
    fwd_want = ref.selective_scan_fwd_ref(*sets[0][:6], chunks=T)
    fwd_err, fwd_scale = worst_error(
        f"selective_scan {dt_} training launch (carries of {T} chunks)",
        ops._scan_forward(*sets[0][:6], None, None, True), fwd_want,
        ("y", "final state", "carries"), TOL[dtype])
    del fwd_want
    got = ops.selective_scan_bwd(*sets[0])
    err, scale = worst_error(
        f"selective_scan_bwd {dt_} B {Bz} S {S} Di {Di} N {N}", got,
        ref.selective_scan_bwd_ref(*sets[0]),
        ("du", "ddt", "dA", "dB", "dC", "dD"), TOL[dtype])
    if not all(torch.equal(a, b) for a, b in
               zip(got, ops.selective_scan_bwd(*sets[0]))):
        fail(f"selective_scan_bwd {dtype}: two calls differ")
    if fwd_err / fwd_scale > err / scale:
        err, scale = fwd_err, fwd_scale
    del got
    names = symbols("selective_scan_bwd")
    parts = {k: device_ms(ops.selective_scan_bwd, sets[0], k)
             for k in SCAN_BWD_LAUNCHES}
    fwd_args = sets[0][:6] + (None, None, True)
    fwd_dev = device_ms(ops._scan_forward, fwd_args, "selective_scan_kernel")
    bwd_dev = device_ms(ops.selective_scan_bwd, sets[0], names)
    print(f"  selective_scan_bwd {dt_} device_ms by launch: " + ", ".join(
        f"{k} {fmt_ms(v)}" for k, v in parts.items())
        + f"; the training forward with its carries: device_ms "
        f"{fmt_ms(fwd_dev)}; the pair "
        f"{fmt_ms(None if None in (fwd_dev, bwd_dev) else fwd_dev + bwd_dev)}"
        f"; bound_ms {b_ms:.5f} ({b_by}), SFU floor (2 ex2 a (b, t, d, n), "
        f"16 a clock an SM at {sm_clock_hz() / 1e6:.0f} MHz) {sfu_ms:.5f} "
        f"ms", flush=True)
    r = dict(max_abs_err=err, tolerance_scale=scale,
             ms=time_ms(ops.selective_scan_bwd, sets),
             device_ms=bwd_dev, device_ms_by_launch=parts,
             forward_device_ms=fwd_dev,
             plain_ms=time_ms(ref.selective_scan_bwd_ref, sets, iters=2,
                              warmup=1),
             library_ms=None, bound_ms=b_ms, bound_by=b_by,
             sfu_floor_ms=sfu_ms, chunks=T)
    if "selective_scan_bwd" in PARENT and dtype == torch.bfloat16:
        # each build's pair on the same inputs: its training forward (its
        # own carries), then its backward from them
        def measure():
            fwd = ops._scan_forward(*fwd_args)
            pair = sets[0][:6] + (fwd[2], sets[0][7])
            del fwd
            b_ev = time_ms(ops.selective_scan_bwd, [pair])
            b_dev = device_ms(ops.selective_scan_bwd, pair, names)
            f_dev = device_ms(ops._scan_forward, fwd_args,
                              "selective_scan_kernel")
            return b_ev, b_dev, f_dev
        with build_fns(ops, "parent"):
            fwd = ops._scan_forward(*fwd_args)
            pair = sets[0][:6] + (fwd[2], sets[0][7])
            worst_error(f"selective_scan_bwd parent {dt_}",
                        ops.selective_scan_bwd(*pair),
                        ref.selective_scan_bwd_ref(*pair),
                        ("du", "ddt", "dA", "dB", "dC", "dD"), TOL[dtype])
            del fwd, pair
        turns = in_turns(ops, measure)
        r["in_turns"] = turns
        print(f"  selective_scan_bwd {dt_} in turns, ms (device_ms; the "
              "training forward's device_ms; the pair): " + "; ".join(
                  f"{label} " + ", ".join(
                      f"{m:.4f} ({fmt_ms(b)}; {fmt_ms(f)}; "
                      f"{fmt_ms(None if None in (b, f) else b + f)})"
                      for m, b, f in ts)
                  for label, ts in turns.items()), flush=True)
    del sets
    return r


def visible_pairs(S, causal, prefix_len, window=0) -> int:
    """(query, key) pairs a head sees in an unpadded S-token sequence: all
    of them, or the causal ones (the last `window` keys where a window is
    set, the first `prefix_len` as well for a prefix-LM)."""
    if not causal:
        return S * S
    return sum(max(min(i + 1, window) if window else i + 1, prefix_len)
               for i in range(S))


#: the parent's build of the training path's kernels (``--compare-bwd``):
#: ops' entry-point name -> the parent's C function, swapped into ops._fns
#: by `build_fns` so that the same wrappers drive either build
PARENT = {}
#: a kernel's symbols in the parent's build where its source holds it alone
#: (KERNELS): every __global__ function there, read from the parent's source
PARENT_SYMBOLS = {}
#: the sources --compare-bwd builds from the parent's csrc directory: the
#: training path's, and the decode kernels' (2, (a), (b), A, B) and kernel
#: 1's with C, which share repro::split and common.cuh
PARENT_SOURCES = ("flash_attention_bwd.cu", "gmm.cu", "selective_scan.cu",
                  "selective_scan_bwd.cu", "decode_attention.cu",
                  "decode_attention_paged.cu", "flash_attention.cu")
#: entry points whose C function in an older parent takes one argument
#: fewer, and the index of the argument it lacks: kernel 2's, (a)'s and
#: (b)'s output launch before they took a workspace for chunk records
PARENT_WITHOUT = {"decode_attention": 14, "decode_attention_lse": 14,
                  "decode_attention_hd_out": 12}


def c_params(path: str, sym: str):
    """The number of parameters of the extern "C" function `sym` in the
    source at `path` (None where it is not there)."""
    with open(path) as f:
        m = re.search(r'extern "C" int ' + sym + r"\(([^)]*)\)", f.read())
    return None if m is None else m.group(1).count(",") + 1


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


def build_parent_bwd(ops, parent: str, alias: dict) -> None:
    """Build, for this call only, the parent's training-path sources
    (PARENT_SOURCES from `parent`, its csrc directory, or a .cu file in it:
    each beside its own common.cuh) with ops.build's flags into
    build/chip_smoke_variants/, one nvcc process each, all started
    together; put in PARENT every entry point its libraries export, under
    its own symbol or the one `alias` (entry point -> symbol) names (an
    entry point the parent lacks stays this build's), and in
    PARENT_SYMBOLS its kernels' names."""
    csrc = parent if os.path.isdir(parent) else os.path.dirname(parent)
    out = os.path.join(ROOT, "build", "chip_smoke_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for src in PARENT_SOURCES:
        lib = os.path.join(out, "parent_" + src.replace(".cu", ".so"))
        procs[src] = (lib, subprocess.Popen(
            [ops._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib,
             os.path.join(csrc, src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for src, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"{src} parent: nvcc failed\n{log}")
        libs[src] = ctypes.CDLL(lib)
        alone = [k[0] for k in KERNELS if k[4] == src]
        if len(alone) == 1:
            with open(os.path.join(csrc, src)) as f:
                PARENT_SYMBOLS[alone[0]] = tuple(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                    r"\s*(?://[^\n]*)?\s*)?(\w+)", f.read()))
    for name, (src, sym, argtypes, *res) in {**ops.KERNELS,
                                             **ops.QUERIES}.items():
        sym = alias.get(name, sym)
        if src not in libs or not hasattr(libs[src], sym):
            continue
        fn = getattr(libs[src], sym)
        fn.argtypes = argtypes
        fn.restype = res[0] if res else ctypes.c_int
        drop = PARENT_WITHOUT.get(name)
        if drop is not None and c_params(os.path.join(csrc, src), sym) \
                == len(argtypes) - 1:
            fn.argtypes = argtypes[:drop] + argtypes[drop + 1:]
            alias[name] = f"{sym} without argument {drop}"
            fn = functools.partial(
                lambda f, i, *a: f(*a[:i], *a[i + 1:]), fn, drop)
        PARENT[name] = fn
    print(f"--compare-bwd: the parent's {', '.join(PARENT_SOURCES)} built "
          f"for this call ({csrc}): {sorted(PARENT)}; aliases {alias}; "
          f"kernels {PARENT_SYMBOLS}", flush=True)


@contextlib.contextmanager
def build_fns(ops, label: str):
    """ops' wrappers call the parent's build (label "parent") or this one
    ("this") inside the block."""
    own = {name: ops._fn(name) for name in PARENT}
    if label == "parent":
        ops._fns.update(PARENT)
    try:
        yield
    finally:
        ops._fns.update(own)


def in_turns(ops, measure) -> dict:
    """measure() under this build and the parent's in turns (this, parent,
    this, parent): label -> [its results]."""
    out = {"this": [], "parent": []}
    for label in ("this", "parent", "this", "parent"):
        with build_fns(ops, label):
            out[label].append(measure())
    return out


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
    mask = dict(causal=shape["causal"], window=shape["window"],
                prefix_len=shape["prefix_len"])
    dev = "cuda"
    dt = str(dtype)[6:]
    pos = torch.arange(S, device=dev, dtype=torch.int32).repeat(B, 1)
    s = torch.tensor([], dtype=dtype).element_size()
    # q, k, v, o, dO and lse read; dq, dk, dv written; the positions
    nbytes = (4 * B * S * H * D + 4 * B * S * KV * D) * s + B * S * H * 4 \
        + 2 * pos.numel() * 4
    pairs = B * H * visible_pairs(S, mask["causal"], mask["prefix_len"],
                                  mask["window"])
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
        return ops._flash_forward(q, k, v, pos, pos, mask["causal"],
                                  mask["window"], mask["prefix_len"],
                                  ref.FLASH_KV_BLOCK, lse)
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
    # (none with a window or a prefix)
    least = {} if not mask["causal"] else \
        dict(is_causal=True) if not (mask["prefix_len"] or mask["window"]) \
        else None
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
    fwd_turns = parent_turns(
        ops, "flash_attention", f"flash_attention {dt} training forward (with "
        f"lse) B {B} S {S} D {D}", fwd, sets, "flash_attention_kernel",
        lambda *st: st[5]) if dtype == torch.bfloat16 else None

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
                          device_ms=fwd_dev,
                          **({} if fwd_turns is None else
                             dict(in_turns=fwd_turns))))
    if "flash_attention_bwd" in PARENT and dtype == torch.bfloat16:
        with build_fns(ops, "parent"):
            errors("parent: ", kernel(*sets[0]))
        times = in_turns(ops, lambda: (time_ms(kernel, sets), device_ms(
            kernel, sets[0], "flash_bwd_")))
        r["in_turns"] = times
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
#: the serving configs with attention whose decode runs kernels (a) and (b)
SERVE_KERNEL_ARCHS = ("mixtral-8x22b", DENSE_ARCH, MOE_ARCH)
#: the configs of phase 8's batch-1 decode whose hd mode runs kernel (b)
#: over a rank's slot range, and their shapes' keys (b1_rank_shapes)
B1_RANK_ARCHS = (HYBRID_ARCH, "mixtral-8x22b")
B1_RANK_KEYS = tuple(f"{a} b1" for a in B1_RANK_ARCHS)
#: the keys of SERVE_VLM's shapes (vlm_serve_shapes): kernel 1's, kernel
#: 2's, and (a) and (b)'s on a `model`-2 rank
VLM_FLASH_KEYS = (f"{VLM_ARCH} serve", f"{VLM_ARCH} seq rank",
                  f"{ENC_ARCH} seq rank")
VLM_DECODE_KEYS = (f"{VLM_ARCH} serve",)
VLM_RANK_KEYS = (f"{VLM_ARCH} rank",)
#: a kernel's symbols in a profile, where not "<name>_kernel"
SYMBOL = {"flash_attention_bwd": ("flash_bwd_",),
          # kernel 2 and (a), with the merge of a row's chunks (D 256)
          "decode_attention": ("decode_attention_kernel", "decode_merge_kernel"),
          # kernel 6: bf16, f32
          "gmm": ("gmm_kernel(", "gmm_kernel<false>"),
          # bf16 dx and dw, f32 dx and dw
          "gmm_bwd": ("gmm_bwd_wgmma_kernel", "gmm_kernel<true>",
                      "gmm_dw_kernel"),
          "selective_scan_bwd": ("scan_bwd_",)}


def symbols(kname: str) -> tuple:
    """A kernel's symbols in a profile, in this build and (--compare-bwd)
    in the parent's."""
    return (SYMBOL.get(kname, (kname + "_kernel",))
            + PARENT_SYMBOLS.get(kname, ()))
KERNELS = [
    ("flash_attention", "src/repro/kernels/flash_attention.py:89", check_flash,
     torch.bfloat16, "flash_attention.cu", "dense",
     BOTH + (HYBRID_ARCH,) + VLM_FLASH_KEYS),
    ("decode_attention", "src/repro/kernels/decode_attention.py:65",
     check_decode, torch.bfloat16, "decode_attention.cu", "dense",
     BOTH + (HYBRID_ARCH,) + VLM_DECODE_KEYS),
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
     torch.bfloat16, "flash_attention_bwd.cu", "train", TRAIN_ATTN),
    # no Pallas twins: JAX differentiates the capacity-buffer einsums and
    # the chunked lax.scan / associative_scan
    ("gmm_bwd", "src/repro/models/moe.py:90", check_gmm_bwd, torch.bfloat16,
     "gmm.cu", "train", (MOE_ARCH,)),
    ("selective_scan_bwd", "src/repro/models/mamba.py:45", check_scan_bwd,
     torch.bfloat16, "selective_scan_bwd.cu", "train",
     (SSM_ARCH, HYBRID_ARCH)),
    # the serving path's variants of kernel 2 on a mesh: (a) over a rank's
    # slot range with each head's lse (lc), (b) over a rank's head_dim
    # columns in two launches (hd)
    ("decode_attention_lse", "src/repro/kernels/decode_attention.py:65",
     check_decode_lse, torch.bfloat16, "decode_attention.cu", "serve_ranks",
     SERVE_KERNEL_ARCHS + VLM_RANK_KEYS),
    ("decode_attention_hd_scores", "src/repro/kernels/decode_attention.py:65",
     check_decode_hd_scores, torch.bfloat16, "decode_attention.cu",
     "serve_ranks", SERVE_KERNEL_ARCHS + B1_RANK_KEYS + VLM_RANK_KEYS),
    ("decode_attention_hd_out", "src/repro/kernels/decode_attention.py:65",
     check_decode_hd_out, torch.bfloat16, "decode_attention.cu",
     "serve_ranks", SERVE_KERNEL_ARCHS + B1_RANK_KEYS + VLM_RANK_KEYS),
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
    most.  The device events are summed by name straight from the trace's
    raw events: the profiler's own averaging (key_averages) takes minutes
    over the ~10^5-10^6 events of a query."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        wall = run_query()
    by_name = {}       # kernel or copy name -> [device us, launches]
    for e in prof.profiler.kineto_results.events():
        # "nccl:..." is the range NCCL's work is annotated with on the
        # device, beside its ncclDevKernel: counted once, as the kernel
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                and not e.name().startswith("nccl:"):
            row = by_name.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e3
            row[1] += 1
    busy = sum(us for us, _ in by_name.values()) / 1e6
    print(f"profile: wall_s {wall:.3f} device_busy_s {busy:.3f} "
          f"idle_share {1 - busy / wall:.3f} ({len(by_name)} device event "
          f"kinds; profiler on)", flush=True)
    cats = {}
    for k, (us, count) in by_name.items():
        cat = next((n[0] for n in KERNELS if any(
            sym in k for sym in symbols(n[0]))), None)
        if cat is None:
            cat = ("memcpy/memset" if k.startswith("Mem") else
                   "gemm" if any(t in k for t in ("nvjet", "gemm", "cutlass",
                                                  "xmma")) else
                   "collectives (nccl)" if k.startswith("nccl") else
                   "other kernels")
        ms, n = cats.get(cat, (0.0, 0))
        cats[cat] = (ms + us / 1e3, n + count)
    print("  by category (ms, launches): " + ", ".join(
        f"{c} {t:.2f} ({n})" for c, (t, n) in
        sorted(cats.items(), key=lambda x: -x[1][0])), flush=True)
    for k, (us, count) in sorted(by_name.items(),
                                 key=lambda x: -x[1][0])[:10]:
        print(f"  {us / 1e3:10.2f} ms {count:6d} x {k[:90]}", flush=True)


# ------------------------------- phase 6: training ------------------------------
def check_train_full_width(C, MDL, ref, arch, num_layers):
    """One train step's float32 logits, loss and gradients of every master
    leaf at `arch`'s full width and `num_layers` layers, at its training
    batch and length, through the kernels (kernel 1 with its lse and the
    flash backward; the grouped matmul and gmm_bwd; kernel 7 with its
    carries and selective_scan_bwd) against the plain autograd functions
    (ref.flash_attention_grad_ref, ref.gmm_grad_ref,
    ref.selective_scan_grad_ref), from the same weights and batch."""
    from repro_torch.launch import steps as ST
    from repro_torch.models.moe import pick_num_groups
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
    plain = {}
    if cfg.has_attention:
        plain["attn_fn"] = ref.flash_attention_grad_ref
    if cfg.has_moe:
        plain["gmm_fn"] = ref.gmm_grad_ref
    if cfg.has_ssm:
        plain["scan_fn"] = ref.selective_scan_grad_ref
    groups = pick_num_groups(shp["B"] * shp["S"], 1) if cfg.has_moe else 1
    runs = []
    for fns in ({}, plain):
        for p in leaves:
            p.requires_grad_(True)
        logits, _ = MDL.forward(cfg, params, batch, mode="train",
                                num_groups=groups, **fns)
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
          f"{shp['S']}): kernels vs the plain pairs ({', '.join(plain)}): "
          f"logits max_abs_err "
          f"{lerr} (tolerance {tol}; logit std {lp.std().item()}), loss "
          f"{sk.item()} vs {sp.item()}, gradients' largest error relative "
          f"to the leaf's largest |gradient| {gerr} over {len(gk)} leaves "
          f"(tolerance {tol})", flush=True)
    if not (lerr < tol and gerr < tol):
        fail(f"{arch} float32 train step: kernels disagree with the plain "
             "pairs")


def train_run(TR, arch, steps, *extra):
    """repro_torch.launch.train at `arch`'s training batch and length, with
    the driver's own schedule (peak 3e-3 after 20 warm-up steps)."""
    shp = TRAIN[arch]
    h = TR.train(["--arch", arch, "--steps", str(steps), "--batch",
                  str(shp["B"]), "--seq-len", str(shp["S"]),
                  "--log-every", "1", *extra])
    STEPS_RUN[(arch, h["cfg"].num_layers)] += len(h["losses"])
    return h


def model_flops(cfg, tokens, S) -> float:
    """6 N per token for the weights (N the parameters a token uses: the
    MoE family's top-k experts of a layer, not all of them; without the
    embedding, which is a gather, but with the tied or separate LM head),
    plus the attention's score and value products: 6 x 2 L H D x the
    visible keys per token (forward 2 products of 2 flops, backward twice
    that).  The selective scan's own arithmetic (~20 flops a (token, d,
    n) forward and backward, under 1 % of a mixer layer's) is left out."""
    n = cfg.active_param_count()
    if cfg.family != "encoder":
        n -= cfg.vocab_size * cfg.d_model          # the embedding gather
        if cfg.tie_embeddings:
            n += cfg.vocab_size * cfg.d_model      # ... used as the LM head
    P = cfg.num_prefix_tokens if cfg.family == "vlm" else 0
    keys = visible_pairs(S, cfg.causal, P, cfg.sliding_window) / S
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
        STEPS_RUN[(arch, cfg.num_layers)] += 1
        return time.time() - t0
    return one_step


def compare_bwd_steps(C, ops, report):
    """With --compare-bwd: warm bfloat16 train steps of each training
    configuration whose backward kernel phase 2 checked (the flash
    backward: olmo-1b, paligemma-3b, hubert-xlarge at full width and depth;
    the grouped matmul's: qwen3-moe-30b-a3b; the scan's: falcon-mamba-7b
    and hymba-1.5b; each at its TRAIN_DEPTH), with this build's kernels and
    the parent's in turns (this, parent, parent, this; a warm-up step after
    each switch, then 3 timed steps), and profiled steps in the same turns
    (of two profiles the first read slower on steps of many launches, so
    each build leads one pair): what the backwards' change does to the
    step."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    archs = [a for k, group in (
        ("flash_attention_bwd", (DENSE_ARCH, VLM_ARCH, ENC_ARCH)),
        ("gmm_bwd", (MOE_ARCH,)),
        ("selective_scan_bwd", (SSM_ARCH, HYBRID_ARCH))) if k in report
        for a in group]
    for arch in archs:
        with cut_depth(C, arch):
            h = train_run(TR, arch, 1)
            step = warm_step(ST, h["cfg"], arch, h["state"], 1)
            times = {"this": [], "parent": []}
            for label in ("this", "parent", "parent", "this"):
                with build_fns(ops, label):
                    step()
                    times[label] += [step() for _ in range(3)]
            depth = f"{h['cfg'].num_layers} layers"
            print(f"train step {arch} bfloat16 (full width, {depth}) with "
                  f"each build in turns, s: " + "; ".join(
                      f"{label} median {np.median(ts):.4f} ("
                      + ", ".join(f"{t:.4f}" for t in ts) + ")"
                      for label, ts in times.items()), flush=True)
            for label in ("this", "parent", "parent", "this"):
                with build_fns(ops, label):
                    print(f"profile of one warm {arch} train step, {label} "
                          f"build:", flush=True)
                    profile(step)
            del h, step
            gc.collect()
            torch.cuda.empty_cache()


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


@contextlib.contextmanager
def cut_depth(C, arch):
    """The registry returns `arch` at its TRAIN_DEPTH depth while the
    trainer reads it (the driver has no depth flag: it builds the named
    config)."""
    get = C.get_config
    depth = TRAIN_DEPTH.get(arch)
    if depth:
        C.get_config = lambda name: (get(name).replace(num_layers=depth)
                                     if name == arch else get(name))
    try:
        yield
    finally:
        C.get_config = get


def state_digest(state) -> list:
    """Per-leaf digests of a train state's bits, computed on the card (two
    states of the cut MoE config do not fit it at once): each float32
    leaf's bit patterns as int32, summed plainly and with a pseudo-random
    weight a position, in int64 over 2^24-element slices; and the step."""
    from repro_torch.training import optim as OPT
    out = []
    for leaf in OPT.leaves(state["params"]) + OPT.leaves(state["opt"]):
        bits = leaf.detach().reshape(-1).view(torch.int32)
        d0 = d1 = 0
        for i in range(0, bits.numel(), 1 << 24):
            c = bits[i:i + (1 << 24)].long()
            w = torch.arange(i, i + c.numel(), device=c.device) \
                * 2654435761 % 2147483647
            d0 += int(c.sum())
            d1 += int((c * w).sum())
        out.append((d0, d1))
    return out + [state["step"]]


def train_new_families(C, smi):
    """The MoE, ssm and hybrid families through repro_torch.launch.train in
    bfloat16 compute over float32 master weights and AdamW state, at full
    width and each at its TRAIN_DEPTH (qwen3-moe-30b-a3b 5 of 48 layers,
    falcon-mamba-7b 32 of 64, hymba-1.5b full depth with its 1024-token
    window live at 2048 tokens), at the driver's own schedule: 8 steps in
    the default mode (the loss must fall; step time, tokens/s, model FLOP/s
    over the bf16 peak, peak memory), one more step profiled; then, for
    qwen3-moe and hymba, the same 4 steps twice in --deterministic mode,
    whose states must be equal to the bit (compared by per-leaf digests):
    no atomics in the grouped matmul's or the scan's backward."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TR
    out = {}
    for arch in (MOE_ARCH, SSM_ARCH, HYBRID_ARCH):
        full_depth = C.get_config(arch).num_layers
        with cut_depth(C, arch):
            torch.cuda.reset_peak_memory_stats()
            h = train_run(TR, arch, 8)
            peak = torch.cuda.max_memory_allocated()
            cfg = h["cfg"]
            depth = f"{cfg.num_layers} of {full_depth} layers"
            out[arch] = report_train(f"{arch} (full width, {depth})", h, cfg,
                                     TRAIN[arch], smi)
            print(f"  peak device memory {peak / 2**30:.2f} GiB", flush=True)
            if not h["losses"][-1] < h["losses"][0]:
                fail(f"{arch}: the loss did not fall: {h['losses']}")
            print(f"profile of one warm {arch} train step:", flush=True)
            profile(warm_step(ST, cfg, arch, h["state"], 8))
            del h
            gc.collect()
            torch.cuda.empty_cache()
            if arch == SSM_ARCH:
                continue
            runs = []
            for _ in range(2):
                r = train_run(TR, arch, 4, "--deterministic")
                runs.append((r["losses"], state_digest(r["state"])))
                del r
                gc.collect()
                torch.cuda.empty_cache()
            same = runs[0] == runs[1]
            print(f"deterministic repeat ({arch}, 4 steps twice): "
                  f"{'equal to the bit' if same else 'DIFFERENT'} (losses "
                  f"{runs[0][0]} vs {runs[1][0]}; {len(runs[0][1]) - 1} "
                  f"leaves' digests)", flush=True)
            if not same:
                fail(f"{arch}: two deterministic runs differ")
    return out


def expected_train_launches(C) -> dict:
    """The launches of the training kernels that the steps tallied in
    STEPS_RUN make: each layer's forward kernels twice a step (the forward
    and, under the trainer's default remat, its recompute in the
    backward), its backward kernels once (kernel 1 and 1-bwd a layer with
    attention, kernel 6 and 6-bwd three times a MoE layer, kernel 7 and
    7-bwd a mixer layer)."""
    out = collections.Counter()
    for (arch, layers), steps in STEPS_RUN.items():
        cfg = C.get_config(arch)
        n = steps * layers
        for kname, has, per_layer in (
                ("flash_attention", cfg.has_attention, 1),
                ("gmm", cfg.has_moe, 3),
                ("selective_scan", cfg.has_ssm, 1)):
            if has:
                out[kname] += 2 * per_layer * n
                out[kname + "_bwd"] += per_layer * n
    return dict(out)


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` (and cuBLAS's fixed
    workspace) for the block, restored after, as ``launch.train
    --deterministic`` does: the embedding's gradient then sums without
    atomics, so two runs of the same step give the same bits."""
    was = torch.are_deterministic_algorithms_enabled()
    workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if workspace is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def remat_policies(C, smi):
    """The train step with remat off, "nothing" and "dots"
    (``launch.steps.make_train_step``), each from the same state (seeded
    initialisation) for 2 deterministic steps at the config's training
    batch and length and TRAIN_DEPTH: olmo-1b (full depth), qwen3-moe-30b-a3b
    (the recompute routes kernel 6's rows again) and hymba-1.5b (kernels
    1 with its window and 7 recomputed).  Losses, gradient norms and the
    final states (per-leaf digests of their bits) must be equal to the
    bit; each run's peak memory and step times are printed."""
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training import optim as OPT
    from repro_torch.training.data import DataConfig, synthetic_batch
    for arch in REMAT_CHECK:
        with cut_depth(C, arch):
            cfg = C.get_config(arch)
        shp = TRAIN[arch]
        depth = f"{cfg.num_layers} of {C.get_config(arch).num_layers} layers"
        runs = {}
        for name, kw in REMAT_POLICIES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            state = ST.init_train_state(
                cfg, torch.Generator("cuda").manual_seed(SEED), "cuda")
            step = ST.make_train_step(
                cfg, ShapeSpec("remat", shp["S"], shp["B"], "train"),
                opt_cfg=OPT.AdamWConfig(lr=3e-3, warmup_steps=20,
                                        total_steps=100), **kw)
            losses, norms, times = [], [], []
            with deterministic():
                for s in range(2):
                    batch = synthetic_batch(cfg, DataConfig(
                        batch=shp["B"], seq_len=shp["S"]), s)
                    torch.cuda.synchronize()
                    t = time.time()
                    state, m = step(state, batch)
                    losses.append(m["loss"].item())
                    norms.append(m["grad_norm"].item())
                    times.append(time.time() - t)
            peak = torch.cuda.max_memory_allocated()
            runs[name] = (losses, norms, state_digest(state))
            print(f"remat {name} ({arch}, full width, {depth}, B "
                  f"{shp['B']} S {shp['S']}, deterministic): losses "
                  f"{losses}, grad norms {norms}, step s "
                  f"{[round(x, 4) for x in times]}, peak device memory "
                  f"{peak / 2**30:.2f} GiB [{smi}]", flush=True)
            del state, step
        same = all(runs[n] == runs["off"] for n, _ in REMAT_POLICIES)
        print(f"remat off / nothing / dots ({arch}): "
              f"{'equal to the bit' if same else 'DIFFERENT'} (losses, "
              f"grad norms, {len(runs['off'][2]) - 1} leaves' digests)",
              flush=True)
        if not same:
            fail(f"{arch}: the remat policies' steps differ")
    gc.collect()
    torch.cuda.empty_cache()


def long_context(C, smi):
    """olmo-1b at full width and depth at its published 2048-token context,
    B 16 (32768 tokens a step), 4 steps through launch.train with its
    default remat ("nothing"): the loss must fall; the peak memory is
    printed (without remat the step needs more than the card)."""
    from repro_torch.launch import train as TR
    torch.cuda.reset_peak_memory_stats()
    h = TR.train(["--arch", DENSE_ARCH, "--steps", str(LONG["steps"]),
                  "--batch", str(LONG["B"]), "--seq-len", str(LONG["S"]),
                  "--log-every", "1"])
    peak = torch.cuda.max_memory_allocated()
    report_train(f"{DENSE_ARCH} (full width and depth, B {LONG['B']} x "
                 f"{LONG['S']}, remat nothing)", h, h["cfg"], LONG, smi)
    print(f"  peak device memory {peak / 2**30:.2f} GiB", flush=True)
    if not h["losses"][-1] < h["losses"][0]:
        fail(f"{DENSE_ARCH} B {LONG['B']} x {LONG['S']}: the loss did not "
             f"fall: {h['losses']}")
    del h
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------ phase 7: distribution --------------------------
#: the dist path: olmo-1b, qwen3-moe-30b-a3b and falcon-mamba-7b at full width
#: and DIST_LAYERS layers, each at its TRAIN batch, in bfloat16 compute over
#: float32 masters; on a 1 x 1 mesh in this process (NCCL, a world of one),
#: and with 2 or more cards on the meshes of DIST_MESHES in spawned ranks
DIST_ARCHS = (DENSE_ARCH, MOE_ARCH, SSM_ARCH)
DIST_LAYERS = 2
DIST_MESHES = {2: ({"data": 2, "model": 1}, {"data": 1, "model": 2}),
               4: ({"data": 2, "model": 2},)}
#: the deep runs on 4 cards, mesh (2, 2): falcon-mamba-7b at full depth
#: (~16 B x 7.3e9 parameters = ~117 GB of state and gradients: more than
#: one card, ~29 GB a card on 4) and qwen3-moe-30b-a3b at the largest depth
#: measured to fit 4 (~0.61e9 parameters a layer, ~2.9 GiB a layer a card
#: with the stacked gradients' second copy; on H100 80GB HBM3 cards at
#: 700 W 20 layers peaked at 63.20 GiB and 25 ran out in AdamW, whose
#: temporaries are a stacked leaf's size)
DIST_DEEP = {SSM_ARCH: 64, MOE_ARCH: 24}
DIST_DEEP_STEPS = 4
DIST_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)
#: bfloat16 parity of a sharded step with the one-device step from the same
#: state.  The two sum in other orders and round partial products to bf16
#: before the sums over the data axes or `model`, and a token whose top-k
#: routing is a near-tie may pick another expert, so elementwise they
#: differ by bf16's noise.  Held: loss (measured within 1.3e-5 to 2.1e-4 on
#: H100 80GB HBM3 at 700 W) and gradient norm relative to the one-device
#: step's; each moment leaf (the first step's m is 0.1 g) and each
#: parameter leaf's step (AdamW's first moves an element by lr x sign(g) +
#: decay) by its error against the same step in float32 compute, |x - x32|
#: / |x32 - x0| over the leaf's elements (x0 the state before the step; 0
#: for the moments), which may be at most `ratio` times the one-device
#: bf16 step's own plus `floor` (`param_floor` for a parameter leaf):
#: sharding may not make bf16 less accurate.  An element's first step is
#: +-lr whatever |g|, so a leaf's step error is 2 sqrt(the share of its
#: elements that step the other way): tensor parallelism rounds partial
#: sums to bf16 before the sum over `model`, which turns the sign of
#: gradients that are near 0 for their noise (~1 % of ssm.D's elements at
#: the smoke config's 256 in a CPU rehearsal, 0.21), where the one-device
#: bf16 step may turn none of a leaf's; `param_floor` 0.3 lets 2.25 % turn
#: and fails a step whose signs are unrelated (~1.4), missing (1.0) or
#: reversed (2.0), as a wrong shard or a wrong gradient gives.
#: A parameter whose step is ill-conditioned (sqrt(v / (1 - b2)), its
#: |g|, under 100 eps in either reference: the direction turns on the
#: last bits of a gradient near 0) is left out of that leaf's error and
#: held to one step's bound, `ill_lr` lr, from the one-device step.  A NaN
#: counts as an infinite error.
DIST_TOL = dict(loss=1e-3, grad_norm=2e-2, ill_lr=2.1, ratio=2.0,
                floor=1e-3, param_floor=0.3)


def counted(run, into: dict):
    """`run()` with every kernel launch count set to 0 just before it; the
    counts just after are added to `into`.  The dist path's mesh steps run
    in such windows, and the one-device reference steps beside them
    outside, so `into` holds the path's own launches."""
    from repro_torch.kernels import ops
    ops.reset_launches()
    out = run()
    for k, w in ops.WRAPPERS.items():
        into[k] = into.get(k, 0) + w.launches
    return out


def dist_cfg(C, arch, layers):
    return C.get_config(arch).replace(num_layers=layers)


def dist_batch(cfg, arch, step=0):
    from repro_torch.training.data import DataConfig, synthetic_batch
    shp = TRAIN[arch]
    return synthetic_batch(cfg, DataConfig(batch=shp["B"], seq_len=shp["S"]),
                           step)


def dist_shape(arch):
    from repro_torch.models.config import ShapeSpec
    shp = TRAIN[arch]
    return ShapeSpec("dist", shp["S"], shp["B"], "train")


def dist_two_steps(cfg, arch, step, state):
    """Two deterministic steps on batches 0 and 1: (state, metrics, the
    second step's seconds)."""
    with deterministic():
        for s in range(2):
            torch.cuda.synchronize()
            t = time.time()
            state, met = step(state, dist_batch(cfg, arch, s))
            torch.cuda.synchronize()
    return state, met, time.time() - t


def dist_one_by_one(C, smi):
    """World size 1: NCCL over a FileStore in this process, a 1 x 1 mesh;
    for each of DIST_ARCHS two mesh steps and two one-device steps from the
    same seeded state, deterministic, must be equal to the bit (state and
    metrics), and the mesh moves no collective byte.  The second step of
    each is timed.  Returns the results by arch and the kernel launches of
    the mesh steps alone."""
    import shutil
    import torch.distributed as dist
    from repro_torch.launch import dist as D
    from repro_torch.launch import steps as ST
    from repro_torch.training import optim as OPT
    work = os.path.join(ROOT, "build", "chip_smoke_dist")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    D.init_world(0, 1, os.path.join(work, "store"))
    out, launches = {}, {}
    try:
        mesh = D.Mesh({"data": 1, "model": 1})
        for arch in DIST_ARCHS:
            cfg = dist_cfg(C, arch, DIST_LAYERS)
            runs = []
            for m in (None, mesh):
                gc.collect()
                torch.cuda.empty_cache()
                gen = torch.Generator("cuda").manual_seed(SEED)
                state = ST.init_train_state(cfg, gen, "cuda", mesh=m)
                step = ST.make_train_step(cfg, dist_shape(arch),
                                          opt_cfg=OPT.AdamWConfig(**DIST_OPT),
                                          mesh=m)
                def two_steps():
                    return dist_two_steps(cfg, arch, step, state)
                state, met, step_s = two_steps() if m is None else \
                    counted(two_steps, launches)
                runs.append((state_digest(state),
                             {k: v.item() for k, v in met.items()}, step_s))
                del state, step, two_steps
            same = runs[0][:2] == runs[1][:2]
            out[arch] = dict(equal=same, loss=runs[1][1]["loss"],
                             step_s=runs[1][2],
                             collective_bytes=sum(mesh.bytes.values()))
            print(f"dist 1 x 1 mesh ({arch}, full width, {DIST_LAYERS} "
                  f"layers, bf16 over fp32 masters, deterministic, 2 "
                  f"steps): "
                  f"{'equal to the bit' if same else 'DIFFERENT'} to the "
                  f"one-device step (metrics {runs[1][1]} vs {runs[0][1]}; "
                  f"{len(runs[0][0]) - 1} leaves' digests; the second step "
                  f"s {runs[1][2]:.4f} vs {runs[0][2]:.4f}) [{smi}]",
                  flush=True)
            if not same or sum(mesh.bytes.values()):
                fail(f"dist: the 1 x 1 mesh step of {arch} differs from "
                     "the one-device step")
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


def _sq(x) -> float:
    """The sum of squares of `x`, a NaN counted as infinite."""
    inf = float("inf")
    return torch.nan_to_num(x.float(), nan=inf, posinf=inf,
                            neginf=-inf).square().sum().item()


def dist_compare(mesh, local, ref, ref32, before, spec_tree):
    """This rank's shards of a sharded state after one step (`local`)
    against the same shards of the one-device state (`ref`) and of the
    one-device float32 compute state (`ref32`) after it, `before` this
    rank's shards of the parameters before it: per leaf the sums of squares
    over the shard of local - ref32, ref - ref32 and ref32 - before (the
    moments: ref32), the parameters' ill-conditioned elements left out;
    and their largest difference from `ref` in units of lr
    (``dist_errors`` adds the ranks')."""
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import optim as OPT
    opt = OPT.AdamWConfig(**DIST_OPT)
    specs = dict(CKPT._flatten(spec_tree))
    mine, truth = dict(CKPT._flatten(local)), dict(CKPT._flatten(ref32))
    refs = dict(CKPT._flatten(ref))
    out = {"ill_lr": 0.0, "leaves": {}}
    for name, want in refs.items():
        if name == "['step']":
            continue
        want = mesh.local(want, specs[name]).float()
        got = mine[name].float()
        t = mesh.local(truth[name], specs[name]).float()
        if name.startswith("['params']"):
            v = name.replace("['params']", "['opt']['v']")
            ill = torch.zeros_like(t, dtype=torch.bool)
            for tree in (refs, truth):
                g = (mesh.local(tree[v], specs[v]).float()
                     / (1 - opt.b2)).sqrt()
                ill |= g < 100 * opt.eps
            if ill.any():
                worst = torch.nan_to_num((got - want)[ill].abs(),
                                         nan=float("inf")).max().item()
                out["ill_lr"] = max(out["ill_lr"], worst / DIST_OPT["lr"])
            well = ~ill
            out["leaves"][name] = (_sq((got - t)[well]),
                                   _sq((want - t)[well]),
                                   _sq((t - before[name].float())[well]))
        else:
            out["leaves"][name] = (_sq(got - t), _sq(want - t), _sq(t))
    return out


def dist_errors(each) -> dict:
    """The ranks' ``dist_compare`` results as DIST_TOL's errors: the
    largest ill-conditioned parameter difference, and the leaf whose error
    against float32 (2-norms over the whole leaf: a leaf held by several
    ranks counts in each, in all sums alike) comes nearest its bound, with
    the one-device step's error beside it.  A NaN or an infinite error is
    over its bound."""
    err = {"ill_lr": max(e["ill_lr"] for e in each), "worst": None,
           "over_bound": 0.0}
    for name in each[0]["leaves"]:
        d_mesh, d_one, r = (sum(e["leaves"][name][i] for e in each)
                            for i in range(3))
        e_mesh = (d_mesh / max(r, 1e-300)) ** 0.5
        e_one = (d_one / max(r, 1e-300)) ** 0.5
        bound = DIST_TOL["ratio"] * e_one + DIST_TOL[
            "param_floor" if name.startswith("['params']") else "floor"]
        over = e_mesh / bound if math.isfinite(e_mesh / bound) \
            else float("inf")
        if err["worst"] is None or over > err["over_bound"]:
            err.update(worst=name, sharded=e_mesh, one_device=e_one,
                       over_bound=over)
    return err


def dist_ranks(rank, world, meshes, deep):
    """One spawned rank of the dist phase (NCCL, card `rank`): for each mesh
    of `meshes` and each of DIST_ARCHS at DIST_LAYERS layers, one sharded
    step against the one-device step from the same seeded state (each rank
    holds both, and compares its shards); then each of `deep` {arch:
    depth} on the last mesh, DIST_DEEP_STEPS steps on one batch and one
    more, profiled on rank 0.  Returns
    this rank's numbers: errors, metrics, step seconds, peak memory, the
    collective bytes of a step, and the kernel launches of its sharded
    steps alone (the one-device references run outside the counted
    windows)."""
    import repro_torch.configs as C
    from repro_torch.launch import dist as D
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import steps as ST
    from repro_torch.models.moe import pick_num_groups
    from repro_torch.training import checkpoint as CKPT
    from repro_torch.training import optim as OPT
    opt = OPT.AdamWConfig(**DIST_OPT)
    out = {"device": torch.cuda.get_device_name(), "parity": [], "deep": [],
           "launches": {}}
    mesh = None
    for shape in meshes:
        mesh = D.Mesh(shape)
        ds = MS.axis_size(mesh, MS.data_axes(mesh))
        for arch in DIST_ARCHS:
            cfg = dist_cfg(C, arch, DIST_LAYERS)
            shp = TRAIN[arch]
            spec_tree = ST.train_state_pspecs(cfg, mesh)
            specs = dict(CKPT._flatten(spec_tree))
            gen = torch.Generator("cuda").manual_seed(SEED)
            full = ST.init_train_state(cfg, gen, "cuda")
            local = ST.shard_train_state(cfg, full, mesh)
            b = dist_batch(cfg, arch)
            step = ST.make_train_step(cfg, dist_shape(arch), opt_cfg=opt,
                                      mesh=mesh)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mesh.bytes.clear()
            torch.cuda.synchronize()
            t = time.time()
            local, m = counted(lambda: step(local, b), out["launches"])
            torch.cuda.synchronize()
            step_s = time.time() - t
            peak = torch.cuda.max_memory_allocated()
            moved = dict(mesh.bytes)
            groups = pick_num_groups(shp["B"] * shp["S"], ds) \
                if cfg.has_moe else None
            ref = ST.make_train_step(cfg, dist_shape(arch), opt_cfg=opt,
                                     num_groups=groups)
            full, mr = ref(full, b)
            cfg32 = cfg.replace(compute_dtype="float32")
            full32 = ST.init_train_state(
                cfg32, torch.Generator("cuda").manual_seed(SEED),
                "cuda")
            before = {f"['params']{n}": mesh.local(x, specs[f"['params']{n}"])
                      .clone() for n, x in CKPT._flatten(full32["params"])}
            full32, _ = ST.make_train_step(
                cfg32, dist_shape(arch), opt_cfg=opt,
                num_groups=groups)(full32, b)
            err = dist_compare(mesh, local, full, full32, before, spec_tree)
            out["parity"].append(dict(
                mesh=shape, arch=arch, layers=DIST_LAYERS,
                metrics={k: v.item() for k, v in m.items()},
                reference={k: v.item() for k, v in mr.items()}, errors=err,
                step_s=step_s, peak_bytes=peak, collective_bytes=moved))
            if rank == 0:
                brief = {k: v for k, v in out["parity"][-1].items()
                         if k != "errors"}
                print(f"  dist rank 0: {brief}", flush=True)
            del full, full32, local, step, ref, before
            gc.collect()
            torch.cuda.empty_cache()
    for arch, depth in deep.items():
        cfg = dist_cfg(C, arch, depth)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.time()
        state = ST.init_train_state(
            cfg, torch.Generator("cuda").manual_seed(SEED), mesh=mesh)
        init_s = time.time() - t
        step = ST.make_train_step(cfg, dist_shape(arch), opt_cfg=opt,
                                  mesh=mesh)
        b = dist_batch(cfg, arch)
        losses, times = [], []
        for _ in range(DIST_DEEP_STEPS):
            mesh.bytes.clear()
            torch.cuda.synchronize()
            t = time.time()
            state, m = counted(lambda: step(state, b), out["launches"])
            torch.cuda.synchronize()
            times.append(time.time() - t)
            losses.append(m["loss"].item())
        moved = dict(mesh.bytes)

        def one_more():
            torch.cuda.synchronize()
            t0 = time.time()
            step(state, b)
            torch.cuda.synchronize()
            return time.time() - t0
        if rank == 0:
            print(f"profile of one more {arch} step ({depth} layers) on rank "
                  f"0 of {mesh.shape}:", flush=True)
            counted(lambda: profile(one_more), out["launches"])
        else:
            counted(one_more, out["launches"])
        out["deep"].append(dict(
            mesh=mesh.shape, arch=arch, layers=depth, losses=losses,
            step_s=times, init_s=init_s,
            peak_bytes=torch.cuda.max_memory_allocated(),
            state_bytes=sum(x.numel() * x.element_size() for x in
                            OPT.leaves(state["params"])
                            + OPT.leaves(state["opt"])),
            collective_bytes=moved))
        if rank == 0:
            print(f"  dist rank 0: {out['deep'][-1]}", flush=True)
        del state, step
    return out


def dist_path(C, smi):
    """Phase 7, the distribution layer (``launch/dist.py``,
    ``launch/mesh.py``, ``make_train_step(mesh=)``): the 1 x 1 mesh in
    this process, then with 2 or more cards the ranks of DIST_MESHES
    (spawned, one a card) against the one-device step, and on 4 cards the
    deep runs of DIST_DEEP, whose losses must fall.  Prints a ``dist`` JSON
    line; with one card it says ``"ranks": 1``.  Its "launches" are the
    kernel launches of the mesh steps alone: "dist" those of the 1 x 1
    mesh in this process, "dist_ranks" rank 0's in the spawned ranks
    (every mesh of every world size; with one card there are none)."""
    from repro_torch.launch import dist as D
    one, launches = dist_one_by_one(C, smi)
    # the spawned rank 0 shares card 0 with this process
    gc.collect()
    torch.cuda.empty_cache()
    summary = {"one_by_one": one, "launches": {"dist": launches}}
    cards = torch.cuda.device_count()
    summary["ranks"] = max(k for k in (1,) + tuple(DIST_MESHES)
                           if k <= cards)
    for world, meshes in DIST_MESHES.items():
        if world > cards:
            continue
        deep = DIST_DEEP if world == 4 else {}
        stamp(f"dist: {world} ranks, meshes {list(meshes)}"
              + (f", then {deep} layers" if deep else ""))
        ranks = D.run_ranks(dist_ranks, world, meshes, deep,
                            timeout_s=1500,
                            workdir=os.path.join(ROOT, "build"))
        for i, p in enumerate(ranks[0]["parity"]):
            each = [res["parity"][i] for res in ranks]
            err = dist_errors([e["errors"] for e in each])
            print(f"dist mesh {p['mesh']} {p['arch']} ({p['layers']} layers, "
                  f"{world} ranks): metrics {p['metrics']} vs one device "
                  f"{p['reference']}; errors {err} "
                  f"(tolerances {DIST_TOL}); step s by rank "
                  f"{[round(e['step_s'], 3) for e in each]}, peak GiB by rank "
                  f"{[round(e['peak_bytes'] / 2**30, 2) for e in each]}, "
                  f"collective bytes a step (rank 0) {p['collective_bytes']} "
                  f"[{smi}]", flush=True)
            for k in ("loss", "grad_norm"):
                if not abs(p["metrics"][k] - p["reference"][k]) <= \
                        DIST_TOL[k] * abs(p["reference"][k]):
                    fail(f"dist {p['mesh']} {p['arch']}: {k} differs from "
                         "the one-device step")
            if not (err["ill_lr"] <= DIST_TOL["ill_lr"]
                    and err["over_bound"] <= 1.0):
                fail(f"dist {p['mesh']} {p['arch']}: errors {err}")
        for i, d in enumerate(ranks[0]["deep"]):
            each = [res["deep"][i] for res in ranks]
            print(f"dist mesh {d['mesh']} {d['arch']} ({d['layers']} layers, "
                  f"B {TRAIN[d['arch']]['B']} x {TRAIN[d['arch']]['S']}, "
                  f"{world} ranks): losses {d['losses']}, step s by rank "
                  f"{[[round(x, 4) for x in e['step_s']] for e in each]}, "
                  f"init s {[round(e['init_s'], 1) for e in each]}, state GiB "
                  f"by rank {[round(e['state_bytes'] / 2**30, 2) for e in each]}"
                  f", peak GiB by rank "
                  f"{[round(e['peak_bytes'] / 2**30, 2) for e in each]}, "
                  f"collective bytes a step (rank 0) {d['collective_bytes']} "
                  f"[{smi}]", flush=True)
            if not (np.isfinite(d["losses"]).all()
                    and d["losses"][-1] < d["losses"][0]):
                fail(f"dist {d['arch']} at {d['layers']} layers: the loss "
                     f"did not fall: {d['losses']}")
        summary[f"ranks_{world}"] = ranks
        into = summary["launches"].setdefault("dist_ranks", {})
        for k, n in ranks[0]["launches"].items():
            into[k] = into.get(k, 0) + n
        print(f"dist: rank 0's launches in the {world}-rank mesh steps: "
              f"{ranks[0]['launches']}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "dist_phase.json"), "w") as f:
        json.dump(summary, f)
    print("dist " + json.dumps({k: v for k, v in summary.items()
                                if not k.startswith("ranks_")}), flush=True)
    if summary["ranks"] == 1:
        print("dist: one card, so no multi-rank run (multi-GPU not "
              "measured in this run)", flush=True)
    return summary


# ------------------------------ phase 8: serving --------------------------------
#: the serving path (``make_prefill_step`` / ``make_decode_step``): olmo-1b,
#: qwen3-moe-30b-a3b, falcon-mamba-7b and mixtral-8x22b at full width and
#: SERVE_LAYERS layers in bfloat16: B rows of S prompt tokens into an
#: L-slot cache (its length splits over `model`), then `steps` decode steps
MIXTRAL_ARCH = "mixtral-8x22b"
SERVE_ARCHS = (DENSE_ARCH, MOE_ARCH, SSM_ARCH, MIXTRAL_ARCH)
SERVE_LAYERS = 2
SERVE = dict(B=4, S=512, L=1024, steps=3)
#: the mesh variants: prefill (banded: the sliding-window config) and
#: decode modes
SERVE_PREFILL = {"default": {}, "seq_parallel": dict(seq_parallel=True),
                 "banded": dict(banded=True)}
SERVE_DECODE = {"hd": {}, "lc_per_row": dict(cache_shard_mode="lc",
                                             per_row_write=True),
                "kv": dict(cache_shard_mode="kv"),
                "resident": dict(resident_weights=True)}
#: the spawned ranks' meshes by world size (one a card, NCCL); with one
#: card, SERVE_SHARED's two ranks share it, their collectives over gloo
#: through the host (NCCL refuses two ranks on one card)
SERVE_MESHES = {2: ({"data": 2, "model": 1}, {"data": 1, "model": 2}),
                4: ({"data": 2, "model": 2},)}
SERVE_SHARED = ({"data": 1, "model": 2},)
#: mixtral-8x22b on 4 cards, mesh (2, 2): B x S prompt tokens over its
#: 4096-token window (banded), then `steps` decode steps in each mode.  In
#: bf16 ~281 GB of weights, ~65.5 GiB a card; ``serve_depth`` picks the
#: deepest depth whose peak (measured at SERVE_CAL layers, the layers past
#: them added from the sharding rules) fits SERVE_FIT of the card
SERVE_DEEP = dict(arch=MIXTRAL_ARCH, B=4, S=8192, steps=32,
                  modes=("hd", "lc_per_row", "resident"), seq_parallel=True)
#: a batch that does not split over the data axes (JAX's long_500k decode
#: layout: every data rank holds the row, the cache splits its slots over
#: them): hymba-1.5b at full width and depth in bf16, B rows of S prompt
#: tokens (its 1024-slot ring wraps S / 1024 times) into a cache of S +
#: steps, then `steps` decode steps in each mode, on `mesh`: four ranks
#: sharing card 0 over gloo with one card (`shared_steps` steps a mode:
#: the script's time limit), one a card over NCCL with four;
#: then falcon-mamba-7b at `ssm_layers` layers on `ssm_mesh` (no KV cache:
#: its conv and SSM states whole over `data`), `ssm_steps` decode steps a
#: mode.  Each step against the one-device step by SERVE_TOL's rule.
#: hymba's hd mode runs kernel (b) on a rank's 512 slots and 32 head_dim
#: columns.  Ranks sharing a card pay ~3-5 ms a collective (gloo through
#: the host, four processes on one card): hymba's FSDP decode modes take
#: ~2.6-3.3 s a step there, falcon-mamba's 1.5-1.7 s (its 0.73 GB of
#: embedding and head gathered a step), hence its 3 steps
SERVE_B1 = dict(arch=HYBRID_ARCH, B=1, S=8192, steps=32, shared_steps=8,
                mesh={"data": 2, "model": 2},
                modes=("hd", "lc_per_row", "kv", "resident"),
                ssm_arch=SSM_ARCH, ssm_layers=2, ssm_steps=3,
                ssm_mesh={"data": 2, "model": 1})
#: the deep run at batch 1 on 4 cards: mixtral-8x22b (its 4096-slot ring:
#: the hd mode's kernel (b) on 2048 slots x 64 columns), the banded prefill
#: and SERVE_DEEP's rules otherwise
SERVE_B1_DEEP = dict(SERVE_DEEP, B=1, seq_parallel=False)
#: the share of a card's memory (free plus PyTorch's cache, at the start of
#: the deep run) a rank's estimated peak may take, and the depth at which
#: the prefill's peak is measured to calibrate the estimate (on H100 80GB
#: HBM3 cards at 700 W the estimate put 54 layers at 71.32 GiB, and the
#: prefill peaked at 71.32 GiB there, with 75.35 GiB free + cached: 0.95
#: stopped at 54 layers, whose 56 need 73.70)
SERVE_FIT = 0.98
SERVE_CAL = 4
#: the sequence-parallel prefill at depth: mixtral where ZeRO-3's whole-layer
#: gather fits SERVE_FIT of the card by the estimate, else this config at
#: full depth
SERVE_SEQ_FALLBACK = MOE_ARCH
#: bfloat16 parity of a mesh step with the one-device step, each against
#: the same step in float32 compute: a tensor's error is ||x - x32|| /
#: ||x32|| (2-norms over the whole tensor, a NaN infinite); a mesh step's
#: may be at most `ratio` times the one-device bf16 step's plus `floor`.
#: The bf16 steps round partial sums in another order than each other (a
#: tensor-parallel product rounds each rank's partial before the sum), and
#: a near-tie of the MoE routing may send a row to another expert, so they
#: differ by bf16's noise; a wrong shard gives an error of order 1.
SERVE_TOL = dict(ratio=2.0, floor=2e-3)
#: the kernels each serving path must launch: the 1 x 1 mesh's steps
#: (``serve``), rank 0's of the spawned ranks' at 2 layers (``serve_ranks``:
#: (a) in lc, (b) in hd), of SERVE_B1's runs (``serve_b1``: every decode
#: layout's slots split over `data`, so kernel 2 runs nowhere, (a) in lc and
#: kv, (b) over a slot range with its lse in hd and resident), of the
#: 4-card batch-1 mixtral run (``serve_b1_deep``) and of SERVE_VLM's runs
#: (``serve_vlm``: the 1 x 1 mesh's steps and rank 0's)
_SERVE_KERNELS = ("flash_attention", "decode_attention", "gmm",
                  "selective_scan")
_B1_KERNELS = ("flash_attention", "decode_attention_lse",
               "decode_attention_hd_scores", "decode_attention_hd_out")
SERVE_NEEDED = {
    "serve": _SERVE_KERNELS,
    "serve_ranks": _SERVE_KERNELS + ("decode_attention_lse",
                                     "decode_attention_hd_scores",
                                     "decode_attention_hd_out"),
    "serve_b1": _B1_KERNELS + ("selective_scan",),
    "serve_b1_deep": _B1_KERNELS + ("gmm",),
    # SERVE_VLM: kernel 2 in the 1 x 1 mesh's decode and the kv mode's on
    # the ranks (1 kv head: heads over `model`), (a) in lc, (b) in hd and
    # resident
    "serve_vlm": ("flash_attention", "decode_attention",
                  "decode_attention_lse", "decode_attention_hd_scores",
                  "decode_attention_hd_out")}
#: the deep decode modes' logits against the hd mode's: at most the worst
#: 2-layer mesh error times the depth ratio, and never more than `cap`
#: (unrelated logits differ by ~1.4)
SERVE_DEEP_CAP = 0.3


def serve_cfg(C, arch, layers=SERVE_LAYERS, compute="bfloat16"):
    """`arch` at `layers` layers (None: its full depth) in `compute`."""
    cfg = C.get_config(arch)
    return cfg.replace(num_layers=layers or cfg.num_layers,
                       compute_dtype=compute)


def rank_weights(cfg, mesh, specs):
    """`cfg`'s weights drawn from SEED on the mesh's device (every rank the
    same), this rank's shards of `specs` (a step's ``param_pspecs``)."""
    from repro_torch.launch import mesh as MS
    from repro_torch.models.params import init_params
    return init_params(cfg, torch.Generator(mesh.device).manual_seed(SEED),
                       mesh.device, local=lambda n, t: MS.local_shard(
                           t, specs["layers"][n][1:] if n in specs["layers"]
                           else specs[n], mesh, mesh.coords))


def timed_counted(fn, launches):
    """(fn(), its seconds between two synchronizations), its launches
    added to `launches` (``counted``)."""
    torch.cuda.synchronize()
    t = time.time()
    out = counted(fn, launches)
    torch.cuda.synchronize()
    return out, time.time() - t


def _tree_bytes(tree) -> int:
    """The bytes of the tensors of a tree (params, a cache; None: 0)."""
    from repro_torch.training import optim as OPT
    return sum(x.numel() * x.element_size() for x in OPT.leaves(tree)
               if isinstance(x, torch.Tensor)) if tree else 0


def decode_modes(cfg, mesh, pre, cache0, batches, modes, dshape, launches):
    """Each decode mode of `modes` (SERVE_DECODE's keys) at `dshape` on
    `mesh`, from a copy of the prefill step `pre`'s cache `cache0`
    resharded into the mode's layout, every rank drawing the same weights
    (SEED) and keeping its shards, fed `batches` in turn; the steps'
    launches go into `launches`.  Returns ({mode: (stacked logits, final
    cache) gathered whole on the CPU}, {mode: this rank's numbers}):
    decode ms a token (the mean of the steps after the first), peak and
    state GiB (the rank's weights and cache), collective bytes of a
    step."""
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import steps as ST
    gib = 2 ** 30
    runs, stats = {}, {}
    for mode in modes:
        step, _ = ST.make_decode_step(cfg, mesh, dshape, **SERVE_DECODE[mode])
        cache = ST.reshard_cache(mesh, {n: v.clone() if isinstance(
            v, torch.Tensor) else v for n, v in cache0.items()},
            pre.cache_pspecs, step.cache_pspecs)
        params = rank_weights(cfg, mesh, step.param_pspecs)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ls, times, moved = [], [], None
        for b in batches:
            mesh.bytes.clear()
            (lg, cache), took = timed_counted(lambda: step(params, b, cache),
                                              launches)
            times.append(took)
            moved = moved or dict(mesh.bytes)
            ls.append(mesh.full(lg, step.logits_pspec).cpu())
        stats[mode] = dict(
            decode_ms=1e3 * float(np.mean(times[1:])),
            peak_gib=torch.cuda.max_memory_allocated() / gib,
            state_gib=(_tree_bytes(params) + _tree_bytes(cache)) / gib,
            collective_bytes=moved)
        runs[mode] = (torch.stack(ls), _cpu(MS.gather_tree(
            mesh, cache, step.cache_pspecs)))
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()
    return runs, stats


def parity_report(C, tag, runs, refs, smi, where=""):
    """Each of `runs` ({(arch, kind, variant): (logits, cache)} gathered
    whole) against refs[(arch, kind)], (the one-device bf16 run, the
    float32 one), by SERVE_TOL's rule (``serve_b1_errors``), a line each;
    a decode's greedy tokens that differ from the one-device bf16 step's
    are listed with the one-device logit gap between the two.  Fails on a
    run outside the bound or with other positions.  Returns ({"<arch>
    <kind> <variant>": summary}, the worst share of the bound)."""
    summary, worst = {}, 0.0
    for (arch, kind, variant), val in runs.items():
        one, ref32 = refs[(arch, kind)]
        errs, exact = serve_b1_errors(val, one, ref32)
        over = serve_over_bound(errs)
        worst = max(worst, over)
        flips = []
        if kind == "decode":
            cfg = C.get_config(arch)
            mine, theirs = (_greedy(cfg, x[:, :, 0]) for x in (val[0],
                                                                one[0]))
            for i, j in zip(*np.nonzero(mine != theirs)):
                a, b = int(theirs[i, j]), int(mine[i, j])
                flips.append((int(i), int(j), a, b, round(float(
                    one[0][i, j, 0, a] - one[0][i, j, 0, b]), 4)))
        key = f"{arch} {kind} {variant}"
        summary[key] = dict(
            over_bound=over, exact=exact, greedy_differs=flips,
            logits=max((m, o) for n, (m, o) in errs.items()
                       if n.startswith("logits")))
        print(f"{tag} {key}{where}: {over:.3f} of the bound ({SERVE_TOL}, "
              f"each step and cache tensor; worst logits (mesh, one device) "
              f"vs float32 {summary[key]['logits']}); positions "
              f"{'equal' if exact else 'DIFFERENT'}"
              + (f"; greedy tokens that differ from the one-device bf16 "
                 f"step's (step, row, its token, this token, its logit gap "
                 f"between them): {flips}" if kind == "decode" else "")
              + f" [{smi}]", flush=True)
        if not (over <= 1.0 and exact):
            fail(f"{tag} {key}: {errs}")
    return summary, worst


def serve_batches(cfg, B, S, steps, seed=SEED):
    """The prompt (B x S random tokens, positions arange) and `steps`
    decode batches (random tokens at positions S, S + 1, ...), numpy."""
    rng = np.random.default_rng(seed)
    pre = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "positions": np.tile(np.arange(S, dtype=np.int32), (B, 1))}
    dec = [{"tokens": rng.integers(0, cfg.vocab_size, (B, 1)).astype(
        np.int32), "positions": np.full((B, 1), S + i, np.int32)}
        for i in range(steps)]
    return pre, dec


def serve_groups(cfg, data_shards):
    B, S = SERVE["B"], SERVE["S"]
    if not cfg.has_moe:
        return 1, 1
    from repro_torch.models.moe import pick_num_groups
    return pick_num_groups(B * S, data_shards), pick_num_groups(B,
                                                                 data_shards)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True) \
        if isinstance(tree, torch.Tensor) else tree


def serve_one_device(cfg, params, data_shards, shape=None, seed=SEED):
    """The one-device prefill and decode chain at `shape` (B rows of S
    prompt tokens into an L-slot cache, `steps` decode steps; SERVE's by
    default) in the capacity groups of a mesh with `data_shards` data
    shards (with one, through the builders): {"prefill": (logits, cache),
    "decode": (stacked logits, final cache)}, on the CPU."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MDL
    from repro_torch.models.config import ShapeSpec
    B, S, L, steps = ((shape or SERVE)[k] for k in ("B", "S", "L", "steps"))
    pre, dec = serve_batches(cfg, B, S, steps, seed)
    gp, gd = serve_groups(cfg, data_shards)
    t = {k: torch.from_numpy(v).cuda() for k, v in pre.items()}
    with torch.no_grad():
        if data_shards == 1:
            step, _ = ST.make_prefill_step(cfg, None, ShapeSpec(
                "p", S, B, "prefill"), cache_len=L)
            logits, cache = step(params, pre)
        else:
            cache = MDL.init_cache(cfg, B, L, device="cuda")
            logits, cache = MDL.forward(cfg, params, t, "prefill", cache,
                                        remat=False, last_only=True,
                                        num_groups=gp)
            logits = logits[:, -1]
        out = {"prefill": (logits.cpu(), _cpu(cache))}
        decode, _ = ST.make_decode_step(cfg, None,
                                        ShapeSpec("d", L, B, "decode"))
        ls = []
        for b in dec:
            if data_shards == 1:
                lg, cache = decode(params, b, cache)
            else:
                lg, cache = MDL.forward(
                    cfg, params, {k: torch.from_numpy(v).cuda()
                                  for k, v in b.items()}, "decode", cache,
                    remat=False, num_groups=gd)
            ls.append(lg.cpu())
        out["decode"] = (torch.stack(ls), _cpu(cache))
    return out


def serve_references(C, data_shards):
    """{(arch, compute dtype, data shards): serve_one_device} for every
    serving config, its weights drawn from SEED on the card."""
    from repro_torch.models.params import init_params
    refs = {}
    for arch in SERVE_ARCHS:
        for compute in ("bfloat16", "float32"):
            cfg = serve_cfg(C, arch, compute=compute)
            params = init_params(cfg, torch.Generator("cuda").manual_seed(
                SEED), "cuda")
            for ds in data_shards:
                if ds > 1 and not cfg.has_moe:
                    refs[(arch, compute, ds)] = refs[(arch, compute, 1)]
                    continue
                refs[(arch, compute, ds)] = serve_one_device(cfg, params, ds)
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return refs


def _rel(x, ref) -> float:
    """||x - ref|| / ||ref|| in float64, a NaN or an inf infinite."""
    d = (x.double() - ref.double())
    if not torch.isfinite(d).all():
        return float("inf")
    return (d.norm() / max(ref.double().norm().item(), 1e-300)).item()


def serve_errors(got, one, ref32):
    """Per output tensor (logits; the cache's k, v, conv, h) the mesh
    step's and the one-device bf16 step's errors against float32, and
    whether the integer parts (slot positions, cursors) agree."""
    out = {"logits": (_rel(got[0], ref32[0]), _rel(one[0], ref32[0]))}
    exact = True
    for k, w in ref32[1].items():
        if k in ("k", "v", "conv", "h"):
            out[k] = (_rel(got[1][k], w), _rel(one[1][k], w))
        elif k in got[1] and k != "row_idx":
            exact &= bool(torch.equal(torch.as_tensor(got[1][k]),
                                      torch.as_tensor(w)))
    return out, exact


def serve_over_bound(errs) -> float:
    """The largest ratio of an error to its bound (SERVE_TOL)."""
    return max(m / (SERVE_TOL["ratio"] * o + SERVE_TOL["floor"])
               for m, o in errs.values())


def serve_mesh_runs(C, mesh, arch, launches):
    """Every variant of `arch` at SERVE's shapes on `mesh` (a dist.Mesh),
    each rank drawing the same weights (SEED) and keeping its shards of
    the variant's layout; the outputs gathered whole, on the CPU.  The
    mesh steps' launches go into `launches`."""
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import ShapeSpec
    cfg = serve_cfg(C, arch)
    B, S, L, steps = (SERVE[k] for k in ("B", "S", "L", "steps"))
    pre_b, dec_b = serve_batches(cfg, B, S, steps)
    pshape, dshape = (ShapeSpec("p", S, B, "prefill"),
                      ShapeSpec("d", L, B, "decode"))

    out = {}
    for k in SERVE_PREFILL:
        if k == "banded" and not cfg.sliding_window:
            continue
        step, _ = ST.make_prefill_step(cfg, mesh, pshape, cache_len=L,
                                       **SERVE_PREFILL[k])
        params = rank_weights(cfg, mesh, step.param_pspecs)
        mesh.bytes.clear()
        logits, cache = counted(lambda: step(params, pre_b), launches)
        out[("prefill", k)] = (mesh.full(logits, step.logits_pspec).cpu(),
                               _cpu(MS.gather_tree(mesh, cache,
                                                   step.cache_pspecs)),
                               dict(mesh.bytes))
        if k == "default":        # the decode modes start from its cache
            pre, cache0 = step, cache
        del params, cache
    for k, kw in SERVE_DECODE.items():
        step, _ = ST.make_decode_step(cfg, mesh, dshape, **kw)
        cache = ST.reshard_cache(mesh, {n: v.clone() if isinstance(
            v, torch.Tensor) else v for n, v in cache0.items()},
            pre.cache_pspecs, step.cache_pspecs)
        params = rank_weights(cfg, mesh, step.param_pspecs)
        mesh.bytes.clear()

        def run():
            ls = []
            c = cache
            for b in dec_b:
                lg, c = step(params, b, c)
                ls.append(mesh.full(lg, step.logits_pspec).cpu())
            return torch.stack(ls), c
        logits, cache = counted(run, launches)
        out[("decode", k)] = (logits, _cpu(MS.gather_tree(
            mesh, cache, step.cache_pspecs)), dict(mesh.bytes))
        del params, cache
        gc.collect()
        torch.cuda.empty_cache()
    del cache0
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_one_by_one(C, smi, refs):
    """World size 1 (NCCL over a FileStore in this process), a 1 x 1 mesh:
    every variant of every serving config equal to the bit to the
    one-device builders' step, moving no collective byte.  Returns the
    results and the mesh steps' launches (the ``serve`` path)."""
    import shutil
    import torch.distributed as dist
    from repro_torch.launch import dist as D
    work = os.path.join(ROOT, "build", "chip_smoke_serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    D.init_world(0, 1, os.path.join(work, "store"))
    out, launches = {}, {}
    try:
        mesh = D.Mesh({"data": 1, "model": 1})
        for arch in SERVE_ARCHS:
            ref = refs[(arch, "bfloat16", 1)]
            got = serve_mesh_runs(C, mesh, arch, launches)
            for (kind, k), (g0, g1, moved) in got.items():
                w0, w1 = ref[kind]
                same = torch.equal(g0, w0) and all(
                    torch.equal(torch.as_tensor(g1[n]), torch.as_tensor(v))
                    for n, v in w1.items())
                out[(arch, kind, k)] = same
                if not same or sum(moved.values()):
                    fail(f"serve: the 1 x 1 mesh {kind} {k} of {arch} "
                         "differs from the one-device step")
            print(f"serve 1 x 1 mesh ({arch}, full width, {SERVE_LAYERS} "
                  f"layers, bf16, B {SERVE['B']} x {SERVE['S']} prompt, "
                  f"{SERVE['steps']} decode steps): every variant "
                  f"({sorted(got)}) equal to the bit to the one-device "
                  f"builders [{smi}]", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return out, launches


def serve_memory(C, mesh, arch, seq_parallel=False, spec=SERVE_DEEP) -> dict:
    """A rank's bytes of `arch` at full width on `mesh`, by layout (the
    prefill's, and unless `seq_parallel` each decode mode's of `spec`):
    a layer's shards, the largest per-layer gather (FSDP: the layer's
    leaves whole over the data axes; ZeRO-3: the whole layer; resident:
    none) and the leaves outside the stack; and the cache a layer."""
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as MDL
    from repro_torch.models import params as PRM
    full = C.get_config(arch)
    B, S, steps = (spec[k] for k in ("B", "S", "steps"))
    ds = mesh.size(MS.data_axes(mesh))
    layouts = {"prefill": (MS.param_pspecs_zero3(full, mesh), "zero3")
               if seq_parallel else (MS.param_pspecs(full, mesh), "fsdp")}
    if not seq_parallel:
        for mode in spec["modes"]:
            kw = SERVE_DECODE[mode]
            res = kw.get("resident_weights", False)
            layouts[mode] = (MS.param_pspecs(
                full, mesh, fsdp=not res, resident=res,
                attn_mode=ST.decode_attn_mode(full, kw.get(
                    "cache_shard_mode", "hd"))), "resident" if res else "fsdp")
    specs = PRM.param_specs(full)
    cache = MDL.cache_specs(full, B, S + steps)
    cps = MS.cache_pspecs(full, mesh, cache)
    cache_b = sum(int(np.prod(MS.local_shape(s, cps[k], mesh))) * dt.itemsize
                  for k, (s, dt) in cache.items()) // full.num_layers
    out = {"cache_layer": cache_b, "layouts": {}}
    for name, (pspecs, kind) in layouts.items():
        layer = gather = 0
        for n, (shp, _) in specs["layers"].items():
            dt = PRM._dtype(full, n).itemsize
            local = int(np.prod(MS.local_shape(shp, pspecs["layers"][n],
                                               mesh))) * dt // shp[0]
            layer += local
            if kind == "zero3":
                gather += int(np.prod(shp[1:])) * dt
            elif kind == "fsdp" and any(e is not None and e != "model"
                                        for e in pspecs["layers"][n][1:]):
                gather += local * ds
        top = sum(int(np.prod(MS.local_shape(spec[0], pspecs[n], mesh)))
                  * PRM._dtype(full, n).itemsize
                  for n, spec in specs.items() if n != "layers")
        out["layouts"][name] = dict(layer=layer, gather=gather, top=top)
    return out


def serve_depth(mem, peak_cal, cal_layers, budget, max_depth):
    """The deepest depth (at most `max_depth`) whose peak fits `budget`: the
    prefill's measured peak at `cal_layers` layers plus a layer's shards
    and cache for each layer more; each decode layout's shards, gather,
    outer leaves and two caches (the prefill's and the mode's copy)."""
    pre = mem["layouts"]["prefill"]

    def peak(d):
        p = peak_cal + (d - cal_layers) * (pre["layer"] + mem["cache_layer"])
        for name, lay in mem["layouts"].items():
            if name != "prefill":
                p = max(p, lay["layer"] * d + lay["gather"] + lay["top"]
                        + 2 * mem["cache_layer"] * d)
        return p
    depth = max_depth
    while depth > cal_layers and peak(depth) > budget:
        depth -= 1
    return depth, peak(depth), peak(max_depth)


def _profiled_step(fn):
    """(wall s, device busy s) of fn() under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
               and not e.name().startswith("nccl:")) / 1e9
    return wall, busy


def serve_deep(C, mesh, rank, launches, spec=SERVE_DEEP):
    """mixtral-8x22b at full width on the mesh (4 cards, 2 x 2): the banded
    prefill of `spec`'s prompt (SERVE_DEEP, or SERVE_B1_DEEP's one row) at
    the deepest depth that fits, then `steps` decode steps in each mode
    from its cache (the hd mode feeds its greedy tokens; the other modes
    the same tokens), one more step of each mode profiled; then, where
    `spec` says, the sequence-parallel prefill (mixtral where ZeRO-3 fits,
    else SERVE_SEQ_FALLBACK at full depth).  Returns this rank's numbers
    and logits (its shards, on the CPU)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import ShapeSpec
    arch = spec["arch"]
    B, S, steps = (spec[k] for k in ("B", "S", "steps"))
    pre_b, _ = serve_batches(C.get_config(arch), B, S, 0, seed=SEED + 8)

    def weights(c, specs):
        t = time.time()
        p = rank_weights(c, mesh, specs)
        torch.cuda.synchronize()
        return p, time.time() - t

    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(mesh.device)
    budget = SERVE_FIT * (free + torch.cuda.memory_reserved(mesh.device))

    def fitting(a, seq):
        """(depth, figures): the prefill at SERVE_CAL layers measured, the
        rest estimated (serve_memory, serve_depth)."""
        mem = serve_memory(C, mesh, a, seq, spec)
        c = C.get_config(a).replace(num_layers=SERVE_CAL)
        step, _ = ST.make_prefill_step(c, mesh, ShapeSpec("p", S, B,
                                                          "prefill"),
                                       cache_len=S + steps,
                                       seq_parallel=seq, banded=not seq)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        p, _ = weights(c, step.param_pspecs)
        counted(lambda: step(p, pre_b), launches)
        torch.cuda.synchronize()
        peak_cal = torch.cuda.max_memory_allocated()
        del p
        gc.collect()
        torch.cuda.empty_cache()
        # every rank takes the least depth that fits every rank
        d, at, full = serve_depth(mem, peak_cal, SERVE_CAL, budget,
                                  C.get_config(a).num_layers)
        t = torch.tensor([d], device=mesh.device)
        mesh.all_reduce_(t, mesh.axis_names, op=torch.distributed.ReduceOp.MIN)
        d = int(t.item())
        gib = 2 ** 30
        return d, dict(
            calibration_layers=SERVE_CAL,
            calibration_peak_gib=round(peak_cal / gib, 2),
            per_layer_gib={k: round(v["layer"] / gib, 3)
                           for k, v in mem["layouts"].items()},
            gather_gib={k: round(v["gather"] / gib, 3)
                        for k, v in mem["layouts"].items()},
            cache_gib_a_layer=round(mem["cache_layer"] / gib, 4),
            budget_gib=round(budget / gib, 2),
            peak_gib_at_depth=round(serve_depth(mem, peak_cal, SERVE_CAL,
                                                float("inf"), d)[1] / gib, 2),
            peak_gib_full_depth=round(full / gib, 2))

    depth, figures = fitting(arch, False)
    cfg = C.get_config(arch).replace(num_layers=depth)

    out = {"arch": arch, "depth": depth, "figures": figures, "modes": {},
           "mesh": dict(mesh.shape)}
    pshape = ShapeSpec("p", S, B, "prefill")
    pre, _ = ST.make_prefill_step(cfg, mesh, pshape, cache_len=S + steps,
                                  banded=True)
    out["rows_split"] = pre.logits_pspec[0] is not None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, out["init_s"] = weights(cfg, pre.param_pspecs)
    mesh.bytes.clear()
    torch.cuda.synchronize()
    t = time.time()
    logits, cache0 = counted(lambda: pre(params, pre_b), launches)
    torch.cuda.synchronize()
    out["prefill"] = dict(
        s=time.time() - t, peak_bytes=torch.cuda.max_memory_allocated(),
        state_bytes=_tree_bytes(params) + _tree_bytes(cache0),
        collective_bytes=dict(mesh.bytes),
        finite=bool(torch.isfinite(logits).all()))
    first = mesh.full(logits, pre.logits_pspec).argmax(-1)     # (B,)
    del params, logits
    dshape = ShapeSpec("d", S + steps, B, "decode")
    fed = None
    for mode in spec["modes"]:
        step, _ = ST.make_decode_step(cfg, mesh, dshape,
                                      **SERVE_DECODE[mode])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cache = ST.reshard_cache(mesh, {n: v.clone() if isinstance(
            v, torch.Tensor) else v for n, v in cache0.items()},
            pre.cache_pspecs, step.cache_pspecs)
        params, init_s = weights(cfg, step.param_pspecs)
        toks = [first.cpu().numpy()] if fed is None else fed
        shards, greedy, times, moved = [], [], [], None
        for i in range(steps):
            b = {"tokens": toks[i].astype(np.int32)[:, None],
                 "positions": np.full((B, 1), S + i, np.int32)}
            mesh.bytes.clear()
            torch.cuda.synchronize()
            t = time.time()
            lg, cache = counted(lambda: step(params, b, cache), launches)
            torch.cuda.synchronize()
            times.append(time.time() - t)
            moved = moved or dict(mesh.bytes)
            shards.append(lg.float().cpu())
            top = mesh.full(lg, step.logits_pspec)[:, 0].float()
            greedy.append(top.argmax(-1).cpu().numpy())
            if fed is None and i + 1 < steps:
                toks.append(greedy[-1])
        if fed is None:
            fed = toks
        b = {"tokens": toks[-1].astype(np.int32)[:, None],
             "positions": np.full((B, 1), S + steps, np.int32)}
        wall, busy = counted(lambda: _profiled_step(
            lambda: step(params, b, cache)), launches)
        # where one more step's device time goes: every rank runs it (its
        # collectives need them all), rank 0 under the profiler
        def timed():
            torch.cuda.synchronize()
            t0 = time.time()
            step(params, b, cache)
            torch.cuda.synchronize()
            return time.time() - t0
        if rank == 0:
            print(f"profile of one more {mode} decode step of {arch} "
                  f"({depth} layers) on rank 0:", flush=True)
            counted(lambda: profile(timed), launches)
        else:
            counted(timed, launches)
        out["modes"][mode] = dict(
            logits=torch.stack(shards), greedy=np.stack(greedy),
            step_s=times, init_s=init_s, profiled_wall_s=wall,
            profiled_busy_s=busy, idle_share=1 - busy / wall,
            peak_bytes=torch.cuda.max_memory_allocated(),
            state_bytes=_tree_bytes(params) + _tree_bytes(cache),
            collective_bytes=moved)
        if rank == 0:
            print(f"  serve deep rank 0 {mode}: "
                  f"{ {k: v for k, v in out['modes'][mode].items() if k not in ('logits', 'greedy')} }",
                  flush=True)
        del params, cache
    del cache0
    gc.collect()
    torch.cuda.empty_cache()
    if not spec["seq_parallel"]:
        return out
    # the sequence-parallel prefill
    seq_depth, seq_fig = fitting(arch, True)
    seq_arch = arch if seq_depth == C.get_config(arch).num_layers else \
        SERVE_SEQ_FALLBACK
    scfg = C.get_config(seq_arch)
    step, _ = ST.make_prefill_step(scfg, mesh, pshape, cache_len=S,
                                   seq_parallel=True)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = weights(scfg, step.param_pspecs)
    sb, _ = serve_batches(scfg, B, S, 0, seed=SEED + 9)
    mesh.bytes.clear()
    torch.cuda.synchronize()
    t = time.time()
    logits, cache = counted(lambda: step(params, sb), launches)
    torch.cuda.synchronize()
    out["seq_parallel"] = dict(
        arch=seq_arch, layers=scfg.num_layers, mixtral_figures=seq_fig,
        mixtral_depth_that_fits=seq_depth, s=time.time() - t,
        init_s=init_s, peak_bytes=torch.cuda.max_memory_allocated(),
        state_bytes=_tree_bytes(params) + _tree_bytes(cache),
        collective_bytes=dict(mesh.bytes),
        finite=bool(torch.isfinite(logits).all()))
    del params, cache, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_ranks(rank, world, meshes, deep, backend):
    """One spawned rank of the serve phase (card rank % cards): every
    config and variant at SERVE's shapes on each mesh of `meshes`; then,
    with `deep`, ``serve_deep`` on the last mesh.  Returns rank 0's
    gathered outputs (the others': None), and every rank's launches of its
    mesh steps and deep numbers."""
    import repro_torch.configs as C
    from repro_torch.launch import dist as D
    out = {"device": torch.cuda.get_device_name(), "runs": {},
           "launches": {}, "deep": None}
    mesh = None
    for shape in meshes:
        mesh = D.Mesh(shape)
        for arch in SERVE_ARCHS:
            t = time.time()
            got = serve_mesh_runs(C, mesh, arch, out["launches"])
            if rank == 0:
                print(f"  serve rank 0: mesh {shape} {arch} "
                      f"{len(got)} variants in {time.time() - t:.1f} s",
                      flush=True)
                for key, val in got.items():
                    out["runs"][(tuple(shape.items()), arch) + key] = val
    if deep:
        out["deep"] = serve_deep(C, mesh, rank, out["launches"])
    return out


def serve_path(C, smi):
    """Phase 8, the serving half of distribution (``make_prefill_step``,
    ``make_decode_step``, ``launch.mesh.ServeShards``): the one-device
    references in bf16 and float32, the 1 x 1 mesh equal to the bit to the
    one-device builders, then spawned ranks on the meshes of SERVE_MESHES
    that fit the cards (with one card SERVE_SHARED's two ranks on it) at 2
    layers against the one-device step (SERVE_TOL), and on 4 cards the
    deep mixtral run.  Prints a ``serve`` JSON line; "launches": "serve"
    those of the 1 x 1 mesh steps, "serve_ranks" rank 0's of the spawned
    ranks."""
    from repro_torch.launch import dist as D
    cards = torch.cuda.device_count()
    worlds = [(w, m, None) for w, m in SERVE_MESHES.items() if w <= cards]
    if not worlds:
        worlds = [(2, SERVE_SHARED, "gloo")]
    stamp("serve: the one-device references (bf16, float32)")
    ds = sorted({1} | {s.get("pod", 1) * s["data"] for _, ms, _ in worlds
                       for s in ms})
    refs = serve_references(C, ds)
    stamp("serve: the 1 x 1 mesh")
    one, launches = serve_one_by_one(C, smi, refs)
    summary = {"one_by_one": len(one), "launches": {"serve": launches},
               "parity": [], "deep": None, "ranks": cards,
               "shared_card": worlds[0][2] == "gloo"}
    worst = 0.0
    for world, meshes, backend in worlds:
        deep = world == 4
        stamp(f"serve: {world} ranks{' on one card (gloo)' if backend else ''}"
              f", meshes {list(meshes)}"
              + (f", then {SERVE_DEEP['arch']} deep" if deep else ""))
        gc.collect()
        torch.cuda.empty_cache()
        ranks = D.run_ranks(serve_ranks, world, meshes, deep, backend,
                            timeout_s=2400, backend=backend,
                            workdir=os.path.join(ROOT, "build"))
        for key, (logits, cache, moved) in ranks[0]["runs"].items():
            shape, arch, kind, variant = dict(key[0]), key[1], key[2], key[3]
            n = shape.get("pod", 1) * shape["data"]
            ref, ref32 = (refs[(arch, c, n)][kind]
                          for c in ("bfloat16", "float32"))
            errs, exact = serve_errors((logits, cache), ref, ref32)
            over = serve_over_bound(errs)
            worst = max(worst, max(m for m, _ in errs.values()))
            summary["parity"].append(dict(
                mesh=shape, arch=arch, kind=kind, variant=variant,
                errors=errs, over_bound=over, exact=exact,
                collective_bytes=moved))
            print(f"serve mesh {shape} {arch} {kind} {variant} ({world} "
                  f"ranks): errors vs float32 (mesh, one device) {errs}; "
                  f"{over:.3f} of the bound ({SERVE_TOL}); positions "
                  f"{'equal' if exact else 'DIFFERENT'}; collective bytes "
                  f"(rank 0) {moved} [{smi}]", flush=True)
            if not (over <= 1.0 and exact):
                fail(f"serve {shape} {arch} {kind} {variant}: {errs}")
        into = summary["launches"].setdefault("serve_ranks", {})
        for k, n in ranks[0]["launches"].items():
            into[k] = into.get(k, 0) + n
        print(f"serve: rank 0's launches in the {world}-rank mesh steps: "
              f"{ranks[0]['launches']}", flush=True)
        if deep:
            summary["deep"] = serve_deep_report(ranks, worst, smi)
            b1 = serve_b1_deep_path(C, smi, worst)
            summary["launches"].update(b1["launches"])
            summary["b1_deep"] = b1.get("report")
    b1 = serve_b1_path(C, smi)
    summary["launches"].update(b1["launches"])
    summary["b1"] = b1["runs"]
    vlm = serve_vlm_path(C, smi)
    summary["launches"].update(vlm["launches"])
    summary["vlm"] = vlm["runs"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "serve_phase.json"), "w") as f:
        json.dump(summary, f, default=str)
    print("serve " + json.dumps({k: v for k, v in summary.items()
                                 if k != "parity"}, default=str), flush=True)
    if cards < 4:
        print(f"serve: {cards} card(s), so no 4-rank mesh and no deep "
              "mixtral-8x22b run (not measured in this run)", flush=True)
    return summary


# ---------------------- phase 8: a batch that does not split --------------------
def serve_b1_runs():
    """(arch, layers, mesh shape, decode steps) of SERVE_B1's two runs
    (hymba's `shared_steps` where its ranks outnumber the cards)."""
    ranks = int(np.prod(list(SERVE_B1["mesh"].values())))
    steps = SERVE_B1["steps"] if ranks <= torch.cuda.device_count() else \
        SERVE_B1["shared_steps"]
    return ((SERVE_B1["arch"], None, SERVE_B1["mesh"], steps),
            (SERVE_B1["ssm_arch"], SERVE_B1["ssm_layers"],
             SERVE_B1["ssm_mesh"], SERVE_B1["ssm_steps"]))


def serve_b1_references(C):
    """{(arch, compute dtype): serve_one_device} of SERVE_B1's runs (its
    prompt into a cache of S + steps, through the builders), the weights
    drawn from SEED on the card."""
    from repro_torch.models.params import init_params
    refs = {}
    for arch, layers, _, steps in serve_b1_runs():
        for compute in ("bfloat16", "float32"):
            cfg = serve_cfg(C, arch, layers, compute)
            params = init_params(cfg, torch.Generator("cuda").manual_seed(
                SEED), "cuda")
            B, S = SERVE_B1["B"], SERVE_B1["S"]
            refs[(arch, compute)] = serve_one_device(
                cfg, params, 1, dict(B=B, S=S, L=S + steps, steps=steps),
                SEED + 10)
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return refs


def serve_b1_ranks(rank, world, arch, layers, shape, steps):
    """One spawned rank of SERVE_B1's run of `arch` on `shape`: the prefill
    of the one-row prompt, then each decode mode's steps from its cache
    resharded, every rank drawing the same weights (SEED) and keeping its
    shards.  Returns this rank's numbers (prefill s, peak GiB and
    collective bytes; each mode's ``decode_modes`` numbers) and launches;
    rank 0 also the outputs gathered whole, on the CPU."""
    import repro_torch.configs as C
    from repro_torch.launch import dist as D
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import ShapeSpec
    mesh = D.Mesh(shape)
    cfg = serve_cfg(C, arch, layers)
    B, S = SERVE_B1["B"], SERVE_B1["S"]
    pre_b, dec_b = serve_batches(cfg, B, S, steps, seed=SEED + 10)
    launches, stats, runs = {}, {}, {}
    gib = 2 ** 30
    pre, _ = ST.make_prefill_step(cfg, mesh, ShapeSpec("p", S, B, "prefill"),
                                  cache_len=S + steps)
    params = rank_weights(cfg, mesh, pre.param_pspecs)
    torch.cuda.reset_peak_memory_stats()
    mesh.bytes.clear()
    (logits, cache0), took = timed_counted(lambda: pre(params, pre_b),
                                           launches)
    stats["prefill"] = dict(s=took, collective_bytes=dict(mesh.bytes),
                            peak_gib=torch.cuda.max_memory_allocated() / gib)
    runs[(arch, "prefill", "default")] = (
        mesh.full(logits, pre.logits_pspec).cpu(),
        _cpu(MS.gather_tree(mesh, cache0, pre.cache_pspecs)))
    del params, logits
    dec, dstats = decode_modes(cfg, mesh, pre, cache0, dec_b,
                               SERVE_B1["modes"], ShapeSpec(
                                   "d", S + steps, B, "decode"), launches)
    stats.update(dstats)
    runs.update({(arch, "decode", k): v for k, v in dec.items()})
    return {"stats": stats, "launches": launches,
            "runs": runs if rank == 0 else None,
            "device": torch.cuda.get_device_name()}


def serve_b1_errors(got, one, ref32):
    """serve_errors of a run's prefill and final cache, and each decode
    step's logits: {tensor: (mesh error, one-device bf16 error)} against
    float32, and whether the positions agree."""
    errs, exact = serve_errors(got, one, ref32)
    if got[0].dim() == 4:      # stacked decode logits: one entry a step
        del errs["logits"]
        for i in range(got[0].shape[0]):
            errs[f"logits step {i}"] = (_rel(got[0][i], ref32[0][i]),
                                        _rel(one[0][i], ref32[0][i]))
    return errs, exact


def serve_b1_path(C, smi):
    """Phase 8's batch that does not split over the data axes (SERVE_B1):
    the one-device references in bf16 and float32, then each run's ranks
    (sharing card 0 over gloo where the cards are fewer than its ranks,
    else one a card over NCCL), every step within SERVE_TOL of the
    one-device step; per rank the prefill's seconds, decode ms a token,
    peak GiB and collective bytes a step.  Returns {"launches":
    {"serve_b1": rank 0's launches of the mesh steps}, "runs": ...}."""
    from repro_torch.launch import dist as D
    cards = torch.cuda.device_count()
    stamp("serve_b1: the one-device references (bf16, float32)")
    refs = serve_b1_references(C)
    launches, summary = {}, {}
    for arch, layers, shape, steps in serve_b1_runs():
        world = int(np.prod(list(shape.values())))
        backend = None if world <= cards else "gloo"
        stamp(f"serve_b1: {arch} ({layers or 'all'} layers) B "
              f"{SERVE_B1['B']} x {SERVE_B1['S']}, {steps} decode steps a "
              f"mode, on {shape}, {world} ranks"
              + (" sharing card 0 (gloo)" if backend else " (NCCL)"))
        gc.collect()
        torch.cuda.empty_cache()
        ranks = D.run_ranks(serve_b1_ranks, world, arch, layers, shape,
                            steps, timeout_s=900, backend=backend,
                            workdir=os.path.join(ROOT, "build"))
        for k, n in ranks[0]["launches"].items():
            launches[k] = launches.get(k, 0) + n
        for r, got in enumerate(ranks):
            print(f"serve_b1 {arch} rank {r} ({got['device']}): " + "; ".join(
                f"{k} " + ", ".join(
                    f"{n} {round(v, 4) if isinstance(v, float) else v}"
                    for n, v in st.items())
                for k, st in got["stats"].items()) + f" [{smi}]",
                flush=True)
        parity, worst = parity_report(C, "serve_b1", ranks[0]["runs"], {
            (arch, kind): tuple(refs[(arch, c)][kind]
                                for c in ("bfloat16", "float32"))
            for kind in ("prefill", "decode")}, smi)
        summary.update(parity)
        print(f"serve_b1 {arch}: every step within {worst:.3f} of the bound",
              flush=True)
    print(f"serve_b1: rank 0's launches of the mesh steps: {launches}",
          flush=True)
    return {"launches": {"serve_b1": launches}, "runs": summary}


def serve_b1_deep_ranks(rank, world):
    """One NCCL rank (a card each) of SERVE_B1_DEEP's run on (2, 2)."""
    import repro_torch.configs as C
    from repro_torch.launch import dist as D
    launches = {}
    out = serve_deep(C, D.Mesh({"data": 2, "model": 2}), rank, launches,
                     SERVE_B1_DEEP)
    return {"b1_deep": out, "b1_deep_launches": launches}


def serve_b1_deep_path(C, smi, worst=float("inf")):
    """SERVE_B1_DEEP on four cards, spawned after the B 4 deep run (or
    alone, ``--only serve_b1_deep``): the modes' logits against hd's within
    `worst` (the 2-layer parity's worst error) times the depth ratio, and
    SERVE_DEEP_CAP at most; "launches": {"serve_b1_deep": rank 0's}.
    With fewer cards, not run."""
    from repro_torch.launch import dist as D
    if torch.cuda.device_count() < 4:
        print("serve_b1_deep: fewer than 4 cards (not measured in this run)",
              flush=True)
        return {"launches": {}}
    stamp(f"serve_b1_deep: {SERVE_B1_DEEP['arch']} B 1 x "
          f"{SERVE_B1_DEEP['S']} on (2, 2), 4 NCCL ranks")
    ranks = D.run_ranks(serve_b1_deep_ranks, 4, timeout_s=2400,
                        workdir=os.path.join(ROOT, "build"))
    report = serve_deep_report(ranks, worst, smi, SERVE_B1_DEEP, "b1_deep")
    return {"launches": {"serve_b1_deep": ranks[0]["b1_deep_launches"]},
            "report": report}


def serve_deep_report(ranks, worst, smi, spec=SERVE_DEEP, key="deep"):
    """Print and check the deep run of every rank: finite logits, the
    modes' logits against hd's within the 2-layer parity's worst error
    times the depth ratio (SERVE_DEEP_CAP at most), hd's and lc's greedy
    tokens compared (each difference with hd's logit gap between the two
    tokens)."""
    deep = [r[key] for r in ranks]
    d0 = deep[0]
    depth = d0["depth"]
    limit = min(SERVE_DEEP_CAP, worst * depth / SERVE_LAYERS)
    B, S = spec["B"], spec["S"]
    print(f"serve {key} {d0['arch']} at {depth} layers (the deepest that "
          f"fits: {d0['figures']}), mesh (2, 2), B {B} x {S} banded prefill: "
          f"prefill s by rank {[round(d['prefill']['s'], 3) for d in deep]}"
          f", prefill tokens/s {B * S / d0['prefill']['s']:.0f}, peak GiB by "
          f"rank {[round(d['prefill']['peak_bytes'] / 2**30, 2) for d in deep]}"
          f", state GiB by rank "
          f"{[round(d['prefill']['state_bytes'] / 2**30, 2) for d in deep]}, "
          f"collective bytes (rank 0) {d0['prefill']['collective_bytes']}, "
          f"init s {[round(d['init_s'], 1) for d in deep]} [{smi}]",
          flush=True)
    if not all(d["prefill"]["finite"] for d in deep):
        fail("serve deep: the prefill's logits are not finite")
    report = {"arch": d0["arch"], "depth": depth, "figures": d0["figures"],
              "prefill_s": [d["prefill"]["s"] for d in deep],
              "limit": limit, "modes": {}}
    hd = [d["modes"]["hd"] for d in deep]

    def whole(rows):
        """The ranks' logit shards (steps, B / data, 1, Vp / model) as the
        whole (steps, B, Vp): rank r is (data r // model, model r % model);
        rows that do not split over `data` are every data rank's."""
        m = d0["mesh"]["model"]
        n = len(rows) // m if d0["rows_split"] else 1
        return torch.cat([torch.cat([rows[d * m + j]["logits"]
                                     for j in range(m)], -1)
                          for d in range(n)], 1)[:, :, 0]
    hd_full = whole(hd)
    for mode in spec["modes"]:
        rows = [d["modes"][mode] for d in deep]
        err = math.sqrt(sum((r["logits"] - h["logits"]).double().square()
                            .sum().item() for r, h in zip(rows, hd))
                        / max(sum(h["logits"].double().square().sum().item()
                                  for h in hd), 1e-300))
        finite = all(torch.isfinite(r["logits"]).all() for r in rows)
        ms = [1e3 * float(np.mean(r["step_s"][1:])) for r in rows]
        diffs = []
        if mode != "hd":
            # each differing token with the logit gap between the two
            # choices, in hd's logits and in this mode's
            g, gh = rows[0]["greedy"], hd[0]["greedy"]
            mine = whole(rows)
            for i, j in zip(*np.nonzero(g != gh)):
                a, b = int(gh[i, j]), int(g[i, j])
                diffs.append((int(i), int(j), a, b, round(float(
                    hd_full[i, j, a] - hd_full[i, j, b]), 4), round(float(
                        mine[i, j, b] - mine[i, j, a]), 4)))
        report["modes"][mode] = dict(
            vs_hd=err, finite=finite, decode_ms=ms,
            tokens_per_s=[B / (m / 1e3) for m in ms],
            idle_share=[r["idle_share"] for r in rows],
            peak_gib=[r["peak_bytes"] / 2**30 for r in rows],
            state_gib=[r["state_bytes"] / 2**30 for r in rows],
            collective_bytes=rows[0]["collective_bytes"],
            greedy_differs=diffs)
        print(f"serve {key} {mode}: {spec['steps']} steps, logits vs "
              f"hd {err:.5f} (limit {limit:.5f}), decode ms a token by rank "
              f"{[round(x, 3) for x in ms]}, tokens/s by rank "
              f"{[round(B / (x / 1e3), 1) for x in ms]}, idle share by rank "
              f"{[round(r['idle_share'], 3) for r in rows]}, peak GiB by "
              f"rank {[round(r['peak_bytes'] / 2**30, 2) for r in rows]}, "
              f"state GiB by rank "
              f"{[round(r['state_bytes'] / 2**30, 2) for r in rows]}, "
              f"collective bytes a step (rank 0) "
              f"{rows[0]['collective_bytes']}, GB by rank "
              f"{[round(sum(r['collective_bytes'].values()) / 1e9, 3) for r in rows]}"
              f"; greedy tokens that differ "
              f"from hd's (step, row, hd token, this token, hd's logit gap "
              f"between them, this mode's): {diffs} [{smi}]", flush=True)
        if not finite or err > limit:
            fail(f"serve {key} {mode}: logits vs hd {err} (limit {limit})")
    if not spec["seq_parallel"]:
        return report
    sp = [d["seq_parallel"] for d in deep]
    report["seq_parallel"] = {k: v for k, v in sp[0].items()}
    print(f"serve deep seq_parallel prefill: {sp[0]['arch']} at "
          f"{sp[0]['layers']} layers (mixtral under ZeRO-3: "
          f"{sp[0]['mixtral_figures']}: {sp[0]['mixtral_depth_that_fits']} "
          f"layers fit), B {B} x {S}: s by rank "
          f"{[round(x['s'], 3) for x in sp]}, peak GiB by rank "
          f"{[round(x['peak_bytes'] / 2**30, 2) for x in sp]}, state GiB "
          f"by rank {[round(x['state_bytes'] / 2**30, 2) for x in sp]}, "
          f"collective bytes (rank 0) {sp[0]['collective_bytes']} [{smi}]",
          flush=True)
    if not all(x["finite"] for x in sp):
        fail("serve deep: the sequence-parallel prefill's logits are not "
             "finite")
    return report


# ----------------------- phase 8: the VLM and the encoder ----------------------
#: the VLM and the encoder through the step builders at full width and depth
#: in bf16, random weights from SEED.  paligemma-3b (18 layers, d_model
#: 2048, 8 heads on 1 kv head of 256, d_ff 16384, vocab 257280, 256 image
#: embeddings): B rows of S joined positions (the image prefix and S - 256
#: text tokens) into a cache of S + steps slots.  S is the gemma backbone's
#: context; JAX's prefill_32k cell (B 32 x 32768, models/config.py:228) is
#: cut to it for the run's time and for ranks that share one card over
#: gloo.  Each prefill variant of VLM_PREFILL, then `steps` greedy decode
#: steps in each mode of VLM_MODES from the default prefill's cache: every
#: run is fed the tokens that the one-device bf16 step chose greedily, so
#: all see the same inputs.  hubert-xlarge (48 layers, d_model 1280, 16
#: heads of 80, bidirectional): enc_B x enc_S frames (41 s of 16 kHz audio
#: at 50 frames a second), the same prefill variants (it has no decode).
#: On the 1 x 1 mesh (NCCL, this process) each step is equal to the bit to
#: the one-device builders'; spawned ranks with `model` ranks a data row
#: (two sharing card 0 over gloo on (1, model) with fewer than 4 cards,
#: where a collective costs ~3-5 ms, `shared_steps` steps a mode; four NCCL
#: ranks on (2, model) with four cards, `steps` a mode) hold each step
#: against the one-device step by SERVE_TOL's rule.
SERVE_VLM = dict(arch=VLM_ARCH, B=2, S=8192, steps=32, model=2,
                 shared_steps=8, enc_arch=ENC_ARCH, enc_B=4, enc_S=2048)
VLM_PREFILL = {"default": {}, "no_fsdp": dict(fsdp=False),
               "seq_parallel": dict(seq_parallel=True)}
VLM_MODES = ("hd", "lc_per_row", "kv", "resident")


def vlm_batches(cfg, B, S, seed=SEED + 11):
    """A prefill batch of `cfg` (numpy): the VLM's image embeddings and S -
    P text tokens at positions 0.. (the forward shifts them by P), or the
    encoder's S frame embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32), "positions": np.tile(np.arange(S, dtype=np.int32),
                                              (B, 1))}
    P = cfg.num_prefix_tokens
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S - P)).astype(
                np.int32),
            "prefix_embeds": rng.standard_normal((B, P, cfg.d_model)).astype(
                np.float32),
            "positions": np.tile(np.arange(S - P, dtype=np.int32), (B, 1))}


def vlm_decode_batch(tokens, pos):
    """Decode step `tokens` (B,) at joined position `pos`."""
    return {"tokens": np.asarray(tokens, np.int32)[:, None],
            "positions": np.full((len(tokens), 1), pos, np.int32)}


def _greedy(cfg, logits) -> np.ndarray:
    """The greedy token of each row of (B, Vp) logits, over the vocab."""
    return logits[..., :cfg.vocab_size].float().argmax(-1).cpu().numpy()


def vlm_references(C):
    """The one-device steps of SERVE_VLM through the builders, in bf16 and
    float32, weights drawn from SEED on the card: {(arch, compute):
    {"prefill": (logits, cache), "decode": (stacked logits, {steps run:
    the cache after them})}} on the CPU (the encoder's cache {}), and the
    fed tokens (steps, B): the bf16 VLM step's greedy choices."""
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import init_params
    B, S, steps = (SERVE_VLM[k] for k in ("B", "S", "steps"))
    L = S + steps
    keep = {SERVE_VLM["shared_steps"], steps}
    refs, fed = {}, None
    for compute in ("bfloat16", "float32"):
        cfg = serve_cfg(C, VLM_ARCH, None, compute)
        params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                             "cuda")
        pre, _ = ST.make_prefill_step(cfg, None, ShapeSpec("p", S, B,
                                                           "prefill"),
                                      cache_len=L)
        dec, _ = ST.make_decode_step(cfg, None, ShapeSpec("d", L, B,
                                                          "decode"))
        logits, cache = pre(params, vlm_batches(cfg, B, S))
        out = {"prefill": (logits.cpu(), _cpu(cache))}
        toks = fed if fed is not None else [_greedy(cfg, logits)]
        ls, caches = [], {}
        for i in range(steps):
            lg, cache = dec(params, vlm_decode_batch(toks[i], S + i), cache)
            ls.append(lg.cpu())
            if fed is None and i + 1 < steps:
                toks.append(_greedy(cfg, lg[:, 0]))
            if i + 1 in keep:
                caches[i + 1] = _cpu(cache)
        fed = toks if fed is None else fed
        out["decode"] = (torch.stack(ls), caches)
        refs[(VLM_ARCH, compute)] = out
        del params, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
    eB, eS = SERVE_VLM["enc_B"], SERVE_VLM["enc_S"]
    for compute in ("bfloat16", "float32"):
        cfg = serve_cfg(C, ENC_ARCH, None, compute)
        params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                             "cuda")
        pre, _ = ST.make_prefill_step(cfg, None, ShapeSpec("p", eS, eB,
                                                           "prefill"))
        logits, _ = pre(params, vlm_batches(cfg, eB, eS))
        refs[(ENC_ARCH, compute)] = {"prefill": (logits.cpu(), {})}
        del params, logits
        gc.collect()
        torch.cuda.empty_cache()
    return refs, np.stack(fed)


def vlm_mesh_runs(C, mesh, fed, launches):
    """SERVE_VLM's runs on `mesh`, each rank drawing the same weights (SEED)
    and keeping its shards of each variant's layout: the VLM's prefill
    variants, then from the default prefill's cache len(fed) decode steps
    in each mode fed `fed`'s tokens, then the encoder's prefill variants.
    Returns ({(arch, kind, variant): (logits, cache)} gathered whole on the
    CPU, {(kind, arch, variant): this rank's numbers}): prefill s, decode
    ms a token (the mean of the steps after the first), peak and state GiB
    (the rank's weights and cache), collective bytes of a prefill or a
    decode step.  The mesh steps' launches go into `launches`."""
    from repro_torch.launch import mesh as MS
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import ShapeSpec
    B, S, steps = SERVE_VLM["B"], SERVE_VLM["S"], len(fed)
    L = S + SERVE_VLM["steps"]
    gib = 2 ** 30
    out, stats = {}, {}

    def prefills(cfg, b, s, cache_len):
        pb = vlm_batches(cfg, b, s)
        for k, kw in VLM_PREFILL.items():
            step, _ = ST.make_prefill_step(cfg, mesh, ShapeSpec(
                "p", s, b, "prefill"), cache_len=cache_len, **kw)
            params = rank_weights(cfg, mesh, step.param_pspecs)
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            mesh.bytes.clear()
            (logits, cache), took = timed_counted(lambda: step(params, pb),
                                                  launches)
            stats[("prefill", cfg.name, k)] = dict(
                s=took, peak_gib=torch.cuda.max_memory_allocated() / gib,
                state_gib=(_tree_bytes(params) + _tree_bytes(cache)) / gib,
                collective_bytes=dict(mesh.bytes))
            out[(cfg.name, "prefill", k)] = (
                mesh.full(logits, step.logits_pspec).cpu(),
                {} if cache is None else
                _cpu(MS.gather_tree(mesh, cache, step.cache_pspecs)))
            del params, logits
            yield k, step, cache
            del cache
            gc.collect()
            torch.cuda.empty_cache()

    cfg = serve_cfg(C, VLM_ARCH, None)
    for k, pre, cache in prefills(cfg, B, S, L):
        if k == "default":          # the decode modes start from its cache
            pre0, cache0 = pre, cache
    dec, dstats = decode_modes(
        cfg, mesh, pre0, cache0, [vlm_decode_batch(fed[i], S + i)
                                  for i in range(steps)],
        VLM_MODES, ShapeSpec("d", L, B, "decode"), launches)
    out.update({(cfg.name, "decode", k): v for k, v in dec.items()})
    stats.update({("decode", cfg.name, k): v for k, v in dstats.items()})
    del cache0
    for _ in prefills(serve_cfg(C, ENC_ARCH, None), SERVE_VLM["enc_B"],
                      SERVE_VLM["enc_S"], None):
        pass
    return out, stats


def _vlm_stats_line(stats) -> str:
    return "; ".join(
        f"{kind} {arch} {k}: " + ", ".join(
            f"{n} {round(v, 4) if isinstance(v, float) else v}"
            for n, v in st.items())
        for (kind, arch, k), st in stats.items())


def vlm_one_by_one(C, smi, refs, fed, launches):
    """World size 1 (NCCL over a FileStore in this process), a 1 x 1 mesh:
    every SERVE_VLM run equal to the bit to the one-device builders' step
    (the decode steps and cache after all of them), moving no collective
    byte.  Returns this rank's numbers."""
    import shutil
    import torch.distributed as dist
    from repro_torch.launch import dist as D
    work = os.path.join(ROOT, "build", "chip_smoke_serve_vlm")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    D.init_world(0, 1, os.path.join(work, "store"))
    try:
        mesh = D.Mesh({"data": 1, "model": 1})
        got, stats = vlm_mesh_runs(C, mesh, fed, launches)
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    steps = SERVE_VLM["steps"]
    for (arch, kind, k), (g0, g1) in got.items():
        w0, w1 = refs[(arch, "bfloat16")][kind]
        if kind == "decode":
            w1 = w1[steps]
        same = torch.equal(g0, w0) and all(
            torch.equal(torch.as_tensor(g1[n]), torch.as_tensor(v))
            for n, v in w1.items())
        moved = sum(stats[(kind, arch, k)]["collective_bytes"].values())
        if not same or moved:
            fail(f"serve_vlm: the 1 x 1 mesh {kind} {k} of {arch} differs "
                 "from the one-device step")
    print(f"serve_vlm 1 x 1 mesh ({VLM_ARCH} B {SERVE_VLM['B']} x "
          f"{SERVE_VLM['S']}, {steps} greedy decode steps a mode; "
          f"{ENC_ARCH} B {SERVE_VLM['enc_B']} x {SERVE_VLM['enc_S']}; full "
          f"width and depth, bf16): every run ({sorted(got)}) equal to the "
          f"bit to the one-device builders [{smi}]", flush=True)
    print(f"serve_vlm 1 x 1 numbers: {_vlm_stats_line(stats)} [{smi}]",
          flush=True)
    return stats


def vlm_ranks(rank, world, shape, fed):
    """One spawned rank of SERVE_VLM's mesh runs on `shape`: this rank's
    numbers and launches; rank 0 also the outputs gathered whole, on the
    CPU."""
    import repro_torch.configs as C
    from repro_torch.launch import dist as D
    launches = {}
    got, stats = vlm_mesh_runs(C, D.Mesh(shape), fed, launches)
    return {"stats": stats, "launches": launches,
            "runs": got if rank == 0 else None,
            "device": torch.cuda.get_device_name()}


def serve_vlm_path(C, smi):
    """Phase 8's VLM and encoder (SERVE_VLM): the one-device references in
    bf16 and float32, the 1 x 1 mesh equal to the bit to them, then the
    spawned ranks (two sharing card 0 over gloo on (1, model) with fewer
    than four cards, else four NCCL ranks on (2, model)), every step within
    SERVE_TOL of the one-device step; each greedy token of a rank's decode
    that differs from the one-device bf16 step's is printed with the
    one-device logit gap between the two.  Returns {"launches":
    {"serve_vlm": the 1 x 1 mesh's and rank 0's launches of the mesh
    steps}, "runs": ...}."""
    from repro_torch.launch import dist as D
    stamp("serve_vlm: the one-device references (bf16, float32)")
    refs, fed = vlm_references(C)
    launches = {}
    stamp("serve_vlm: the 1 x 1 mesh")
    one = vlm_one_by_one(C, smi, refs, fed, launches)
    cards = torch.cuda.device_count()
    m = SERVE_VLM["model"]
    if cards >= 2 * m:
        shape, backend, steps = {"data": 2, "model": m}, None, \
            SERVE_VLM["steps"]
    else:
        shape, backend, steps = {"data": 1, "model": m}, "gloo", \
            SERVE_VLM["shared_steps"]
    world = shape["data"] * shape["model"]
    stamp(f"serve_vlm: {world} ranks on {shape}"
          + (" sharing card 0 (gloo)" if backend else " (NCCL)")
          + f", {steps} decode steps a mode")
    gc.collect()
    torch.cuda.empty_cache()
    ranks = D.run_ranks(vlm_ranks, world, shape, fed[:steps], timeout_s=1200,
                        backend=backend, workdir=os.path.join(ROOT, "build"))
    for r, got in enumerate(ranks):
        print(f"serve_vlm rank {r} ({got['device']}): "
              f"{_vlm_stats_line(got['stats'])} [{smi}]", flush=True)
    for k, n in ranks[0]["launches"].items():
        launches[k] = launches.get(k, 0) + n
    summary = {"mesh": shape, "steps": steps, "one_by_one": {
        " ".join(k): v for k, v in one.items()},
        "ranks": [{" ".join(k): v for k, v in got["stats"].items()}
                  for got in ranks]}
    summary["parity"], worst = parity_report(
        C, "serve_vlm", ranks[0]["runs"], {
            (arch, kind): tuple((r[0][:steps], r[1][steps])
                                if kind == "decode" else r
                                for r in (refs[(arch, "bfloat16")][kind],
                                          refs[(arch, "float32")][kind]))
            for arch, kind, _ in ranks[0]["runs"]}, smi, f" on {shape}")
    print(f"serve_vlm: every rank step within {worst:.3f} of the bound; the "
          f"launches of the 1 x 1 mesh steps and rank 0's: {launches}",
          flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "serve_vlm_phase.json"),
              "w") as f:
        json.dump(summary, f, default=str)
    return {"launches": {"serve_vlm": launches}, "runs": summary}


def frontdoor_path(smi):
    """The HTTP front door (``repro_torch.frontdoor``) on localhost over
    repro_torch's IPDB with ``PATH 'torch:olmo-1b'`` at its published
    config (``'config': 'full'``, random weights) and the dense SQL path's
    settings (max_len 512, 8 slots, 64 new tokens, its prompt): 2 tenants
    x 3 concurrent sessions of FRONTDOOR["rows"] rows each through
    FrontDoorClient, and one more session over FRONTDOOR["long"] rows
    cancelled by DELETE /query/<id> after its first chunk.  Every stream
    must end with its ExecStats trailer, each session return its table's
    rows, every value parse under the grammar (a string of at most
    max_str characters), and the cancelled session dispatch at most one
    batch after the DELETE (the flush in flight).  The engine runs on the
    inference service's worker thread."""
    import repro_torch.core.database as D
    from repro_torch.frontdoor import FrontDoor, FrontDoorClient
    from repro_torch.relational.table import Table
    kinds = ("bolt", "nut", "gear", "washer")
    db = D.IPDB()
    tables = {}
    for tenant in FRONTDOOR["tenants"]:
        for i in range(FRONTDOOR["sessions"]):
            name = f"S_{tenant}_{i}"
            db.register_table(name, Table.from_rows(
                [{"name": f"{tenant} {i} item {j:02d}", "kind": kinds[j % 4]}
                 for j in range(FRONTDOOR["rows"])]))
            tables[(tenant, i)] = name
    db.register_table("Long", Table.from_rows(
        [{"name": f"long item {j:02d}", "kind": kinds[j % 4]}
         for j in range(FRONTDOOR["long"])]))
    db.sql("CREATE LLM MODEL m PATH 'torch:olmo-1b' ON PROMPT OPTIONS { "
           "'config': 'full', 'batch_size': 1, 'num_slots': 8, "
           "'max_tokens': 64, 'max_str': 8 }")
    db.set_option("chunk_size", FRONTDOOR["chunk"])
    prompt = ("the most likely colour {color VARCHAR} of the {{kind}} named "
              "{{name}}")

    def sql(table):
        return f"SELECT name, LLM m (PROMPT '{prompt}') AS color FROM {table}"
    results, errors = {}, []
    with db, FrontDoor(db, host="127.0.0.1", max_sessions=8,
                       max_queued=8) as fd:
        svc = db.inference_service
        cli = FrontDoorClient(fd.host, fd.port, timeout=600)

        def run(key, tenant, table):
            t = time.time()
            try:
                frames = list(cli.query(sql(table), tenant=tenant).frames())
                results[key] = (frames, time.time() - t)
            except Exception as e:       # reported below, after the joins
                errors.append(f"{key}: {type(e).__name__}: {e}")
        t0 = time.time()
        victim = cli.query(sql("Long"), tenant=FRONTDOOR["tenants"][1])
        threads = [threading.Thread(target=run, args=(key, key[0], table))
                   for key, table in tables.items()]
        for th in threads:
            th.start()
        frames = victim.frames()
        cancelled = [next(frames)]
        at_delete = svc.session_stats(victim.session_id).dispatch_batches
        fired = cli.cancel(victim.session_id)
        cancelled += list(frames)
        for th in threads:
            th.join(timeout=900)
        wall = time.time() - t0
        pending = svc.session_pending(victim.session_id)
        server = cli.server_stats()
    if errors or len(results) != len(tables):
        fail(f"front door: sessions failed: {errors}")
    prefill = decode = 0
    for key, (frames, lat) in sorted(results.items()):
        trailer = frames[-1]
        colors = [r["color"] for f in frames if f["type"] == "chunk"
                  for r in f["rows"]]
        if not (trailer["type"] == "trailer" and trailer["status"] == "ok"
                and trailer["rows"] == FRONTDOOR["rows"] == len(colors)
                and all(isinstance(c, str) and len(c) <= 8 for c in colors)):
            fail(f"front door session {key}: {trailer}, values {colors}")
        prefill += trailer["stats"]["prefill_tokens"]
        decode += trailer["stats"]["decode_tokens"]
        print(f"frontdoor session {key[0]}/{key[1]}: {len(colors)} rows "
              f"parsed in {lat:.3f} s, dispatch_batches "
              f"{trailer['stats']['dispatch_batches']}, prefill_tokens "
              f"{trailer['stats']['prefill_tokens']}, decode_tokens "
              f"{trailer['stats']['decode_tokens']}; answers "
              f"{colors[:3]}", flush=True)
    trailer = cancelled[-1]
    rows = sum(len(f["rows"]) for f in cancelled if f["type"] == "chunk")
    print(f"frontdoor cancelled session: DELETE {'fired' if fired else 'MISSED'}"
          f" after its first chunk, {rows} of {FRONTDOOR['long']} rows, "
          f"status {trailer.get('status')}, dispatch_batches "
          f"{trailer.get('stats', {}).get('dispatch_batches')} against "
          f"{at_delete} done at the DELETE, {pending} requests left queued",
          flush=True)
    if not (fired and trailer.get("status") == "cancelled"
            and rows < FRONTDOOR["long"] and pending == 0
            and trailer["stats"]["dispatch_batches"] <= at_delete + 1):
        fail("front door: the cancelled session did not stop within one "
             "flush")
    lats = sorted(lat for _, lat in results.values())
    print(f"frontdoor: {len(results)} sessions of {FRONTDOOR['rows']} rows "
          f"over {len(FRONTDOOR['tenants'])} tenants + 1 cancelled, wall_s "
          f"{wall:.3f}, prefill_tokens {prefill}, decode_tokens {decode}, "
          f"session latencies s {[round(x, 3) for x in lats]}; server "
          f"{server} [{smi}]", flush=True)


# ------------------------------------ main -------------------------------------
def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", metavar="KERNEL[,KERNEL]",
                    help="run phases 1-2 for these kernels only and print "
                    "their JSON line (no SQL paths, no last 'ok' line)")
    ap.add_argument("--compare-bwd", metavar="PARENT_CSRC",
                    help="also build the parent's training-path sources "
                    "from its kernels/csrc directory (or a .cu file in it): "
                    + ", ".join(PARENT_SOURCES) + ", each beside its "
                    "common.cuh; time them in turns with this build at the "
                    "training shapes (and kernels 6 and 7 at their serving "
                    "shapes), and in warm train steps of the configs whose "
                    "backward kernels were checked")
    ap.add_argument("--parent-alias", metavar="ENTRY=SYMBOL[,...]",
                    default="",
                    help="with --compare-bwd: the parent's C function for an "
                    "ops entry point it exports under another name (e.g. "
                    "selective_scan_train_chunks=repro_selective_scan_chunks "
                    "for a parent whose training forward wrote carries at "
                    "its serving chunk count)")
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
    smi = smi.splitlines()[0]      # the label of every number: card 0
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
        build_parent_bwd(ops, os.path.abspath(args.compare_bwd), dict(
            kv.split("=", 1) for kv in args.parent_alias.split(",") if kv))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("comparisons: torch.backends.cuda.matmul.allow_tf32 = False, "
          "cudnn.allow_tf32 = False", flush=True)
    gen = torch.Generator("cuda").manual_seed(SEED)
    shapes = {a: path_shapes(C.get_config(a))
              for a in ALL + tuple(TRAIN) + SERVE_KERNEL_ARCHS}
    shapes.update(b1_rank_shapes(C))
    shapes.update(vlm_serve_shapes(C))
    stamp("phase 2: the kernels")
    report = {}
    for kname, replaces, check, path_dtype, src, path, archs in KERNELS:
        if only and kname not in only.split(","):
            continue
        for arch in archs:
            for dtype in (torch.bfloat16, torch.float32):
                r = check(ops, ref, dtype, gen, shapes[arch][kname])
                tol = 0.0 if kname == "constrained_sample" else \
                    TOL[dtype] * r.get("tolerance_scale", 1.0)
                # and each output vector within TOL of its own size
                rel = r.get("max_rel_err")
                ok = r["max_abs_err"] <= tol and (rel is None
                                                  or rel <= TOL[dtype])
                lib = "none" if r["library_ms"] is None else \
                    f"{r['library_ms']:.4f}"
                dev = "" if "device_ms" not in r else \
                    f" (device_ms {fmt_ms(r['device_ms'])})"
                if "splits" in r:
                    dev += f" splits {r['splits']} warps {r['warps']}"
                if "stages" in r:
                    dev += f" stages {r['stages']}"
                # a reckoning from the shape, printed beside the bound:
                # not a measurement, so not in the kernels line
                sfu = r.pop("sfu_floor_ms", None)
                sfu = "" if sfu is None else f" (SFU floor {sfu:.5f})"
                drop = r.pop("dropped_tile_err", None)
                rel = "" if rel is None else \
                    f" max_rel_err {rel} (tolerance {TOL[dtype]}" + (
                        "" if drop is None else
                        f"; a dropped 64-key tile: {drop}") + ")"
                print(f"kernel {kname} {str(dtype)[6:]} at {arch}'s shapes: "
                      f"max_abs_err {r['max_abs_err']} (tolerance {tol})"
                      f"{rel} ms "
                      f"{r['ms']:.4f}{dev} plain_ms {r['plain_ms']:.4f} "
                      f"library_ms {lib} bound_ms {r['bound_ms']:.5f} "
                      f"({r['bound_by']}){sfu}", flush=True)
                if not ok:
                    fail(f"{kname} {dtype} at {arch}'s shapes: kernel "
                         f"disagrees with its plain version")
                if drop is not None and not drop > TOL[dtype]:
                    fail(f"{kname} {dtype} at {arch}'s shapes: the check "
                         f"would pass a kernel that skips a tile ({drop})")
                if dtype != path_dtype:
                    continue
                if arch == archs[0]:
                    report[kname] = dict(
                        name=kname, route="cuda",
                        source=f"src/repro_torch/kernels/csrc/{src}",
                        replaces=replaces, path=path, launches_by_path={},
                        by_config={}, **r)
                report[kname]["by_config"][arch] = {
                    k: r[k] for k in ("max_abs_err", "max_rel_err", "ms",
                                      "device_ms",
                                      "plain_ms", "library_ms", "bound_ms",
                                      "bound_by", "splits", "warps",
                                      "stages", "no_empty_row",
                                      "int8_pages", "forward", "chunks",
                                      "device_ms_by_launch", "by_shape",
                                      "forward_device_ms", "in_turns",
                                      "design", "library_device_ms")
                    if k in r}

    if args.compare_bwd:
        compare_bwd_steps(C, ops, report)
    if only and "dist" in only.split(","):
        for path, launches in dist_path(C, smi)["launches"].items():
            print(f"launches during the {path} path: {launches}", flush=True)
    if only and "serve" in only.split(","):
        stamp("phase 8: serving")
        for path, launches in serve_path(C, smi)["launches"].items():
            print(f"launches during the {path} path: {launches}", flush=True)
    elif only:
        for part, run in (("serve_b1", serve_b1_path),
                          ("serve_b1_deep", serve_b1_deep_path),
                          ("serve_vlm", serve_vlm_path)):
            if part in only.split(","):
                stamp(f"phase 8: {part}")
                for path, launches in run(C, smi)["launches"].items():
                    print(f"launches during the {path} path: {launches}",
                          flush=True)
    if only:
        print(json.dumps({"kernels": list(report.values())}), flush=True)
        return 0

    stamp("phase 3: the full-width forwards")
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

    stamp("the SQL paths")
    cfg, params, _ = build_engine_weights(C, init_params, DENSE_ARCH)

    def record(path, launches, needed, took=""):
        print(f"launches during the {path} path{took}: {launches}",
              flush=True)
        for k in needed:
            if launches[k] <= 0:
                fail(f"{k}: no launch on the {path} path")
        for k, n in launches.items():
            report[k]["launches_by_path"][path] = n

    def count(path, runs, needed):
        """Drive one main path with every launch count set to 0 just
        before it; read the counts just after."""
        ops.reset_launches()
        t = time.time()
        out = runs()
        record(path, {k: w.launches for k, w in ops.WRAPPERS.items()},
               needed, f" ({time.time() - t:.1f} s)")
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
    stamp("the paged path")
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

    # the front door over PATH 'torch:olmo-1b': concurrent HTTP sessions
    # and a cancel, the engine on the inference service's worker thread
    stamp("the front door")
    count("frontdoor", lambda: frontdoor_path(smi),
          ("flash_attention", "decode_attention", "constrained_sample"))

    # the MoE family at full width and depth: free the olmo sessions first
    del dense, paged, params
    gc.collect()
    torch.cuda.empty_cache()
    stamp("the moe path")
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
    stamp("the ssm path")
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
    stamp("the hybrid path")
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
    stamp("phase 6: training")
    for arch in TRAIN:
        check_train_full_width(C, MDL, ref, arch, 2)
        torch.cuda.empty_cache()
    stamp("the trainer in bfloat16")
    train_kernels = ("flash_attention", "flash_attention_bwd", "gmm",
                     "gmm_bwd", "selective_scan", "selective_scan_bwd")
    STEPS_RUN.clear()
    count("train", lambda: (train_path(C, smi), train_new_families(C, smi)),
          train_kernels)
    want = expected_train_launches(C)
    got = {k: report[k]["launches_by_path"]["train"] for k in want}
    print(f"train launches {got}, expected from the steps run "
          f"{dict(sorted(STEPS_RUN.items()))} under remat: {want}",
          flush=True)
    if got != want:
        fail("train: the kernels' launches are not those of the steps run "
             "under remat")
    stamp("remat: off / nothing / dots, and olmo-1b at 2048 tokens")
    count("remat", lambda: (remat_policies(C, smi), long_context(C, smi)),
          train_kernels)
    stamp("phase 7: distribution")
    for path, launches in dist_path(C, smi)["launches"].items():
        record(path, launches, train_kernels)
    stamp("phase 8: serving")
    for path, launches in serve_path(C, smi)["launches"].items():
        record(path, launches, SERVE_NEEDED[path])
    stamp("done")

    for r in report.values():
        r["launches"] = r["launches_by_path"][r["path"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print("kernels: " + ", ".join(report), flush=True)
    print(json.dumps({"kernels": [
        {k: report[n][k] for k in keys + ("device_ms", "splits", "warps",
                                          "stages", "no_empty_row",
                                          "in_turns", "int8_pages", "by_shape",
                                          "by_config")
         if k in report[n]}
        for n in report]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
