#!/usr/bin/env python3
"""Drive repro_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases, each reported on its own lines:

1. the card (``nvidia-smi`` name and power limit) and the build of the
   Hopper kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a);
2. each kernel at the shapes the SQL path gives it, in bfloat16 and float32:
   its largest error against its plain PyTorch version (tolerance stated),
   and the times of the kernel, the plain version and one PyTorch library
   call computing the same function (a yardstick only; the port never calls
   it), beside the least time the card could take (``bound_ms``: the
   bytes the function needs over the memory rate, or its operations over
   the peak rate, the larger);
3. the olmo-1b configuration at full width (16 layers, d_model 2048, vocab
   50304, random weights from a seeded generator): logits of a prefill and
   decode steps through the kernels against the plain attention, in
   float32; then, in bfloat16, two semantic SQL queries through
   ``repro_torch``'s IPDB (16 rows through the continuous batcher, one row
   through ``generate``), with every kernel's launch count read around them
   and every answer checked to parse under the grammar;
4. a JSON line with every kernel's numbers at the dtype the SQL path gives
   it, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no last
line.  Without a GPU it exits 2 at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,     # dense tensor core
              torch.float32: 67e12}       # fp32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
SEED = 0

# main-path shapes: 8 decode slots over a 512-token ring cache, olmo-1b heads
DEC = dict(B=8, L=512, H=16, KV=16, D=128)
PRE = dict(B=1, S=256, H=16, KV=16, D=128, prompt=225)   # 256-token bucket
SAMPLE = dict(B=8, V=50432, allowed=259, temperature=0.7)


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


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# ------------------------------ phase 2: kernels -------------------------------
def check_decode(ops, ref, dtype, gen):
    B, L, H, KV, D = (DEC[k] for k in ("B", "L", "H", "KV", "D"))
    dev = "cuda"
    fills = torch.randint(96, 321, (B,), generator=gen, device=dev)
    spos = torch.arange(L, device=dev, dtype=torch.int32).repeat(B, 1)
    spos[spos >= fills[:, None]] = -1
    qpos = (fills - 1).to(torch.int32)
    sets = []
    for _ in range(6):                  # 6 x 34 MB of cache: beyond the L2
        q = torch.randn(B, H, D, generator=gen, device=dev).to(dtype)
        kc = torch.randn(B, L, KV, D, generator=gen, device=dev).to(dtype)
        vc = torch.randn(B, L, KV, D, generator=gen, device=dev).to(dtype)
        sets.append((q, kc, vc, spos, qpos))
    out = ops.decode_attention(*sets[0])
    err = (out.float() - ref.decode_attention_ref(*sets[0]).float()).abs().max()
    valid = (spos >= 0).sum().item()
    s = torch.tensor([], dtype=dtype).element_size()
    nbytes = 2 * B * H * D * s + 2 * valid * KV * D * s + B * L * 4 + B * 4
    b_ms, b_by = bound(nbytes, 4 * valid * H * D, dtype)
    mask = (spos >= 0)[:, None, None, :]
    lib_sets = [(q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2))
                for q, kc, vc, _, _ in sets]

    def library(q4, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=H != KV)
    return dict(max_abs_err=err.item(),
                ms=time_ms(ops.decode_attention, sets),
                plain_ms=time_ms(ref.decode_attention_ref, sets),
                library_ms=time_ms(library, lib_sets),
                bound_ms=b_ms, bound_by=b_by)


def check_flash(ops, ref, dtype, gen):
    B, S, H, KV, D, n = (PRE[k] for k in ("B", "S", "H", "KV", "D", "prompt"))
    dev = "cuda"
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, KV, D, generator=gen, device=dev).to(dtype)
    pos = (torch.arange(S, device=dev, dtype=torch.int32) - (S - n)).repeat(B, 1)
    pos[pos < 0] = -1                   # left padding, as engine._prefill
    args = (q, k, v, pos, pos)
    out = ops.flash_attention(*args)
    valid = pos >= 0
    err = (out[valid].float()
           - ref.flash_attention_ref(*args)[valid].float()).abs().max()
    if not torch.isfinite(out.float()).all():
        fail("flash_attention: non-finite output on pad rows")
    s = q.element_size()
    pairs = n * (n + 1) // 2 * B        # causal (query, key) pairs per head
    # q/k/v rows of real tokens (pad rows are never needed), the whole
    # output, and the positions once (queries and keys share them)
    rows = int(valid.sum())
    nbytes = rows * (H + 2 * KV) * D * s + out.numel() * s + pos.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * pairs * H * D, dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = ((pos[:, None, :] <= pos[:, :, None]) & (pos[:, None, :] >= 0))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=H != KV)
    return dict(max_abs_err=err.item(),
                ms=time_ms(ops.flash_attention, [args]),
                plain_ms=time_ms(ref.flash_attention_ref, [args]),
                library_ms=time_ms(library, [()]),
                bound_ms=b_ms, bound_by=b_by)


def check_sample(ops, ref, dtype, gen):
    B, V, A, T = (SAMPLE[k] for k in ("B", "V", "allowed", "temperature"))
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
    return dict(max_abs_err=0.0,
                ms=time_ms(lambda *a: ops.constrained_sample(*a, temperature=T),
                           [args]),
                plain_ms=time_ms(lambda *a: ref.constrained_sample_ref(
                    *a, temperature=T), [args]),
                library_ms=time_ms(library, [()]),
                bound_ms=b_ms, bound_by=b_by)


# name, TPU kernel it replaces, check, and the dtype the SQL path gives it:
# bfloat16 q/k/v and caches (the compute dtype), float32 logits (the engine
# casts them before sampling).  The JSON line reports that dtype's run.
KERNELS = [
    ("flash_attention", "src/repro/kernels/flash_attention.py:89", check_flash,
     torch.bfloat16),
    ("decode_attention", "src/repro/kernels/decode_attention.py:65",
     check_decode, torch.bfloat16),
    ("constrained_sample", "src/repro/kernels/constrained_logits.py:53",
     check_sample, torch.float32),
]


# ------------------------------ phase 3: full width ----------------------------
def check_forward_full_width(C, MDL, init_params, ref):
    """olmo-1b at full width in float32: prefill of a left-padded prompt and
    three decode steps, once through the kernels and once through the plain
    attention functions, from the same weights and cache state."""
    cfg = C.get_config("olmo-1b").replace(compute_dtype="float32")
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED), "cuda")
    S, n = 256, PRE["prompt"]
    gen = torch.Generator("cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    pos = (torch.arange(S, device="cuda", dtype=torch.int32) - (S - n))[None]
    pos[pos < 0] = -1
    nxt = torch.randint(0, cfg.vocab_size, (3, 1, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    runs = []
    for fns in ({}, {"attn_fn": ref.flash_attention_ref,
                     "decode_attn_fn": ref.decode_attention_ref}):
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
    print(f"full-width forward (olmo-1b, float32, prefill {n}/{S} + 3 decode "
          f"steps): logits through the kernels vs plain attention max_abs_err="
          f"{err} (tolerance {tol}; logit std {runs[1].std().item()})",
          flush=True)
    if not err < tol:
        fail("full-width forward disagrees with the plain attention")
    del params


def sql_session(cfg, label):
    """repro_torch's IPDB on `cfg` (max_len 512, on the card), with tables
    Items (16 rows), One (1 row) and More/Extra (16 new rows each, for
    steady-state queries without prompt-cache hits).  Returns
    query(table, path, nrows), which runs the semantic SQL query over
    `table`, checks that every answer parses under the grammar (the predict
    operator's parse yields a string) and returns its wall seconds."""
    import repro_torch.core.database as D
    from repro_torch.core.executors import TorchExecutor
    from repro_torch.models.params import init_params
    from repro_torch.relational.table import Table
    from repro_torch.serving.engine import InferenceEngine

    t0 = time.time()
    params = init_params(cfg, torch.Generator("cuda").manual_seed(SEED), "cuda")
    eng = InferenceEngine(cfg, params, max_len=512, seed=SEED)
    torch.cuda.synchronize()
    print(f"engine: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
          f"vocab {cfg.vocab_size} heads {cfg.num_heads}x{cfg.head_dim} "
          f"{cfg.compute_dtype}, built in {time.time() - t0:.1f} s", flush=True)
    db = D.IPDB()
    kinds = ("bolt", "nut", "gear", "washer")
    db.register_table("Items", Table.from_rows(
        [{"name": f"item {i:02d}", "kind": kinds[i % 4]} for i in range(16)]))
    db.register_table("One", Table.from_rows([{"name": "item 99",
                                               "kind": "spring"}]))
    for table in ("More", "Extra"):
        db.register_table(table, Table.from_rows(
            [{"name": f"{table} {i:02d}", "kind": kinds[i % 4]}
             for i in range(16)]))

    def factory(entry):
        ex = TorchExecutor(eng)
        ex.configure(dict(entry.options))
        return ex

    db.register_executor("local", factory)
    db.sql("CREATE LLM MODEL m PATH 'custom:local' ON PROMPT OPTIONS "
           "{ 'batch_size': 1, 'num_slots': 8, 'max_tokens': 64, "
           "'max_str': 8 }")
    db.set_option("batch_size", 1)
    # the marshaled prompt is ~225 tokens: the 256-token prefill bucket
    prompt = "the most likely colour {color VARCHAR} of the {{kind}} named {{name}}"

    def query(table, path, nrows):
        before = eng.total.prefill_tokens, eng.total.output_tokens
        t = time.time()
        r = db.sql(f"SELECT name, LLM m (PROMPT '{prompt}') AS color "
                   f"FROM {table}")
        torch.cuda.synchronize()
        wall = time.time() - t
        colors = r.table.column("color")
        if len(colors) != nrows or not all(isinstance(c, str) for c in colors):
            fail(f"{path} query: rows did not parse under the grammar: "
                 f"{r.table.rows()}")
        pre = eng.total.prefill_tokens - before[0]
        dec = eng.total.output_tokens - before[1]
        print(f"sql {path}: {nrows} rows parsed, llm_calls "
              f"{r.stats.llm_calls}, dispatch_batches "
              f"{r.stats.dispatch_batches}, prefill_tokens {pre}, "
              f"decode_tokens {dec}, wall_s {wall:.3f}, decode tokens/s "
              f"{dec / wall:.1f} [{label}]", flush=True)
        print(f"  answers: {r.table.rows()[:3]}", flush=True)
        return wall
    return query


def profile(run_query) -> None:
    """Where the time of one batcher query goes: device busy time (the sum
    of the device-side events -- kernels and copies, one stream) against
    wall time, by category, and the kernels that take the most."""
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
        cat = next((n for n in ("flash_attention", "decode_attention",
                                "constrained_sample") if n + "_kernel" in k),
                   None)
        if cat is None:
            cat = ("memcpy/memset" if k.startswith("Mem") else
                   "gemm" if any(t in k for t in ("nvjet", "gemm", "cutlass",
                                                  "xmma")) else
                   "other kernels")
        cats[cat] = cats.get(cat, 0.0) + e.self_device_time_total / 1e3
    print("  by category (ms): " + ", ".join(
        f"{c} {t:.2f}" for c, t in sorted(cats.items(), key=lambda x: -x[1])),
        flush=True)
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:10]:
        print(f"  {e.self_device_time_total / 1e3:10.2f} ms {e.count:6d} x "
              f"{e.key[:90]}", flush=True)


# ------------------------------------ main -------------------------------------
def main() -> int:
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("comparisons: torch.backends.cuda.matmul.allow_tf32 = False, "
          "cudnn.allow_tf32 = False", flush=True)
    gen = torch.Generator("cuda").manual_seed(SEED)
    report = {}
    for kname, replaces, check, path_dtype in KERNELS:
        for dtype in (torch.bfloat16, torch.float32):
            r = check(ops, ref, dtype, gen)
            tol = 0.0 if kname == "constrained_sample" else TOL[dtype]
            ok = r["max_abs_err"] <= tol
            print(f"kernel {kname} {str(dtype)[6:]}: max_abs_err "
                  f"{r['max_abs_err']} (tolerance {tol}) ms {r['ms']:.4f} "
                  f"plain_ms {r['plain_ms']:.4f} library_ms "
                  f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
                  f"({r['bound_by']})", flush=True)
            if not ok:
                fail(f"{kname} {dtype}: kernel disagrees with its plain version")
            if dtype == path_dtype:
                report[kname] = dict(name=kname, route="cuda",
                                     source=f"src/repro_torch/kernels/csrc/"
                                            f"{kname}.cu",
                                     replaces=replaces, **r)

    check_forward_full_width(C, MDL, init_params, ref)
    torch.cuda.empty_cache()

    # the main path: two queries (batcher, generate), counted from zero
    query = sql_session(C.get_config("olmo-1b"), smi)
    ops.reset_launches()
    query("Items", "batcher", 16)
    query("One", "generate", 1)
    launches = {k: w.launches for k, w in ops.WRAPPERS.items()}
    print(f"launches during the SQL phase: {launches}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            fail(f"{k}: no launch on the main path")
        report[k]["launches"] = n

    query("More", "batcher over More (warm)", 16)
    torch.cuda.reset_peak_memory_stats()
    profile(lambda: query("Extra", "batcher over Extra (warm)", 16))
    print(f"peak device memory during the profiled query: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print("kernels: " + ", ".join(report), flush=True)
    print(json.dumps({"kernels": [{k: report[n][k] for k in keys}
                                  for n in report]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
