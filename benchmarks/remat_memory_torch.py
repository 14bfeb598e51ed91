#!/usr/bin/env python3
"""Peak device memory and step time of repro_torch's train step under each
remat setting, one configuration a process (so that one that runs out of
the card's memory leaves the next a clean card), on one NVIDIA GPU.

    python3 benchmarks/remat_memory_torch.py            # the default cases
    python3 benchmarks/remat_memory_torch.py \\
        --case olmo-1b:0:16:2048:off --case falcon-mamba-7b:34:4:512:nothing

A case is ARCH:DEPTH:BATCH:SEQ:POLICY[:STEPS] (DEPTH 0: the published
depth; POLICY off, nothing or dots): the published config at full width,
bfloat16 compute over float32 master weights and AdamW state, random
weights from seed 0, the synthetic batches of ``training.data``, and
``launch.steps.make_train_step`` at ``launch.train``'s schedule (peak lr
3e-3 after 20 warm-up steps).  Each case prints one JSON line: the
losses, the step times (host clock between device synchronisations; the
first step left out of the median), the peak of
``torch.cuda.max_memory_allocated``, the bytes of the train state, and
``"oom": true`` where the card ran out.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_CASES = [
    # the predictions of PERF.md (olmo-1b at the trainer's B 8 x 512, and
    # at its published 2048-token context)
    "olmo-1b:0:8:512:off:6", "olmo-1b:0:8:512:nothing:6",
    "olmo-1b:0:8:512:dots:6",
    "olmo-1b:0:16:2048:off:4", "olmo-1b:0:16:2048:nothing:4",
    "olmo-1b:0:16:2048:dots:4",
    # the deepest cut of the two configs whose optimizer state caps them
    "qwen3-moe-30b-a3b:5:8:512:nothing:3",
    "qwen3-moe-30b-a3b:6:8:512:nothing:3",
    "falcon-mamba-7b:32:4:512:nothing:3",
    "falcon-mamba-7b:34:4:512:nothing:3",
    "falcon-mamba-7b:36:4:512:nothing:3",
]


def run_one(spec: str) -> dict:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.launch import steps as ST
    from repro_torch.models.config import ShapeSpec
    from repro_torch.training import optim as OPT
    from repro_torch.training.data import DataConfig, synthetic_batch

    arch, depth, B, S, policy, *rest = spec.split(":")
    depth, B, S = int(depth), int(B), int(S)
    steps = int(rest[0]) if rest else 4
    cfg = C.get_config(arch)
    if depth:
        cfg = cfg.replace(num_layers=depth)
    out = dict(case=spec, arch=arch, layers=cfg.num_layers, batch=B, seq=S,
               policy=policy, device=torch.cuda.get_device_name(0))
    kw = dict(remat=False) if policy == "off" else dict(remat_policy=policy)
    torch.cuda.reset_peak_memory_stats()
    try:
        state = ST.init_train_state(
            cfg, torch.Generator("cuda").manual_seed(0), "cuda")
        out["state_gib"] = sum(
            t.numel() * t.element_size() for t in
            OPT.leaves(state["params"]) + OPT.leaves(state["opt"])) / 2**30
        step = ST.make_train_step(
            cfg, ShapeSpec("probe", S, B, "train"),
            opt_cfg=OPT.AdamWConfig(lr=3e-3, warmup_steps=20,
                                    total_steps=100), **kw)
        losses, times = [], []
        for s in range(steps):
            batch = synthetic_batch(cfg, DataConfig(batch=B, seq_len=S), s)
            torch.cuda.synchronize()
            t0 = time.time()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.time() - t0)
        out.update(oom=False, losses=losses, step_s=times,
                   step_s_median=float(np.median(times[1:] or times)))
    except torch.cuda.OutOfMemoryError as e:
        out.update(oom=True, error=str(e).split("\n")[0][:200])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", action="append",
                    help="ARCH:DEPTH:BATCH:SEQ:POLICY[:STEPS] (repeatable)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("remat_memory_torch: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    failed = 0
    for spec in args.case or DEFAULT_CASES:
        t0 = time.time()
        proc = subprocess.run([sys.executable, __file__, "--one", spec],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            failed += 1
            print(f"{spec}: exit {proc.returncode}\n{proc.stderr[-3000:]}",
                  flush=True)
            continue
        res = json.loads(lines[-1])
        res.update(card=smi, wall_s=time.time() - t0)
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
