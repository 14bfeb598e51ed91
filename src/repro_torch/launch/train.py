"""Training driver with fault tolerance (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 200 --ckpt-dir CKPT [--resume] [--simulate-failure 80]
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
        --device cpu --steps 20 --batch 4 --seq-len 32

It runs on CUDA unless ``--device cpu`` is given (without a GPU it raises).
The dense, VLM and encoder families train; MoE, ssm and hybrid are refused
(``launch/steps.py::require_trainable``).

Fault tolerance, as in the JAX driver:
  * checkpoint/restart: async sharded checkpoints every --ckpt-every steps
    (the JAX package's format: either package restores the other's);
    --resume restores the latest manifested step and continues the exact
    token stream (the data pipeline is a pure function of the step)
  * preemption: SIGTERM/SIGINT → checkpoint and exit
  * stragglers: a step slower than --straggler-factor × the rolling median
    is logged and counted
  * --simulate-failure N raises at step N, after the checkpoint in flight
    (if any) is on disk
  * --deterministic turns on ``torch.use_deterministic_algorithms`` (and
    sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` if unset) for the run and
    restores both after it, so that a resumed run on the card equals an
    uninterrupted one to the bit
"""
from __future__ import annotations

import argparse
import os
import signal
import statistics
import sys
import threading
import time
from typing import Any, Dict, List

import torch

import repro_torch.configs as C
from repro_torch.launch import steps as ST
from repro_torch.models.config import ShapeSpec
from repro_torch.serving.engine import resolve_device
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import optim as OPT
from repro_torch.training.data import DataConfig, synthetic_batch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=0,
                    help="raise at this step (tests checkpoint/restart)")
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--deterministic", action="store_true",
                    help="bitwise-reproducible steps on the card")
    return ap.parse_args(argv)


def train(argv=None) -> Dict[str, Any]:
    """Run the driver; returns {"losses", "grad_norms", "step_s" (per
    step), "start" (the first step run), "stragglers", "state" (the final
    train state), "cfg"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = C.get_smoke_config(args.arch) if args.smoke else \
        C.get_config(args.arch)
    ST.require_trainable(cfg)
    shape = ShapeSpec("cli", seq_len=args.seq_len, global_batch=args.batch,
                      kind="train")
    opt_cfg = OPT.AdamWConfig(lr=args.lr, warmup_steps=20,
                              total_steps=max(args.steps, 100))
    step_fn = ST.make_train_step(cfg, shape, num_micro=1, opt_cfg=opt_cfg,
                                 device=device)

    was_deterministic = torch.are_deterministic_algorithms_enabled()
    was_workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if args.deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    start = 0
    last = CKPT.latest_step(args.ckpt_dir) if (args.resume
                                               and args.ckpt_dir) else None
    if last is not None:
        state = CKPT.restore(args.ckpt_dir, last, ST.train_state_specs(cfg),
                             device=device)
        start = state["step"]
        print(f"[resume] restored step {start} from {args.ckpt_dir}",
              flush=True)
    else:
        gen = torch.Generator(device).manual_seed(0)
        state = ST.init_train_state(cfg, gen, device)

    dcfg = DataConfig(batch=args.batch, seq_len=args.seq_len)
    stop = {"now": False}

    def _sig(_sig, _frm):
        print("[preempt] signal received → checkpoint and exit", flush=True)
        stop["now"] = True

    handlers = {}
    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            handlers[s] = signal.signal(s, _sig)

    hist: Dict[str, List[float]] = {"losses": [], "grad_norms": [],
                                    "step_s": []}
    stragglers = 0
    pending = None
    try:
        for step in range(start, args.steps):
            if args.simulate_failure and step == args.simulate_failure:
                if pending is not None:
                    pending.join()
                raise RuntimeError(f"simulated node failure at step {step}")
            batch = synthetic_batch(cfg, dcfg, step)
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            hist["losses"].append(loss)
            hist["grad_norms"].append(float(metrics["grad_norm"]))
            hist["step_s"].append(dt)
            times = hist["step_s"]
            if len(times) > 5:
                med = statistics.median(times[-50:])
                if dt > args.straggler_factor * med:
                    stragglers += 1
                    print(f"[straggler] step {step}: {dt:.3f}s vs median "
                          f"{med:.3f}s", flush=True)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} gnorm "
                      f"{hist['grad_norms'][-1]:.3f} lr "
                      f"{float(metrics['lr']):.2e} {dt * 1e3:.0f}ms",
                      flush=True)
            if args.ckpt_dir and ((step + 1) % args.ckpt_every == 0
                                  or stop["now"]):
                if pending is not None:
                    pending.join()
                pending = CKPT.save_async(args.ckpt_dir, step + 1, state)
            if stop["now"]:
                break
        if pending is not None:
            pending.join()
        if args.ckpt_dir and not stop["now"]:
            CKPT.save(args.ckpt_dir, args.steps, state)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
        if args.deterministic:
            torch.use_deterministic_algorithms(was_deterministic)
            if was_workspace is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    print(f"[done] steps={args.steps} stragglers={stragglers}", flush=True)
    return dict(hist, start=start, stragglers=stragglers, state=state,
                cfg=cfg)


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
