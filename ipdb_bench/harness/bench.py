"""The benchmark's driver: one run of one cell.

    python3 ipdb_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json`` names its configuration (whose entry gives the file
under ``configs/``) and its traffic mix (``traffic/<mix>.json``, whose
``kind`` picks the runner, ``harness/<kind>_cell.py``); the check of its
outputs (how many served calls the reference reruns, and the limit of
each number compared) is ``checks/<cell>.json``; each per-layer metric is
read by ``metrics/<metric>.py``.  A later cell, mix or metric is new
files.

The run loads, warms up, measures, checks what the timed path produced
against the plain reference, and prints one JSON line last on standard
output.  It refuses to run without as many CUDA devices as the cell asks
for, and prints no result when the JAX package or JAX was loaded.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """One cell of BENCHMARK.json with its configuration, traffic mix and
    limits, read from their files."""

    def __init__(self, name: str, spec: Optional[dict] = None):
        self.spec = spec if spec is not None else json.loads(
            (ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in self.spec["configs"]}[
            self.entry["config"]]
        self.config = json.loads((ROOT / conf["file"]).read_text())
        self.traffic = json.loads(
            (BENCH / "traffic" / f"{self.entry['traffic']}.json").read_text())
        chk = BENCH / "checks" / f"{name}.json"
        self.checks = json.loads(chk.read_text()) if chk.exists() else {}
        self.limits = self.checks.get("limits", {})

    def end_to_end(self) -> Dict[str, dict]:
        return {m["name"]: m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])}

    def per_layer(self) -> Dict[str, dict]:
        """The per-layer metrics that list this cell."""
        return {m["name"]: m for m in self.spec["per_layer"]
                if self.name in m["workloads"]}


class Run:
    """What a runner needs of the harness (``<kind>_cell.run(run)``)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, override: Optional[dict] = None,
                 fault: Optional[Callable] = None):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t_start = t_start
        #: smaller sizes for the CPU tests: {"model": {...}, "traffic":
        #: {...}, "limits": {...}}
        self.override = override or {}
        self.limits = self.override.get("limits", cell.limits)
        self.sample_calls = int(cell.checks.get("sample_calls", 8))
        #: a planted fault (the tests): fault(engine or step) after set-up
        self.fault = fault
        #: the control (control.py): the reference in a lower precision,
        #: read beside the program's numbers
        self.control: Optional[Callable] = None
        self.setup_s: Optional[float] = None
        self.memory_peak = 0
        self.trace_reading = None

    def model(self) -> dict:
        return {**self.config["model"], **self.override.get("model", {})}

    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start

    def profiler(self):
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CUDA
                                   if self.device.type == "cuda"
                                   else ProfilerActivity.CPU])

    def read_memory(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated())

    def read_trace(self, prof, window: float, ranges, reading: dict
                   ) -> None:
        from ipdb_bench.harness.trace import Trace
        self.trace_reading = Trace(prof, window, ranges)
        reading["trace"] = self.trace_reading

    def wraps(self) -> Dict[str, object]:
        """The traced run's kernel metrics: name -> the metric's module,
        for each metric of the cell whose file names the kernel wrapper it
        wraps (``WRAPS``)."""
        if not self.trace:
            return {}
        mods = {name: metric_module(name) for name in self.cell.per_layer()}
        return {n: m for n, m in mods.items() if hasattr(m, "WRAPS")}


def metric_module(name: str):
    """``metrics/<name>.py``: ``read(reading)``, and for a kernel's metric
    ``WRAPS``, ``PEAK`` and ``count`` (``spans.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "ipdb_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_metrics(cell: Cell, reading: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell, read by its own reader; a reader
    that finds nothing to read returns None and the metric is left out."""
    out = {}
    for name, m in cell.per_layer().items():
        v = metric_module(name).read(reading)
        if v is not None:
            out[name] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(checks: Dict[str, float], limits: Dict[str, dict]):
    """(correct, the numbers compared with their limits).  Every number
    the cell's limits name is compared; one that the run could not read
    fails."""
    shown, ok = {}, True
    for name, lim in limits.items():
        value = checks.get(name)
        if "max" in lim:
            passed = value is not None and value <= lim["max"]
            shown[name] = {"value": value, "limit": f"<= {lim['max']}"}
        else:
            passed = value is not None and value >= lim["min"]
            shown[name] = {"value": value, "limit": f">= {lim['min']}"}
        ok &= passed
    return bool(ok), shown


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def execute(run: Run) -> dict:
    """Run the cell's runner and assemble the result (no printing)."""
    runner = importlib.import_module(
        f"ipdb_bench.harness.{run.traffic['kind']}_cell")
    out = runner.run(run)
    metrics = {}
    if not run.trace:
        for name, (value, unit) in out["metrics"].items():
            metrics[name] = {"value": float(value), "unit": unit}
        metrics["setup_s"] = {"value": float(run.setup_s), "unit": "s"}
    else:
        metrics = per_layer_metrics(run.cell, out["reading"])
    correct, shown = judge(out["checks"], run.limits)
    return {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "checks": shown, "numbers": out["checks"],
            "reading": out.get("reading")}


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)

    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ipdb_bench: {cell.name} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda"), t_start)
    res = execute(run)
    bad = loaded_forbidden()
    if bad:
        print(f"ipdb_bench: modules loaded in the run: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": run.memory_peak}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if run.trace:
        tr = run.trace_reading
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.top_ops(10),
                             "idle_gaps": [list(g) for g in tr.idle_gaps]}
        print(f"trace: {tr.n_device_events} device events, "
              f"{tr.unattributed} without a launch on the host; by range "
              + ", ".join(f"{k} {v:.6f} s" for k, v in sorted(
                  tr.by_range.items(), key=lambda x: -x[1])), file=sys.stderr)
    line["checks"] = res["checks"]
    print(power_line(), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def power_line() -> str:
    """The card's name and power limit (the peaks assume 700 W)."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = "nvidia-smi not available"
    return f"card: {out}"


def setup_env() -> None:
    """Every build and kernel cache of a run inside the checkout, at fixed
    paths (the kernels themselves: build/repro_torch_kernels/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
