"""The benchmark's own instrumentation of the program: wrappers installed
around calls into each layer, never edits to the program.

Always installed:

* the record of every request the batcher served: its prompt as the model
  read it, the text it produced, its error, and its grammar (which ties
  the request to the slots it held);
* the logits each sampling round chose from: the first 259 columns (the
  byte tokens and the three specials, all a schema can allow) of each
  slot, copied on the device, with each slot's grammar.  The check of
  `correct` reads them: they are what the timed path produced.

Installed for a traced run only: spans around each layer's entry and
around the kernel wrapper of each of the cell's kernel metrics (host
clock; each also kept as a (start, end) range on the profiler's clock,
``time.time_ns``), with each such call's least bytes and operations.  A
kernel metric's file (``metrics/<name>.py``) names what it wraps: ``WRAPS``,
the wrapper's name in ``repro_torch.kernels.ops``; ``PEAK``, the peak its
operations are held to (``costs.PEAK_FLOPS``); and ``count(cost, *args,
**kwargs)``, which adds a call's bytes and operations (``costs.py``) to
``cost``.  So a kernel's metric is a new file.  A span does not synchronize:
the host runs ahead of the device as it does untraced (a tick's sampling
builds its mask while the device still runs the tick), so a span is the
host's time in the layer, which includes the waits for the device that
the layer makes itself (the sampler copies its tokens back).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ipdb_bench.harness import costs

#: logits columns kept a slot: bytes 0-255, pad, begin and end
KEPT_COLUMNS = 259


class Instruments:
    def __init__(self, trace: bool, wraps: Optional[dict] = None):
        self.trace = trace
        #: kernel metric name -> its module (WRAPS, PEAK, count)
        self.wraps = wraps or {}
        #: (prompt as the model read it, served text, error, grammar)
        self.requests: List[Tuple[str, str, object, object]] = []
        #: (logits (slots, KEPT_COLUMNS) float32 on the device, each slot's
        #: grammar or None) per sampling round
        self.samples: List[Tuple[torch.Tensor, list]] = []
        #: span name -> [host seconds, calls]
        self.spans: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        #: (start ns, end ns, name) of every span, on the profiler's clock
        self.ranges: List[Tuple[int, int, str]] = []
        #: kernel metric name -> costs.KernelCost
        self.kernels: Dict[str, costs.KernelCost] = {}
        self._undo: List[Tuple[object, str, object]] = []
        self._launches: List[Tuple[Callable, Callable]] = []

    def reset(self) -> None:
        """Forget what set-up recorded: the window starts."""
        self.requests.clear()
        self.samples.clear()
        self.ranges.clear()
        for acc in self.spans.values():
            acc[0], acc[1] = 0.0, 0
        for name, cost in self.kernels.items():
            self.kernels[name] = costs.KernelCost(cost.peak)

    # -- installing -------------------------------------------------------
    def _patch(self, owner, attr: str, new) -> None:
        self._undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, new)

    def remove(self) -> None:
        for fn, wrapped in self._launches:
            fn.launches = wrapped.launches
        self._launches.clear()
        while self._undo:
            owner, attr, old = self._undo.pop()
            setattr(owner, attr, old)

    def span(self, name: str, fn: Callable) -> Callable:
        acc, ranges = self.spans[name], self.ranges

        def wrapped(*a, **k):
            t, t_ns = time.perf_counter(), time.time_ns()
            try:
                return fn(*a, **k)
            finally:
                acc[0] += time.perf_counter() - t
                acc[1] += 1
                ranges.append((t_ns, time.time_ns(), name))
        return wrapped

    def install(self) -> "Instruments":
        from repro_torch.core.executors import TorchExecutor
        from repro_torch.serving.engine import InferenceEngine
        from repro_torch.serving.scheduler import ContinuousBatcher

        run, sample = ContinuousBatcher.run, InferenceEngine._sample
        served, rounds = self.requests, self.samples

        def run_recorded(batcher, requests, *, temperature=0.0,
                         shared_prefix=""):
            out = run(batcher, requests, temperature=temperature,
                      shared_prefix=shared_prefix)
            for r in out:
                served.append((shared_prefix + r.prompt, r.text, r.error,
                               r.grammar))
            return out

        def sample_recorded(engine, logits, gs, states, temperature):
            kept = logits[:, :KEPT_COLUMNS].float().clone()
            rounds.append((kept, list(gs)))
            return sample(engine, logits, gs, states, temperature)
        if self.trace:
            run_recorded = self.span("batcher.run", run_recorded)
            sample_recorded = self.span("engine.sample", sample_recorded)
        self._patch(ContinuousBatcher, "run", run_recorded)
        self._patch(InferenceEngine, "_sample", sample_recorded)
        if not self.trace:
            return self
        self._patch(TorchExecutor, "complete_many", self.span(
            "executor.complete_many", TorchExecutor.complete_many))
        for attr, name in (("_prefill", "engine.prefill"),
                           ("paged_prefill", "engine.prefill"),
                           ("decode_step", "model.tick"),
                           ("paged_decode", "model.tick")):
            self._patch(InferenceEngine, attr,
                        self.span(name, getattr(InferenceEngine, attr)))
        self._install_kernels()
        return self

    def _install_kernels(self) -> None:
        from repro_torch.kernels import ops

        for metric, mod in self.wraps.items():
            fn = getattr(ops, mod.WRAPS)
            self.kernels[metric] = costs.KernelCost(mod.PEAK)
            wrapped = self._kernel_span(fn, metric, mod.count)
            # the wrapper counts its launches by its module-level name
            wrapped.launches = fn.launches
            self._patch(ops, mod.WRAPS, wrapped)
            self._launches.append((fn, wrapped))

    def _kernel_span(self, fn: Callable, metric: str,
                     count: Callable) -> Callable:
        label, ranges, kernels = "kernel." + metric, self.ranges, self.kernels

        def wrapped(*a, **k):
            t_ns = time.time_ns()
            out = fn(*a, **k)
            ranges.append((t_ns, time.time_ns(), label))
            # counted outside the range: its reductions are not the
            # kernel's device time
            count(kernels[metric], *a, **k)
            return out
        return wrapped
