"""Reading the profiler's trace of a traced window.

The profiler records the device's activity alone (CUPTI: the kernels and
copies on the device, and the runtime calls on the host that launched
them); recording every PyTorch operation on the host as well would double
the window's length.  The device events are read straight from the
trace's raw events, as ``chip_smoke.py::profile`` (line 2249) reads them:
the profiler's own averaging takes minutes over the 10^5-10^6 events of a
window.  Beyond that copy, each device event is tied to the benchmark's
span (``spans.py``, on the profiler's clock) that its launch lay in,
through the correlation id that the launch on the host and the work on the
device share; so a kernel's device time is the sum of every device event
launched inside its wrapper's span, whatever the kernels are called.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple


class Trace:
    """busy_s: the union of the device events' intervals; by_name: device
    seconds and events by kernel name; by_range: device seconds by the
    span the launch lay in (innermost); idle_gaps: the longest idle
    stretches of the device, each named by the innermost span the host was
    in at its start."""

    def __init__(self, prof, window_s: float,
                 ranges: List[Tuple[int, int, str]]):
        from torch.autograd import DeviceType
        self.window_s = window_s
        ranges = sorted(ranges)
        launch_at: Dict[int, int] = {}
        dev: List[Tuple[int, int, str, int]] = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                # "nccl:..." annotates NCCL's kernel on the device: counted
                # once, as the kernel
                if e.duration_ns() > 0 and not name.startswith("nccl:") \
                        and not e.is_user_annotation():
                    dev.append((e.start_ns(), e.end_ns(), name,
                                e.correlation_id()))
            elif name.startswith("cu"):        # runtime / driver launches
                launch_at[e.correlation_id()] = e.start_ns()
        dev.sort()
        self.n_device_events = len(dev)
        self.by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        for s, t, name, _ in dev:
            row = self.by_name[name]
            row[0] += (t - s) / 1e9
            row[1] += 1
        # the union of the device intervals
        busy, end = 0, None
        gaps: List[Tuple[int, int]] = []
        for s, t, _, _ in dev:
            if end is None:
                busy += t - s
                end = t
            elif s > end:
                gaps.append((end, s))
                busy += t - s
                end = t
            elif t > end:
                busy += t - end
                end = t
        self.busy_s = busy / 1e9
        self._ranges = ranges
        self._starts = [r[0] for r in ranges]
        # each range's enclosing range (ranges of one thread nest)
        self._parent: List[int] = []
        stack: List[int] = []
        for j, (s, e, _) in enumerate(ranges):
            while stack and ranges[stack[-1]][1] < s:
                stack.pop()
            self._parent.append(stack[-1] if stack else -1)
            stack.append(j)
        self.by_range: Dict[str, float] = defaultdict(float)
        self.unattributed = 0
        for s, t, _, corr in dev:
            at = launch_at.get(corr)
            if at is None:
                self.unattributed += 1
                continue
            name = self.range_at(at)
            if name is not None:
                self.by_range[name] += (t - s) / 1e9
        gaps.sort(key=lambda g: g[0] - g[1])
        self.idle_gaps = [((self.range_at(a) or "outside every span"),
                           (b - a) / 1e9) for a, b in gaps[:10]]

    def range_at(self, t_ns: int):
        """The innermost span holding host time `t_ns`."""
        j = bisect.bisect_right(self._starts, t_ns) - 1
        while j >= 0 and self._ranges[j][1] < t_ns:
            j = self._parent[j]
        return self._ranges[j][2] if j >= 0 else None

    def top_ops(self, n: int = 10) -> List[List[object]]:
        return [[k, v[0]] for k, v in sorted(self.by_name.items(),
                                             key=lambda x: -x[1][0])[:n]]
