"""Reading a ``torch.profiler`` trace: device time, spans, launches, gaps.

A traced segment runs under :func:`traced`, which wraps it in the span
``portbench.window`` and exports the profiler's Chrome trace into a
temporary directory (under ``TMPDIR``), reads it into a :class:`Trace` and
deletes the file. Times are in seconds.

- device operations: the events of categories ``kernel``, ``gpu_memcpy``
  and ``gpu_memset``;
- launches: CUDA runtime and driver calls whose name holds
  ``LaunchKernel`` or ``GraphLaunch``;
- spans: ``user_annotation`` events, the benchmark's
  ``torch.profiler.record_function`` ranges around calls into the program;
- units: the spans :data:`UNIT` a driver puts around each unit of work it
  traces (a request, a step, or a whole pipelined stream of batches), so
  that the device's idle share leaves out what the harness and the
  profiler do between units.

A device operation belongs to a span when the host call that launched it
(the runtime event of the same correlation id) lies inside the span.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["Trace", "traced", "span", "unit", "WINDOW", "UNIT"]

WINDOW = "portbench.window"
UNIT = "portbench.unit"
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Trace:
    """The events of one traced segment."""

    def __init__(self, events: Iterable[dict]):
        self.device: List[Tuple[str, float, float, Optional[int]]] = []
        self.runtime: Dict[int, float] = {}
        self.launches = 0
        self.spans: List[Tuple[str, float, float]] = []
        self.units: List[Tuple[float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            ts, dur = float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
            corr = (e.get("args") or {}).get("correlation")
            if cat in _DEVICE:
                self.device.append((name, ts, ts + dur, corr))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if corr is not None:
                    self.runtime[corr] = ts
                if "LaunchKernel" in name or "GraphLaunch" in name:
                    self.launches += 1
            if cat == "user_annotation":
                if name == WINDOW:
                    window = (ts, ts + dur)
                elif name == UNIT:
                    self.units.append((ts, ts + dur))
                else:
                    self.spans.append((name, ts, ts + dur))
            if cat in _HOST:
                self.host.append((name, ts, ts + dur))
        if window is None:
            raise ValueError(f"the trace holds no {WINDOW} span")
        self.t0, self.t1 = window
        self.device.sort(key=lambda d: d[1])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The device's busy time inside the window, merged."""
        out: List[List[float]] = []
        for _, a, b, _ in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def unit_idle(self) -> Tuple[float, float]:
        """(seconds inside the unit spans with no device operation, the
        unit spans' seconds); (0, 0) where the trace has no unit span."""
        busy = self.busy_intervals()
        ends = [y for _, y in busy]
        idle = length = 0.0
        for a, b in self.units:
            inside, i = 0.0, bisect_right(ends, a)
            while i < len(busy) and busy[i][0] < b:
                inside += min(b, busy[i][1]) - max(a, busy[i][0])
                i += 1
            length += b - a
            idle += (b - a) - inside
        return idle, length

    def device_s(self, names: Iterable[str]) -> Tuple[float, int]:
        """(seconds, count) of the device operations whose name holds one
        of ``names``."""
        names = tuple(names)
        hits = [(b - a) for n, a, b, _ in self.device
                if any(k in n for k in names)]
        return sum(hits), len(hits)

    def span_device_s(self, span: str) -> Tuple[float, int]:
        """(device seconds launched inside spans named ``span``, how many
        such spans)."""
        ranges = sorted((a, b) for n, a, b in self.spans if n == span)
        if not ranges:
            return 0.0, 0
        starts = [a for a, _ in ranges]
        total = 0.0
        for _, a, b, corr in self.device:
            t = self.runtime.get(corr)
            if t is None:
                continue
            i = bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                total += b - a
        return total, len(ranges)

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took the most time, by name."""
        by: Dict[str, float] = {}
        for name, a, b, _ in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches with no device operation inside the
        window, each named by the innermost host event covering its middle
        (``host: idle`` where none does)."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for length, start in gaps:
            mid = start + length / 2
            cover = [(b - a, name) for name, a, b in self.host
                     if a <= mid <= b]
            name = min(cover)[1] if cover else "idle"
            out.append([f"host: {name[:150]}", length])
        return out


@contextlib.contextmanager
def traced(sink: list):
    """Profile the block (CPU and CUDA activities) inside the span
    :data:`WINDOW`, synchronised at both ends; append its :class:`Trace`
    to ``sink`` when the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            _sync()
            yield
            _sync()
    with tempfile.TemporaryDirectory(prefix="portbench_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    sink.append(Trace(events))


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def unit():
    """The span :data:`UNIT` around one unit of traced work."""
    from torch.profiler import record_function
    return record_function(UNIT)


def span(name: str, fn):
    """``fn`` wrapped in a ``record_function`` range named ``name``."""
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return wrapped
