"""Tracing and step timing (port of ``esc_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` session, CPU and CUDA activities,
  that writes a Chrome / Perfetto trace of everything run inside into
  ``logdir``.
- ``annotate(name)``: a labelled range inside a trace
  (``torch.profiler.record_function``).
- ``StepTimer``: per-step or per-window step times with a mean, p50 and p95
  summary, the warm-up left out. On a CUDA device a step is timed by two
  CUDA events, read when :meth:`StepTimer.toc` or
  :meth:`StepTimer.toc_window` returns (the one place the timer waits for
  the card); on the CPU by the wall clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

__all__ = ["trace", "annotate", "StepTimer"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile what runs inside into ``logdir`` (created if absent): on
    leaving, one ``trace_<pid>_<n>.json`` there, with the card's kernels
    where CUDA is available. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        n = len([f for f in os.listdir(logdir) if f.startswith(
            f"trace_{os.getpid()}_")])
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name: str):
    """Label a region of host work inside an active :func:`trace`."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Step times: :meth:`tic` before a step and :meth:`toc` after it, or
    :meth:`tic` before a window's first step and :meth:`toc_window` after
    its last; ``summary()`` gives mean, p50, p95 and steps per second over
    the last ``window`` records, the first ``warmup`` left out."""

    def __init__(self, device: Union[str, torch.device] = "cpu",
                 window: int = 512, warmup: int = 2):
        self.cuda = torch.device(device).type == "cuda"
        self.window, self.warmup = window, warmup
        self._times: List[float] = []
        self._count = 0
        self._t0: Optional[float] = None
        self._start = None

    def tic(self) -> None:
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def _elapsed(self) -> float:
        """Seconds since :meth:`tic`; on CUDA it waits for the work queued
        so far."""
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return self._start.elapsed_time(end) / 1e3
        return time.perf_counter() - self._t0

    def _record(self, dt: float) -> float:
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        return dt

    def toc(self) -> float:
        """Close one step: records and returns its seconds."""
        return self._record(self._elapsed())

    def toc_window(self, n_steps: int) -> float:
        """Close the window of ``n_steps`` steps: records and returns the
        mean seconds per step."""
        return self._record(self._elapsed() / max(1, n_steps))

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {"step_time_mean_s": float(t.mean()),
                "step_time_p50_s": float(np.percentile(t, 50)),
                "step_time_p95_s": float(np.percentile(t, 95)),
                "steps_per_s": float(1.0 / t.mean())}
