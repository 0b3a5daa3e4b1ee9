"""The trainer's step timer (port of ``esc_tpu/utils/profiling.py::StepTimer``).

On a CUDA device a window of steps is timed by two CUDA events, read once
when the window closes, so the timer adds no synchronisation of its own;
on the CPU by the wall clock.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

__all__ = ["StepTimer"]


class StepTimer:
    """Per-step time of windows of steps: :meth:`tic` before a window's
    first step, :meth:`toc_window` after its last; ``summary()`` gives mean,
    p50, p95 and steps per second over the last ``window`` windows, the
    first ``warmup`` left out."""

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

    def toc_window(self, n_steps: int) -> float:
        """Close the window of ``n_steps`` steps: waits for its last step
        on the device, records and returns the mean seconds per step."""
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        dt /= max(1, n_steps)
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
            if len(self._times) > self.window:
                self._times.pop(0)
        return dt

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {"step_time_mean_s": float(t.mean()),
                "step_time_p50_s": float(np.percentile(t, 50)),
                "step_time_p95_s": float(np.percentile(t, 95)),
                "steps_per_s": float(1.0 / t.mean())}
