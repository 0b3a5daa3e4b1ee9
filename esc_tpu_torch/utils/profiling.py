"""Tracing and step timing (port of ``esc_tpu/utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` session, CPU and CUDA activities,
  that writes a Chrome / Perfetto trace of everything run inside into
  ``logdir``.
- ``annotate(name)``: the port's one span primitive, a labelled range of
  host work inside a trace.
- ``StepTimer``: per-step or per-window step times with a mean, p50 and p95
  summary, the warm-up left out. On a CUDA device a step is timed by two
  CUDA events, read when :meth:`StepTimer.toc` or
  :meth:`StepTimer.toc_window` returns (the one place the timer waits for
  the card); on the CPU by the wall clock.

Spans. The port labels its own phases with :func:`annotate`. A span's
family is the part of its name before the first dot; on one host thread a
span's parent is the span that encloses it:

- ``codec``: ``codec.encode`` and ``codec.decode`` around a codec's
  ``encode`` / ``decode``; inside them ``codec.upload`` (the host-to-device
  copy of the input), ``codec.stft`` and ``codec.istft``; and, where the
  call runs on stage graphs (:mod:`.graphs`), ``codec.capture`` around the
  capture of its chain, after the call's eager stages (nothing in it runs
  on the device), or ``codec.replay`` around a replayed call (the walk of
  its stages and the copy of its result), one a call, each after the
  call's ``codec.upload``;
- ``encoder``: ``encoder.embed`` (patch embedding and the top layer), then
  ``encoder.s{i}``, one per down-scaling layer; in the DAC
  (``baselines/dac/model.py``) ``encoder.embed`` is the first conv,
  ``encoder.s{i}`` one per ``EncoderBlock`` and ``encoder.post`` the last
  snake and conv; in EnCodec (``baselines/encodec/model.py``)
  ``encoder.embed`` is the first conv, ``encoder.s{i}`` the residual unit,
  ELU and strided conv of each ratio, ``encoder.lstm`` the SLSTM and
  ``encoder.post`` the last ELU and conv;
- ``vq``: ``vq.s{i}``, one per product VQ call of scale ``i`` (0 the
  bottleneck), with the residual that feeds it and the sum that leaves it;
  an RVQ codec's whole quantizer is ``vq.s0`` (the DAC's in its encode and
  in ``from_codes``, EnCodec's in its encode and decode);
- ``decoder``: ``decoder.s{i}``, one per up-scaling layer, and
  ``decoder.post`` (the top layer and patch de-embedding). A cross-scale
  ESC encode runs the decoder's layers too, between its scales. The DAC's
  are ``decoder.pre`` (the first conv), ``decoder.s{i}`` (one per
  ``DecoderBlock``) and ``decoder.post`` (last snake, conv and tanh);
  EnCodec's ``decoder.pre``, ``decoder.lstm``, ``decoder.s{i}`` (the ELU,
  strided transposed conv and residual unit of each ratio) and
  ``decoder.post``;
- ``act``: ``act.snake`` around each call of the DAC's snake activation
  (``baselines/dac/layers.py::Snake1d``), nested in the stage spans;
- ``dp``: ``dp.allreduce`` around the exchange of ``DataParallel``'s
  ``average_grads`` and ``mean`` over the ranks (``parallel/mesh.py``);
- ``serving``: in ``stream_map``, per batch, ``serving.upload``,
  ``serving.launch`` (the call that enqueues the batch's work),
  ``serving.download`` and ``serving.wait`` (the wait for the batch's copy
  to the host);
- ``train``: ``train.step`` around a training step, ``train.upload`` around
  its batch's copy to the device;
- ``gen`` and ``disc``: the generator's ``gen.forward``, ``gen.loss``
  (every loss term, the adversarial ones included), ``gen.backward``
  (``backward()`` and the release of the step's autograd graph) and
  ``gen.update`` (gradient averaging over the ranks, clip and AdamW), and
  the discriminator's ``disc.loss``, ``disc.backward`` and ``disc.update``.

In a codec's ``encode`` and ``decode`` (the DAC's ``encode_codes`` and
``decode_codes``) every operator runs under a stage span
(``codec.upload``, ``codec.stft``, ``codec.istft``, ``encoder.*``,
``vq.*``, ``decoder.*``), so the stages add up to the call. On a replayed
call the stage spans sit inside ``codec.replay`` and each holds one graph
launch (``cudaGraphLaunch``) in place of its operators; the kernels the
graph runs keep that launch's correlation id, so they still belong to
the stage. Only the result's copy out of the graphs' memory runs under
``codec.replay`` itself.

The clock. While a profiler records, a span is a
``torch.profiler.record_function`` range: it lands in the same trace as the
operators, the CUDA runtime calls and the kernels, on one clock, and a
kernel belongs to the span in which its launch was called (the runtime
event of the same correlation id). An idle stretch of the device is then
named by the innermost span or operator that the host was in.

The off path. With no profiler recording, :func:`annotate` makes one check
(``torch.autograd._profiler_enabled()``) and returns a shared
``contextlib.nullcontext()``: a span costs well under a microsecond and
records nothing.
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


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Label a region of host work inside an active profiler (a
    :func:`trace` or any ``torch.profiler`` session); with none recording,
    the shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
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
