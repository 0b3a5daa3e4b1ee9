"""The program's own spans in a trace: device time, host time and
synchronising calls by span or span family.

``esc_tpu_torch`` labels its phases with ``record_function`` ranges while a
profiler records (``esc_tpu_torch/utils/profiling.py``): ``codec.encode``,
``encoder.s2``, ``vq.s0``, ``serving.launch``, ``gen.backward``... A span's
family is the part of its name before the first dot. A selector names one
span (``codec.encode``) or, written ``<family>.*``, every span of a family
(``vq.*``). The spans a set of selectors picks are merged into disjoint
ranges of the host clock before anything is counted, so that a span nested
in another of the same set counts once.

- device time: the device operations whose launch (the CUDA runtime or
  driver call of the same correlation id) lies inside the ranges, as
  :meth:`portbench.trace.Trace.span_device_s` attributes them;
- host time: the ranges' length;
- synchronising calls: the CUDA runtime and driver calls inside the ranges
  that make the host wait for the device (:func:`is_sync`).

Each reader returns None where the trace holds none of the selected spans
(a program without them) or no device operation (a run on the CPU), so
that the harness leaves the metric out of the result.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Iterable, List, Optional, Tuple

__all__ = ["is_sync", "ranges", "device_ms", "host_ms", "sync_calls"]


def is_sync(name: str) -> bool:
    """A CUDA runtime or driver call that waits for the device: a
    ``*Synchronize*`` call, a ``cudaMemcpy*`` that is not ``Async``, or a
    free of device or pinned memory (``cudaFree``, ``cudaFreeHost``,
    ``cuMemFree*``). A pageable ``.to(device)`` shows as
    ``cudaMemcpyAsync`` then ``cudaStreamSynchronize``: one call."""
    return ("Synchronize" in name
            or (name.startswith("cudaMemcpy") and "Async" not in name)
            or name in ("cudaFree", "cudaFreeHost")
            or name.startswith("cuMemFree"))


def _picked(name: str, selectors: Tuple[str, ...]) -> bool:
    return any(name.startswith(s[:-1]) if s.endswith(".*") else name == s
               for s in selectors)


def ranges(trace, selectors: Iterable[str]) -> List[Tuple[float, float]]:
    """The spans of ``trace`` that ``selectors`` pick, merged, in order."""
    selectors = tuple(selectors)
    out: List[List[float]] = []
    for a, b in sorted((a, b) for name, a, b in trace.spans
                       if _picked(name, selectors)):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _per_unit(run, selectors, count) -> Optional[float]:
    """``count(trace, spans, inside)`` over the traced units, where
    ``inside(t)`` says whether the host time ``t`` lies in a span."""
    trace = run.traces[0] if run.traces else None
    if trace is None or not trace.device or not run.traced_units:
        return None
    spans = ranges(trace, selectors)
    if not spans:
        return None
    starts = [a for a, _ in spans]

    def inside(t: float) -> bool:
        i = bisect_right(starts, t) - 1
        return i >= 0 and t <= spans[i][1]
    return count(trace, spans, inside) / run.traced_units


def device_ms(run, *selectors: str) -> Optional[float]:
    """Device ms launched inside the selected spans, per traced unit."""
    def count(trace, spans, inside):
        return 1e3 * sum(b - a for _, a, b, corr in trace.device
                         if corr in trace.runtime
                         and inside(trace.runtime[corr]))
    return _per_unit(run, selectors, count)


def host_ms(run, *selectors: str) -> Optional[float]:
    """Host ms inside the selected spans, per traced unit."""
    def count(trace, spans, inside):
        return 1e3 * sum(b - a for a, b in spans)
    return _per_unit(run, selectors, count)


def sync_calls(run, *selectors: str) -> Optional[float]:
    """Synchronising calls (:func:`is_sync`) that start inside the selected
    spans, per traced unit."""
    def count(trace, spans, inside):
        return sum(1 for name, a, _ in trace.host
                   if is_sync(name) and inside(a))
    return _per_unit(run, selectors, count)
