"""What the metric readers share: device time, spans, rooflines, MFU.

Each reader in ``portbench/metrics/`` is one small file that names what it
reads; these functions do the arithmetic. Each returns None where the run
has nothing for it to read (no trace, no matching operation, no units), so
that the harness leaves the metric out of the result.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from portbench.reference.work import FP32_FLOP_PER_S, bound_s

__all__ = ["idle_pct", "span_ms", "roofline_pct", "mfu_pct"]


def _trace(run):
    return run.traces[0] if run.traces else None


def idle_pct(run) -> Optional[float]:
    """The share of the traced units' time in which no device operation
    ran, from the trace alone: idle seconds inside the drivers' unit spans
    (operation intervals merged) over the spans' seconds. What the harness
    and the profiler do between units is left out; the profiler's host
    overhead inside a unit is not (PERF.md)."""
    t = _trace(run)
    if t is None or not t.device:
        return None
    idle, length = t.unit_idle()
    return 100.0 * idle / length if length > 0 else None


def span_ms(run, name: str) -> Optional[float]:
    """Device ms launched inside the spans ``name``, per span."""
    t = _trace(run)
    if t is None:
        return None
    s, n = t.span_device_s(name)
    return 1e3 * s / n if n and s > 0 else None


def roofline_pct(run, names: Iterable[str],
                 calls: Callable[[dict, dict], Iterable[tuple]]
                 ) -> Optional[float]:
    """The least time the card needs for the kernel calls of one unit of
    work, ``calls(config, traffic)`` giving each call's (bytes, operations),
    times the traced units, over the device time of the kernels whose name
    holds one of ``names``."""
    t = _trace(run)
    if t is None or not run.traced_units:
        return None
    s, n = t.device_s(names)
    if not n:
        return None
    least = sum(bound_s(nbytes, flops)[0]
                for nbytes, flops in calls(run.config, run.traffic))
    return 100.0 * least * run.traced_units / s


def mfu_pct(run) -> Optional[float]:
    """Model FLOPs of one unit (the plain reference's count) over the
    window's host-clock time per unit, over the fp32 peak."""
    if not run.unit_flops or not run.units or not run.window_s:
        return None
    per_unit = run.window_s / len(run.units)
    return 100.0 * run.unit_flops / per_unit / FP32_FLOP_PER_S
