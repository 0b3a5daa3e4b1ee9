"""Device time in which the program's spans hold the card.

:func:`portbench.spans.device_ms` adds up the durations of the device
operations launched inside the selected spans, so two that run side by
side (cuDNN's recurrence runs its kernels so, inside one CUDA graph) count
twice. :func:`busy_ms` merges their intervals first: the time in which at
least one of them runs."""

from __future__ import annotations

from typing import Optional

from portbench.spans import _per_unit

__all__ = ["busy_ms"]


def busy_ms(run, *selectors: str) -> Optional[float]:
    """Device ms per traced unit in which an operation launched inside the
    selected spans runs; None as :func:`portbench.spans.device_ms`."""
    def count(trace, spans, inside):
        total, end = 0.0, float("-inf")
        for a, b in sorted((a, b) for _, a, b, corr in trace.device
                           if corr in trace.runtime
                           and inside(trace.runtime[corr])):
            if b > end:
                total += b - max(a, end)
                end = b
        return 1e3 * total
    return _per_unit(run, selectors, count)
