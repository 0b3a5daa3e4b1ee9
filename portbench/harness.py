"""What a run carries from its driver to the metric readers and the result.

A driver (``portbench/drivers/<name>.py``, named by the traffic file's
``driver``) gets a :class:`Run`, sets the program up, marks the end of the
set-up (:meth:`Run.setup_done`), measures for ``seconds``, checks the
outputs and fills in what the readers need:

- ``window_s``: host-clock seconds from the window's start to the end of
  its last unit of work, and ``units``, one dict per completed batch,
  request or step;
- ``traces``: with ``--trace 1``, the :class:`portbench.trace.Trace` of a
  segment run under the profiler after the window, and ``traced_units``,
  the units of work in it;
- ``unit_flops``: the model FLOPs of one unit by the plain reference;
- ``checks``: each number compared, with its limit (``correct`` holds when
  every value is at most its limit);
- ``memory_peak_bytes``, ``attempted``, ``failed``.

Readers (``portbench/metrics/<metric>.py``) take the run and return a
number, or None where they find nothing to read.
"""

from __future__ import annotations

import gc
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["ROOT", "Run", "load_json", "reservoir"]

ROOT = Path(__file__).resolve().parent          # portbench/


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Run:
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str                 # "cuda" on the card, "cpu" in tests
    t_start: float              # perf_counter at process start
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    units: List[dict] = field(default_factory=list)
    traces: list = field(default_factory=list)
    traced_units: int = 0
    unit_flops: Optional[float] = None
    checks: Dict[str, Dict[str, float]] = field(default_factory=dict)
    memory_peak_bytes: int = 0
    device_count: int = 1
    attempted: int = 0
    failed: int = 0
    notes: List[str] = field(default_factory=list)

    def setup_done(self) -> None:
        """The end of the set-up: what it made is moved out of the
        collector's way (``gc.freeze``), so that collections in the window
        walk only what the window makes."""
        gc.collect()
        gc.freeze()
        self.setup_s = time.perf_counter() - self.t_start

    def check(self, name: str, value: float) -> None:
        """Hold ``value`` to this workload's limit of ``name``; a number
        the limits file does not name is printed and not compared."""
        limits = self.limits()
        if name in limits:
            self.checks[name] = {"value": float(value),
                                 "limit": limits[name]}
        else:
            self.note(f"{name}: {float(value)!r} (not compared)")

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values())

    def note(self, msg: str) -> None:
        """A line for standard error, before the checks."""
        self.notes.append(msg)

    def limits(self) -> Dict[str, float]:
        """This workload's limits (``portbench/limits/<workload>.json``)."""
        return {k: float(v) for k, v in
                load_json(ROOT / "limits" / f"{self.workload}.json")
                ["limits"].items()}


def reservoir(rng, keep: list, item, seen: int, size: int) -> None:
    """Reservoir sampling: after ``seen`` items (this one included),
    ``keep`` is a uniform sample of ``size`` of them drawn from ``rng``."""
    if len(keep) < size:
        keep.append(item)
        return
    j = int(rng.integers(0, seen))
    if j < size:
        keep[j] = item
