"""Every driver runs end to end on the CPU at a tiny size, untraced and
traced, with the kernels' plain versions, and its outputs hold against the
plain reference within the cells' limits."""

import json
import math

import pytest

from portbench import run as R
from portbench.tests.tiny import run_tiny

WORKLOADS = [c["name"] for c in R.load_bench()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [False, True])
def test_driver_runs_and_is_correct(workload, trace):
    run, metrics = run_tiny(workload, trace)
    assert run.correct, run.checks
    assert run.attempted == len(run.units) > 0
    assert run.failed == 0
    assert run.setup_s > 0 and run.window_s > 0
    limits = run.limits()
    assert set(run.checks) == set(limits)
    for c in run.checks.values():
        assert math.isfinite(c["value"]) and c["value"] >= 0
    line = R.result_line(run, metrics, {"platform": "cpu"})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    json.dumps(line)
    names = {m["name"] for m in R.metrics_of(R.load_bench(), workload,
                                             trace)}
    assert set(metrics) <= names
    if not trace:
        # every end-to-end metric is host-clock, so the CPU reads them all
        assert set(metrics) == names
    else:
        assert run.traces and run.traced_units > 0
        assert "breakdown" in line
        # no device on the CPU: the device readers read nothing
        for name in metrics:
            assert name.startswith("mfu_pct")
