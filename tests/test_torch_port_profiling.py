"""The port's profiling utilities against ``esc_tpu/utils/profiling.py``:
``trace`` writes a trace file into its directory, a region labelled by
``annotate`` shows in it, and ``StepTimer.tic`` / ``toc`` (and
``toc_window``) keep the JAX package's warm-up and window, on a fake clock
that both timers read.
"""

import json

import numpy as np
import pytest
import torch

from esc_tpu.utils import profiling as jax_profiling
from esc_tpu_torch.utils import profiling
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401


def test_trace_writes_a_file_with_the_annotation(tmp_path):
    logdir = tmp_path / "trace"
    x = torch.randn(64, 64)
    with profiling.trace(str(logdir)):
        with profiling.annotate("esc_port_region"):
            (x @ x).sum()
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "esc_port_region" for e in events)
    assert any("mm" in e.get("name", "") for e in events)
    with profiling.trace(str(logdir)):       # a second one beside it
        (x + 1).sum()
    assert len(list(logdir.iterdir())) == 2


class FakeClock:
    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


@pytest.mark.parametrize("window,warmup", [(512, 2), (3, 1), (2, 0)])
def test_tic_toc_follow_the_jax_timer(monkeypatch, window, warmup):
    rng = np.random.default_rng(window + warmup)
    steps = np.cumsum(rng.uniform(0.01, 0.2, 40))
    ticks = [t for pair in zip(steps[:-1:2], steps[1::2]) for t in pair]
    timers = {}
    for name, mod in (("jax", jax_profiling), ("port", profiling)):
        monkeypatch.setattr(mod.time, "perf_counter", FakeClock(ticks))
        timer = mod.StepTimer(window=window, warmup=warmup)
        got = []
        for i in range(len(ticks) // 2):
            timer.tic()
            got.append(timer.toc() if i % 3 else timer.toc_window(4))
        timers[name] = (got, timer.summary())
    (jax_got, jax_sum), (got, summary) = timers["jax"], timers["port"]
    np.testing.assert_allclose(got, jax_got, rtol=1e-12)
    assert summary.keys() == jax_sum.keys()
    for k, v in jax_sum.items():
        assert summary[k] == pytest.approx(v, rel=1e-12), k


def test_empty_summary_and_cpu_default():
    timer = profiling.StepTimer()
    assert not timer.cuda and timer.summary() == {}
    timer.tic()
    assert timer.toc() >= 0.0
    assert timer.summary() == {}              # inside the warm-up
