"""On the card: a short run of a cell is correct, its control is not, and
the harness refuses to run where the program is missing. Skips without
CUDA (decided in the fixture)."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import control
from portbench import run as R


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _run(args, cwd=R.REPO):
    return subprocess.run([sys.executable, "portbench/run.py"] + args,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.cuda
def test_serve_batch_runs_correct(card):
    p = _run(["--workload", "esc-base.serve-batch", "--seed", "31",
              "--seconds", "2", "--trace", "0"])
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["esc-base.serve-batch",
                                      "esc-base-adv.train"])
def test_tf32_control_is_not_correct(card, workload, capsys):
    assert control.main(["--workload", workload, "--seeds", "4001"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is False, out["checks"]


@pytest.mark.cuda
def test_refuses_without_the_program(card, tmp_path):
    shutil.copy(R.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(R.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(["--workload", "esc-base.serve-batch", "--seed", "1",
              "--seconds", "1"], cwd=tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()
