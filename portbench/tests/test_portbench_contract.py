"""The benchmark's files hold together: BENCHMARK.json's shape, a file for
every configuration, traffic mix, metric and limit it names, the frozen
work count, and no import of the JAX side of the repository."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import run as R
from portbench.reference.work import (argmin_work, attention_work, bound_s,
                                      main_path_calls)

BENCH = R.load_bench()
ROOT = R.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "esc_tpu"}


def test_top_level_keys():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((R.REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (R.REPO / c["file"]).is_file()
        assert json.loads((R.REPO / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (ROOT / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "limits" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(R.reader(m["name"]))


def test_reader_found_by_name_or_by_the_part_before_the_dot():
    own = R.reader("encode_device_ms.serve")
    assert own.__module__ == "portbench_metric_encode_device_ms_serve"
    shared = [R.reader(f"device_idle_pct.{c}")
              for c in ("serve", "request", "train")]
    assert {r.__module__ for r in shared} == {
        "portbench_metric_device_idle_pct"}
    with pytest.raises(FileNotFoundError):
        R.reader("no_such_metric.serve")


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in BENCH["workloads"]:
        own = [m for m in e2e.values()
               if w["name"] in m.get("workloads", [w["name"]])]
        assert len(own) >= 2 and any(
            w["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_limits_name_what_the_driver_compares():
    for w in BENCH["workloads"]:
        limits = json.loads((ROOT / "limits" / f"{w['name']}.json")
                            .read_text())
        for name, lim in limits["limits"].items():
            r = limits["readings"][name]
            assert r["lower"] < lim < r["upper"], (w["name"], name)


def test_work_count_of_a_roundtrip():
    """4 clips of 3 s at 6 streams: 18 searches and 32 attention calls, at
    the bounds the kernel table gives (0.0031 ms by operations, 0.308 ms by
    bytes, with codebooks of 8)."""
    cfg = json.loads((ROOT / "configs" / "esc-base-adv.json").read_text())
    argmin, attn = main_path_calls(cfg["model"], 4, 47920, 6)
    assert len(argmin) == 18 and len(attn) == 32
    a = [bound_s(*argmin_work(*c)) for c in argmin]
    t = [bound_s(*attention_work(*c, 4)) for c in attn]
    assert {by for _, by in a} == {"operations"}
    assert {by for _, by in t} == {"bytes"}
    assert sum(s for s, _ in a) * 1e3 == pytest.approx(0.0031362, rel=1e-4)
    assert sum(s for s, _ in t) * 1e3 == pytest.approx(0.3080391, rel=1e-4)


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_no_jax_side_imported():
    for path in ROOT.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "math", "warnings", "typing",
                        "numpy", "torch"}, (path, tops)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.delitem(sys.modules, "esc_tpu", raising=False)
    monkeypatch.setitem(sys.modules, "esc_tpu_torch_probe",
                        types.ModuleType("esc_tpu_torch_probe"))
    before = set(R.forbidden_modules()) - {"esc_tpu"}
    monkeypatch.setitem(sys.modules, "esc_tpu.probe",
                        types.ModuleType("esc_tpu.probe"))
    assert "esc_tpu" in R.forbidden_modules()
    assert "esc_tpu_torch_probe" not in R.forbidden_modules()
    assert before <= set(R.forbidden_modules())
