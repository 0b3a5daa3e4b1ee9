"""The benchmark of ``esc_tpu_torch`` on NVIDIA H100 cards.

    python3 portbench/run.py --workload esc-base.serve-batch --seed 7 \
        --seconds 20 --trace 0

runs one cell of ``BENCHMARK.json`` on the cards of this machine and
prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``, then ``checks``, each number compared with its limit. The
same numbers close standard error.

Everything is found by name: the cell's configuration in
``portbench/configs/<config>.json``, its traffic in
``portbench/traffic/<traffic>.json``, whose ``driver`` names
``portbench/drivers/<driver>.py``, its limits in
``portbench/limits/<workload>.json`` and each metric's reader in
``portbench/metrics/<metric>.py`` (or, for a ``<name>.<cells>`` with no
file of its own, ``portbench/metrics/<name>.py``). A new cell, traffic mix
or metric is a new file and a new entry of ``BENCHMARK.json``.

Without CUDA, or with fewer cards than the cell asks for, it exits 2 and
prints no result; it exits 3 if JAX, flax, optax or ``esc_tpu`` were
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the JAX side of the repository, compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "esc_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_bench() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or traced its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read`` of ``metrics/<name>.py``, or where there is no such
    file, of the reader named by the part before the first dot: one
    ``device_idle_pct.py`` serves ``device_idle_pct.serve`` and
    ``device_idle_pct.train``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        path = BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def execute(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, device: str = "cuda", config: dict = None,
            traffic: dict = None):
    """Run one cell; returns the :class:`portbench.harness.Run` and the
    metrics by name. ``config`` and ``traffic`` replace the cell's files
    (the CPU tests run tiny ones, and a mix that is not a cell yet)."""
    from portbench.harness import Run, load_json

    if config is None or traffic is None:
        cell = cell_of(bench, workload)
        config = config or load_json(BENCH_DIR / "configs"
                                     / f"{cell['config']}.json")
        traffic = traffic or load_json(BENCH_DIR / "traffic"
                                       / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    run = Run(workload=workload, config=config, traffic=traffic,
              seed=seed, seconds=seconds, trace=trace, device=device,
              t_start=T_START)
    driver.run(run)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return run, metrics


def result_line(run, metrics: dict, device: dict) -> dict:
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.trace and run.traces:
        t = run.traces[0]
        out["breakdown"] = {"device_ops": t.top_ops(),
                            "idle_gaps": t.idle_gaps()}
    out["checks"] = run.checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_bench()
    chips = cell_of(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"portbench: needs {chips} CUDA device(s), found {found}; no "
              "result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)        # load from one host thread
    run, metrics = execute(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.device_count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace and run.traces:
        t = run.traces[0]
        device.update(busy_s=t.busy_s(), window_s=t.window_s)
    for line in run.notes:
        print(line, file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result_line(run, metrics, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
