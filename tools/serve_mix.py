"""Single-request serving of ESC-Base under mixes whose call keys repeat
more or less: latency per request, the stage graphs' captures and replays
(``esc_tpu_torch/utils/graphs.py``) and peak device memory.

    python tools/serve_mix.py [--seconds 20] [--seed 0] [--out FILE]

A closed loop of one client, as portbench's serve-single cell: ``encode``
then ``decode`` of one utterance, codes and waveform brought to the host.
Each mix runs on a codec of its own (ESC-Base, weights drawn from the
seed), first a set-up, then ``--seconds`` of measured requests:

- ``serve-single``: portbench's 4 lengths x 6 streams, set-up as that
  cell's (every pair once, then 4 blocks of the 24 pairs);
- ``grid``: every grid-exact length of 1-4 s (150), drawn uniformly, at 6
  streams: utterances of any length padded to the grid; set-up 600
  requests;
- ``distinct``: each request a (length, streams) pair of those 150
  lengths x 1-6 streams that was not sent before: no call key repeats;
  set-up 24 requests of pairs left out of the window.

A request's kind is that of the costlier of its two calls: ``capture``,
``eager`` or ``replay``. On a tree without stage graphs every request is
eager. Prints one JSON line a mix, and writes them to ``--out``.
"""

import argparse
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from esc_tpu_torch.models import make_model  # noqa: E402
from portbench.signals import speech_like  # noqa: E402

GRID = [320 * k - 80 for k in range(50, 200)]        # 15,920-63,600 samples
SINGLE = json.loads((REPO / "portbench/traffic/serve-single.json")
                    .read_text())


def counters():
    """A dict of the stage graphs' captures and replays, kept up to date
    while the codecs run, or None on a tree without stage graphs."""
    try:
        from esc_tpu_torch.utils import graphs
    except ImportError:
        return None
    count = {"capture": 0, "replay": 0}
    for kind in count:
        def counted(chain, *args, _real=getattr(graphs._Chain, kind),
                    _kind=kind):
            out = _real(chain, *args)
            count[_kind] += 1
            return out
        setattr(graphs._Chain, kind, counted)
    return count


def requests(mix: str, rng: np.random.Generator):
    """(set-up requests, an endless iterator of measured requests), each
    a (length, streams) pair."""
    if mix == "serve-single":
        pairs = list(itertools.product(SINGLE["lengths"], SINGLE["streams"]))

        def blocks():
            while True:
                for j in rng.permutation(len(pairs)):
                    yield pairs[j]
        warm = pairs + list(itertools.islice(
            blocks(), SINGLE["warm_blocks"] * len(pairs)))
        return warm, blocks()
    if mix == "grid":
        def draws():
            while True:
                yield int(GRID[rng.integers(len(GRID))]), 6
        return list(itertools.islice(draws(), 600)), draws()
    pairs = [(n, s) for n in GRID for s in range(1, 7)]
    order = [pairs[j] for j in rng.permutation(len(pairs))]
    return order[:24], iter(order[24:])


def run_mix(mix: str, seconds: float, seed: int, count) -> dict:
    dev = torch.device("cuda")
    cfg = json.loads((REPO / "portbench/configs/esc-base.json")
                     .read_text())["model"]
    model = make_model(dict(cfg, backbone="transformer"), "csvq+swinT",
                       seed=seed, device=dev)
    gen = torch.Generator().manual_seed(seed)
    pool = {n: speech_like(gen, 2, n, "cpu").numpy() for n in GRID
            + SINGLE["lengths"]}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(seed)

    def serve(i, n, s):
        before = dict(count) if count is not None else None
        start = time.perf_counter()
        codes, fs = model.encode(pool[n][i % 2][None], s)
        wave = model.decode(codes, fs)
        codes.cpu(), wave.cpu()
        ms = 1e3 * (time.perf_counter() - start)
        if count is None:
            return ms, "eager"
        captures = count["capture"] - before["capture"]
        replays = count["replay"] - before["replay"]
        kind = ("capture" if captures else
                "replay" if replays == 2 else "eager")
        return ms, kind

    warm, stream = requests(mix, rng)
    setup = [serve(i, n, s) for i, (n, s) in enumerate(warm)]
    torch.cuda.synchronize()
    window, t0 = [], time.perf_counter()
    for i, (n, s) in enumerate(stream):
        if time.perf_counter() - t0 >= seconds:
            break
        window.append(serve(i, n, s))
    lat = sorted(ms for ms, _ in window)
    q = statistics.quantiles(lat, n=100)
    by_kind = {}
    for ms, kind in setup + window:
        by_kind.setdefault(kind, []).append(ms)
    sg = model.__dict__.get("_stage_graphs")
    key_us = None
    if sg is not None:
        start = time.perf_counter()
        for _ in range(1000):
            sg._weights_key()
        key_us = (time.perf_counter() - start) * 1e3
    out = {
        "mix": mix, "requests": len(window), "setup_requests": len(setup),
        "p50_ms": q[49], "p95_ms": q[94], "p99_ms": q[98],
        "max_ms": lat[-1], "mean_ms": statistics.fmean(lat),
        "window_kinds": {k: sum(1 for _, kd in window if kd == k)
                         for k in ("eager", "capture", "replay")},
        "mean_ms_by_kind": {k: statistics.fmean(v)
                            for k, v in sorted(by_kind.items())},
        "count_by_kind": {k: len(v) for k, v in sorted(by_kind.items())},
        "chains": None if sg is None else len(sg.chains),
        "weights_key_us": key_us,
        "peak_over_weights_gb": (torch.cuda.max_memory_allocated() - base)
        / 1e9,
        "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    del model, sg
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mixes", default="serve-single,grid,distinct")
    ap.add_argument("--out")
    args = ap.parse_args()
    count = counters()
    lines = []
    for mix in args.mixes.split(","):
        line = json.dumps(run_mix(mix, args.seconds, args.seed, count))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
