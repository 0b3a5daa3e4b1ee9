"""Single requests: a closed loop of one client, one utterance a request.

Traffic keys: ``lengths`` (samples, each grid-exact), ``streams`` (the
stream counts), ``per_length`` distinct utterances of each length made from
the seed; the requests come in blocks that hold every (length, streams)
pair once, each block in an order drawn from the seed, so every seed sends
the same mix. Set-up serves each pair once, then ``warm_blocks`` blocks, so
that the window starts in a steady state. ``check_per_length`` requests of
each length, drawn from the seed among those served, are judged after the
window; ``trace_units`` requests run under the profiler in a traced run.

Entry: ``ESC.encode`` then ``ESC.decode``, the compress CLI's calls, on a
numpy array of one utterance; a request is timed from that call to both
its codes and its waveform on the host. One unit is one request.
"""

from __future__ import annotations

import itertools
import time

import numpy as np

from portbench.drivers.common import (card_line, check_serving, codec_pair,
                                      free_device, peak_memory, sync)
from portbench.harness import reservoir
from portbench.reference.weights import seeded_generator
from portbench.signals import speech_like
from portbench.trace import span, traced, unit


def run(run) -> None:
    tr, dev = run.traffic, run.device
    if dev != "cpu":
        run.note(card_line())
    gen = seeded_generator(run.seed, dev)
    ref, model = codec_pair(run, gen)
    pools = {n: speech_like(gen, tr["per_length"], n, dev).cpu().numpy()
             for n in tr["lengths"]}
    shapes = list(itertools.product(tr["lengths"], tr["streams"]))
    order, draw = (np.random.default_rng([run.seed, k]) for k in (0, 1))

    def requests():
        """(index, length, streams, utterance), block after block."""
        i = 0
        while True:
            for j in order.permutation(len(shapes)):
                n, s = shapes[j]
                yield i, n, s, pools[n][i % tr["per_length"]][None]
                i += 1

    def serve(x, s):
        codes, fs = model.encode(x, s)
        wave = model.decode(codes, fs)
        return codes.cpu().numpy(), wave.cpu().numpy()

    for n, s in shapes:                         # builds and warms up
        serve(pools[n][:1], s)
    warm = requests()                           # steady state
    for _ in range(tr["warm_blocks"] * len(shapes)):
        _, _, s, x = next(warm)
        serve(x, s)
    sync(dev)
    run.setup_done()

    kept = {n: [] for n in tr["lengths"]}
    seen = dict.fromkeys(tr["lengths"], 0)
    stream = requests()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        i, n, s, x = next(stream)
        start = time.perf_counter()
        codes, wave = serve(x, s)
        end = time.perf_counter()
        run.units.append({"latency_s": end - start, "audio_s": n / 16000})
        seen[n] += 1
        reservoir(draw, kept[n], (x, codes, wave), seen[n],
                  tr["check_per_length"])
    run.window_s = time.perf_counter() - t0
    run.attempted = len(run.units)
    run.memory_peak_bytes = peak_memory(dev)

    if run.trace:
        model.encode = span("esc.encode", model.encode)
        model.decode = span("esc.decode", model.decode)
        with traced(run.traces):
            for _ in range(tr["trace_units"]):
                _, _, s, x = next(stream)
                with unit():
                    serve(x, s)
        run.traced_units = tr["trace_units"]

    del model
    free_device(dev)
    check_serving(run, ref, [k for n in tr["lengths"] for k in kept[n]])
