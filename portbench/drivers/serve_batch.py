"""Batch serving: a closed loop of host batches through ``stream_roundtrip``.

Traffic keys: ``batch`` clips of ``length`` samples a batch, at
``num_streams``, ``depth`` batches in flight, cycling over ``pool``
distinct batches made from the seed; ``check`` batches, drawn from the
seed among those served, are judged after the window; ``trace_units``
batches run under the profiler in a traced run.

Entry: ``esc_tpu_torch.serving.stream_roundtrip(model, batches,
num_streams, depth)``, each batch a numpy array that comes back as codes and
a waveform on the host. One unit is one batch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.drivers.common import (card_line, check_serving, codec_pair,
                                      free_device, peak_memory, sync)
from portbench.harness import reservoir
from portbench.reference.weights import seeded_generator
from portbench.reference.work import model_flops
from portbench.signals import speech_like
from portbench.trace import span, traced, unit

SR = 16000


def run(run) -> None:
    from esc_tpu_torch.serving import stream_roundtrip

    tr, dev = run.traffic, run.device
    B, L, ns = tr["batch"], tr["length"], tr["num_streams"]
    depth = tr["depth"]
    if dev != "cpu":
        run.note(card_line())
    gen = seeded_generator(run.seed, dev)
    ref, model = codec_pair(run, gen)
    pool = [speech_like(gen, B, L, dev).cpu().numpy()
            for _ in range(tr["pool"])]

    def serve(count=None, seconds=None):
        """(codes, waveform) of each batch of a closed loop over the pool:
        ``count`` batches, or as many as start within ``seconds``."""
        def feed():
            i = 0
            while (i < count if seconds is None
                   else time.perf_counter() - t0 < seconds):
                yield pool[i % len(pool)]
                i += 1
        t0 = time.perf_counter()
        return stream_roundtrip(model, feed(), num_streams=ns, depth=depth)

    for _ in serve(count=depth + 1):            # builds and warms up
        pass
    sync(dev)
    run.setup_done()

    rng = np.random.default_rng(run.seed)
    kept: list = []
    t0 = time.perf_counter()
    for k, (codes, wave) in enumerate(serve(seconds=run.seconds)):
        run.units.append({"audio_s": B * L / SR})
        reservoir(rng, kept, (k, codes, wave), k + 1, tr["check"])
    run.window_s = time.perf_counter() - t0
    run.attempted = len(run.units)
    run.memory_peak_bytes = peak_memory(dev)

    if run.trace:
        model.encode = span("esc.encode", model.encode)
        model.decode = span("esc.decode", model.decode)
        with traced(run.traces), unit():     # one unit span: pipelined
            for _ in serve(count=tr["trace_units"]):
                pass
        run.traced_units = tr["trace_units"]

    del model
    free_device(dev)
    check_serving(run, ref, [(pool[k % len(pool)], c, w) for k, c, w in kept])
    if run.trace:
        ref.to(dev)
        x = torch.as_tensor(pool[0], device=dev)
        run.unit_flops = model_flops(
            lambda: ref.decode(*ref.encode(x, ns)))
        ref.cpu()
