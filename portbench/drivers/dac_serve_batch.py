"""Batch serving of the DAC: a closed loop of host batches through
``stream_map``.

Traffic keys: ``batch`` clips of ``length`` samples a batch (the hop
divides the length), the codes of the first ``n_quantizers`` stages sent,
``depth`` batches in flight, cycling over ``pool`` distinct batches made
from the seed; ``check`` batches, drawn from the seed among those served,
are judged after the window; ``trace_units`` batches run under the
profiler in a traced run. The configuration's ``DAC`` section holds the
codec's keys.

Entry: ``esc_tpu_torch.serving.stream_map(fn, batches, depth,
device=dac.device)`` with ``fn(x)``: ``codes = DAC.encode_codes(x)`` (the
first ``n_quantizers`` stages kept, as ``DAC.compress`` keeps them), then
``DAC.decode_codes(codes)``; each batch a numpy array whose codes and
waveform come back to the host, as ``stream_roundtrip`` serves ESC. The
program and the plain reference (``portbench/reference/dac.py``) get the
same weights: ``fill`` from the seed, then every snake's alpha 1. One unit
is one batch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.drivers.common import (card_line, check_serving, free_device,
                                      peak_memory, sync)
from portbench.harness import reservoir
from portbench.reference import dac as ref_dac
from portbench.reference.weights import fill, seeded_generator
from portbench.reference.work import model_flops
from portbench.signals import speech_like
from portbench.trace import traced, unit


def dac_pair(run, gen: torch.Generator):
    """(reference DAC on the CPU, the program's ``DAC`` on the device),
    with the same weights drawn from ``gen``."""
    from esc_tpu_torch.baselines.dac import DAC

    cfg = run.config["DAC"]
    with torch.device(run.device):
        ref = ref_dac.DAC(**cfg)
    fill(ref, gen)
    ref_dac.snake_alphas_to_one(ref)
    model = DAC(device=run.device, **cfg)
    model.load_state_dict(ref.state_dict())
    return ref.cpu(), model


def run(run) -> None:
    from esc_tpu_torch.serving import stream_map

    tr, dev, cfg = run.traffic, run.device, run.config["DAC"]
    B, L, nq, depth = tr["batch"], tr["length"], tr["n_quantizers"], \
        tr["depth"]
    if dev != "cpu":
        run.note(card_line())
    gen = seeded_generator(run.seed, dev)
    ref, dac = dac_pair(run, gen)
    if L % dac.hop_length or not 1 <= nq <= cfg["n_codebooks"]:
        raise ValueError(f"length {L} is no multiple of the hop "
                         f"{dac.hop_length}, or {nq} stages of "
                         f"{cfg['n_codebooks']}")
    pool = [speech_like(gen, B, L, dev).cpu().numpy()
            for _ in range(tr["pool"])]

    def roundtrip(x):
        codes = dac.encode_codes(x)
        if nq < cfg["n_codebooks"]:
            codes = codes[:, :nq]
        return codes, dac.decode_codes(codes)

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
        return stream_map(roundtrip, feed(), depth=depth, device=dac.device)

    for _ in serve(count=depth + 1):            # builds and warms up
        pass
    sync(dev)
    run.setup_done()

    rng = np.random.default_rng(run.seed)
    kept: list = []
    t0 = time.perf_counter()
    for k, (codes, wave) in enumerate(serve(seconds=run.seconds)):
        run.units.append({"audio_s": B * L / cfg["sample_rate"]})
        reservoir(rng, kept, (k, codes, wave), k + 1, tr["check"])
    run.window_s = time.perf_counter() - t0
    run.attempted = len(run.units)
    run.memory_peak_bytes = peak_memory(dev)

    if run.trace:
        with traced(run.traces), unit():     # one unit span: pipelined
            for _ in serve(count=tr["trace_units"]):
                pass
        run.traced_units = tr["trace_units"]

    del dac
    free_device(dev)
    check_serving(run, ref, [(pool[k % len(pool)], c, w) for k, c, w in kept])
    if run.trace:
        ref.to(dev)
        x = torch.as_tensor(pool[0], device=dev)
        run.unit_flops = model_flops(lambda: ref.decode(ref.encode(x)))
        ref.cpu()
