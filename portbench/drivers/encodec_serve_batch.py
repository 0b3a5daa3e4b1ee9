"""Batch serving of EnCodec 24 kHz: a closed loop of host batches through
``stream_map``.

Traffic keys: ``batch`` clips of ``length`` samples at 24 kHz a batch (the
hop divides the length), coded at ``bandwidth`` kbps (24: all 32 stages),
``depth`` batches in flight, cycling over ``pool`` distinct batches made
from the seed; ``check`` batches, drawn from the seed among those served,
are judged after the window; ``trace_units`` batches run under the
profiler in a traced run. The configuration's ``Encodec`` section holds
the program's keys, its ``SEANet`` section the rest of the release's,
which the reference takes too.

Entry: ``esc_tpu_torch.serving.stream_map(fn, batches, depth,
device=codec.device)`` with ``fn(x)``: ``codes = Encodec.encode_codes(x)``
at the target bandwidth, then ``Encodec.decode_codes(codes)``; each batch
a numpy array whose codes and waveform come back to the host, as the DAC's
cell serves the DAC. The program and the plain reference
(``portbench/reference/encodec.py``, whose LSTM is its own loop over
time) get the same weights, drawn from the seed by the reference's
``init_weights``. The comparison is ``drivers/common.py::check_serving``'s,
unchanged: ``code_gap`` relative to the nearest codeword's squared
distance, ``wave_gap`` over the widest sample. One unit is one batch.

A program whose ``Encodec`` has no ``encode_codes`` cannot serve the cell:
the run stops at once with a message and exit code 1.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.drivers.common import (card_line, check_serving, free_device,
                                      peak_memory, sync)
from portbench.harness import reservoir
from portbench.reference import encodec as ref_encodec
from portbench.reference.weights import seeded_generator
from portbench.reference.work import model_flops
from portbench.signals import speech_like
from portbench.trace import traced, unit


def encodec_pair(run, gen: torch.Generator):
    """(reference EnCodec on the CPU, the program's ``Encodec`` at the
    traffic's bandwidth on the device), with the same weights drawn from
    ``gen``."""
    from esc_tpu_torch.baselines.encodec import Encodec

    cfg = run.config
    with torch.device(run.device):
        ref = ref_encodec.Encodec(**cfg["Encodec"], **cfg["SEANet"])
    ref_encodec.init_weights(ref, gen)
    model = Encodec(bandwidth=run.traffic["bandwidth"], device=run.device,
                    **cfg["Encodec"])
    model.load_state_dict(ref.state_dict())
    return ref.cpu(), model


def run(run) -> None:
    from esc_tpu_torch.baselines.encodec import Encodec
    from esc_tpu_torch.serving import stream_map

    if not hasattr(Encodec, "encode_codes"):
        raise SystemExit("this program's Encodec has no encode_codes / "
                         "decode_codes to serve through stream_map")
    tr, dev, cfg = run.traffic, run.device, run.config["Encodec"]
    B, L, depth = tr["batch"], tr["length"], tr["depth"]
    if dev != "cpu":
        run.note(card_line())
    gen = seeded_generator(run.seed, dev)
    ref, codec = encodec_pair(run, gen)
    hop = codec.module.hop_length
    if L % hop:
        raise ValueError(f"length {L} is no multiple of the hop {hop}")
    pool = [speech_like(gen, B, L, dev).cpu().numpy()
            for _ in range(tr["pool"])]

    def roundtrip(x):
        codes = codec.encode_codes(x)
        return codes, codec.decode_codes(codes)

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
        return stream_map(roundtrip, feed(), depth=depth, device=codec.device)

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

    n_q = codec.n_q
    del codec
    free_device(dev)
    codes = np.stack([c for _, c, _ in kept])          # (check, B, n_q, T)
    distinct = [len(np.unique(codes[:, :, q])) for q in range(n_q)]
    run.note(f"distinct codes a stage over the {len(kept)} checked batches "
             f"(stages 0-{n_q - 1}): {distinct}")
    check_serving(run, ref, [(pool[k % len(pool)], c, w) for k, c, w in kept])
    if run.trace:
        ref.to(dev)
        x = torch.as_tensor(pool[0], device=dev)
        run.unit_flops = model_flops(lambda: ref.decode(ref.encode(x, n_q)))
        ref.cpu()
