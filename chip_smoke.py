#!/usr/bin/env python3
"""Drive the PyTorch port (esc_tpu_torch) of ESC on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending with one line that carries its seconds:

0. card     the card's name and power limit (nvidia-smi), torch and CUDA
1. build    nvcc builds esc_tpu_torch/csrc/*.cu for sm_90a (first use), one
            process per source; the host compiler builds the range coder
2. kernels  each CUDA kernel against its plain PyTorch version, on the
            card, at the shapes ESC-Base serving gives it (4 clips of 3 s;
            the LayerNorm kernel at every call of one roundtrip, at ragged
            row counts and on a misaligned input;
            the 25 s file of phase 3c whole and in its chunks; the DAC's
            1024 x 8 codebooks of phase 11) and at widths
            beyond them (heads split into groups, codebooks in K-tiles);
            call time (CUDA events around the Python calls,
            host work included) of the kernel, its plain version and one
            library call
3. main     ESC-Base at full width (random weights from seed 0): encode ->
            decode and roundtrip at num_streams 1, 3 and 6 and the compress
            CLI on one generated wav, with the kernels' launch counts; then
            the same model on the plain versions, codes and waveforms
            compared; the real-time factor
3b. bf16    the same ESC-Base in the bf16 serving mode at num_streams 1, 3
            and 6: codes against fp32's, the real-time factor beside fp32's
3c. cli     python -m esc_tpu_torch.cli.compress as a subprocess on a 25 s
            wav, with configs/9kbps_esc_base.yaml and a model.pth: once
            plain, once with --dtype bfloat16 --chunk_seconds 10; every
            .escb unpacks to its .npy codes; the whole-file and the chunked
            fp32 paths against the plain versions
3d. serving stream_roundtrip over 8 batches at depth 2 against the serial
            loop
5. eval     python -m esc_tpu_torch.cli.test as a subprocess on 4 generated
            clips of 2-4 s with configs/9kbps_esc_base.yaml and a model.pth
            (perf_stats.json in the JAX package's layout, every value
            finite), then eval_epoch in this process over num_streams 1-6:
            launch counts as predicted, Mel distance and SI-SDR against the
            same sweep on the plain versions, codes of the eval forward
            against the plain model's; eval seconds per audio second
6. train    python -m esc_tpu_torch.cli.train as a subprocess for 4 steps
            of ESC-Base (one freeze step, the renewal, two evaluations):
            finite logged losses, pretrained/best/checkpoint.ckpt that load,
            checkpoint.ckpt's optimizer state in optax's layout (esc_tpu's
            chain) and the CLI's --resume taking it on the card, count and
            moments bit for bit; then 20 steps in this process on one fixed
            batch: the loss
            falls, no kernel launches, and both kernels launch in the
            evaluation; steps per second and peak memory; then, from one
            copy of the state, make_multi_step over K = 10 batches
            (num_streams by quantization_dropout from the seed) against
            the same 10 train_steps one by one, and K = 2 with the freeze:
            losses, parameters, both moments and the count bit for bit, no
            kernel launch, steps per second of both in turns
7. adv      python -m esc_tpu_torch.cli.train --adv_training as a
            subprocess for 4 steps of configs/9kbps_esc_base_adv.yaml (one
            freeze step, the renewal, two evaluations): finite logged
            losses, the GAN terms zero in the freeze step and not after,
            pretrained/best/checkpoint.ckpt that load, the discriminator in
            checkpoint.ckpt; a second subprocess with --pretrain_ckp on it
            (generator lr/10, one evaluation before the first step); then
            10 adversarial steps in this process at the config's batch of
            9 x 3 s: no kernel launches, both kernels launch in the
            evaluation; the discriminator's feature maps on the card
            against the same module on the CPU; steps per second and peak
            memory; one step run twice from one state with cuDNN's default
            and with its deterministic algorithms (the weight arrays that
            differ), and steps per second of each, in turns
8. dp       the train CLI with --num_devices N, N the cards present, one
            NCCL rank per card, 3 steps of a downsized ESC with a small
            discriminator: at N = 1 its weights equal, bit for bit, those
            of a run without --num_devices; at N >= 2, N ranks at batch 2
            against one rank at batch 2N within the CPU test's bars (the
            losses as logged, to their 4 decimals)
9. ablation the three ablation codecs of configs/ablations/ (rvq+swinT,
            csvq+conv, rvq+conv) at full width with random weights from
            seed 0: roundtrips of 4 clips of 3 s at num_streams 1, 3 and 6
            with their launch counts as predicted, codes against the same
            model on the plain versions and the same codes decoded by both,
            the real-time factor; python -m esc_tpu_torch.cli.compress on
            rvq+conv (a model.pth, a .escb v2 that unpacks to the .npy);
            python -m esc_tpu_torch.cli.test on csvq+conv (the sweep over
            num_streams 1-6); python -m esc_tpu_torch.cli.train for 4 steps
            of rvq+swinT (finite losses, checkpoints that load), steps on
            one batch in this process (steps per second, peak memory, no
            kernel launch; both kernels in the evaluation), and the train
            CLI's refusal of the conv backbone; a rvq+conv .ckpt written
            with its BatchNorm statistics and read back, the same codes;
            the standalone ResidualVectorQuantize at esc_tpu's defaults
            (1,536 wide, 600 rows a search) at num_streams 1, 3 and 6:
            argmin launches num_streams per encode and 6 per eval forward,
            codes against the plain argmin, the same codes decoded card
            against CPU, encode call ms
10. multicard ESC-Base as published (configs/9kbps_esc_base.yaml, random
            weights from seed 0) over every visible card (Replicas):
            encode_chunked_dp / decode_chunked_dp of a 25 s file in 10 s
            chunks with 1 s margins, launches as predicted, codes against
            the same replicas on the plain versions, the same codes decoded
            by both; python -m esc_tpu_torch.cli.test --data_parallel on
            phase 5's clips and model against phase 5's perf_stats.json;
            ms per audio second, serial against the replicas
11. dac      the DAC of configs/dac/16khz_dns_9k.yml as published (74.34M
            parameters, random weights from seed 0): the eval forward of 4
            clips of 3 s and compress of a 10 s wav in 1 s windows, with
            the argmin's launches predicted, against the plain argmin;
            python -m esc_tpu_torch.baselines.dac encode and decode as
            subprocesses; DACTrainer with the config's discriminator for 4
            steps at batch 2 and a validation (finite losses, checkpoints
            that load, no kernel in a step, the argmin in the validation),
            steps per second by StepTimer tic/toc, peak memory; one trace()
            of a DAC roundtrip
12. encodec  EnCodec 24 kHz as published (encodec_24khz: 32 filters,
            ratios 8 5 4 2, dimension 128, a 2-layer SLSTM, 32 x 1024
            codebooks; 19.05M values, random weights from seed 0): the
            comparison wrapper Encodec(bandwidth=b) on 4 generated clips of
            3 s at 16 kHz, resampled in and out, at 1.5, 6 and 24 kbps, with
            no kernel launch; codes card against CPU on the same weights
            and the CPU's codes decoded on both; a release-format file
            ({"best_state": ...} with the EMA buffers) through
            load_torch_weights, the same codes; real-time factor, encode
            and decode ms, peak memory at 6 and 24 kbps
4. profile  a replayed roundtrip of phase 3's model at ns 6 (stage graphs,
            esc_tpu_torch/utils/graphs.py): every kernel launched as
            often as in the eager roundtrip, by the profiler's kernel
            records, no wrapper called, codes and waveform bit for bit;
            device time by kernel over one roundtrip, one training step and
            one adversarial step, each half of it apart (torch.profiler),
            the MRD spectrograms' device time; then each kernel's, its plain
            version's and the library call's device time at the shapes of
            phase 2, at those of the ablations' roundtrips and at those of
            the DAC's 10 s compress

Phases 5-12 run before phase 4: a profiler session slows the host's later
launches in the same process. Each path of phases 3-7 and 9-12 is driven
eagerly (no stage graph captured or replayed, :func:`eager_codecs`), with
the launch counts set to 0 just before it and read just after; every
kernel of the path must have run in it (in the training steps of phases
6, 7, 9 and 11 and in EnCodec, none may; in a conv codec's roundtrip and
in the DAC, the attention may not).

The second-to-last line is the kernels' JSON summary, the last
{"ok": true, "device": {...}}. Any failed check raises: the script then
exits non-zero and prints no result, as it does without a CUDA device.

    python3 chip_smoke.py --kernels-from CHECKOUT

runs phase 2's timing alone for the esc_tpu_torch of another checkout
(say a parent commit), for a comparison within one session.

    python3 chip_smoke.py --data-parallel

runs phase 8 alone, on every card of the host: the call to make on a
machine with several cards.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# ESC-Base, configs/9kbps_esc_base.yaml, with the per-scale codebook dims
# of the committed checkpoints (8 at every scale)
ESC_BASE = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[45, 72, 96, 144, 192, 384], max_streams=6, win_len=20,
    hop_len=5, sr=16000, patch_size=[3, 2], swin_heads=[3, 6, 12, 24, 24],
    swin_depth=2, window_size=4, mlp_ratio=4.0, overlap=2, group_size=3,
    codebook_size=1024, codebook_dims=[8] * 6, l2norm=True)
BATCH = 4
CLIP = 47920           # 3 s at 16 kHz after the eval set's 80-sample trim
STREAMS = (1, 3, 6)
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOP_PER_S = 67e12    # H100 SXM, CUDA cores (both kernels run there)
CODE_MISMATCH_MAX = 2e-3   # tests/test_ref_parity.py:111-122
WAVE_ATOL = 5e-4
ATTN_TOL = {torch.float32: (2e-5, 1e-5), torch.bfloat16: (5e-2, 5e-2)}
NEAR_TIE = 1e-5            # float64 gap of the two nearest codewords
# window counts that are no multiple of a grid or of the windows per tile
ATTN_RAGGED = [(1, 3, 15), (7, 6, 12), (301, 24, 16), (301, 3, 24)]
# widths beyond ESC-Base's: heads split into groups (one window of all
# heads over a block's shared memory, or heads wider than 32)
ATTN_WIDE = [(300, 24, 32), (300, 16, 64), (300, 8, 128), (7, 8, 128),
             (301, 5, 40), (50, 7, 128)]
# the LayerNorm kernel against F.layer_norm: the order of the row sums and
# rsqrt's last bits move a normalised value by a few units of its last
# place times sqrt(C) (tests/test_torch_port_cuda.py's LN_TOL)
LN_TOL = (1e-5, 1e-5)
# rows that are no multiple of a tile or of the rows a warp reduces at
# once, and a width beyond ESC's
LN_RAGGED = [(1, 45), (31, 90), (4801, 96), (257, 1000)]
# codebooks over a block's shared memory stream through it in K-tiles
ARGMIN_WIDE = [(600, 1024, 64), (600, 1024, 128), (600, 1024, 256),
               (4801, 4096, 8), (601, 1023, 65)]
# the shapes of the widths' timing (phase 4)
ATTN_WIDE_TIMED = (300, 16, 64)
ARGMIN_WIDE_TIMED = (600, 1024, 64)
BF16_AGREE_MIN = 0.8        # tests/test_bf16_mode.py's bar
PAIRS = 3                   # timed pairs of two variants, order alternating
CLI_SECONDS = 25
CLI_CHUNK_SECONDS = 10
STREAM_BATCHES, STREAM_DEPTH = 8, 2
# phase 5: clips of unequal length, one padded batch, the CLI's batch size
EVAL_SECONDS = (2.0, 2.6, 3.3, 4.0)
EVAL_BATCH = 4
# Mel distance and SI-SDR of the kernels' sweep against the plain one: the
# zero padding's codes are near ties (its residuals are almost nothing), so
# they may differ and reach a few frames into an utterance, which the
# untrained model's SI-SDR near -40 dB magnifies (the same bar as
# tests/test_torch_port_eval.py's between the frameworks)
EVAL_MEL_RTOL, EVAL_SISDR_RTOL = 1e-3, 1e-2
# phase 6: 2 s clips (grid-exact after the loader's 80-sample trim), one
# batch of 2 an epoch: epoch 1 is the freeze step
TRAIN_SAMPLES, TRAIN_BATCH, TRAIN_EPOCHS = 32000, 2, 4
FIXED_BATCH_STEPS, FIXED_BATCH_LR = 20, 3e-4
# make_multi_step against as many single steps, from one copy of the state
MULTI_STEPS = {False: 10, True: 2}        # K by the freeze flag
# phase 7: the adversarial config's own batch, 9 clips of 3 s
ADV_STEPS, ADV_CLIP = 10, 47920
ADV_TIMED_STEPS = 5        # steps per turn of the determinism timing
# the discriminator's feature maps, card against CPU: the bars of
# tests/test_torch_port_adv.py (rtol 2e-3, atol 2e-4)
FMAP_RTOL, FMAP_ATOL = 2e-3, 2e-4
# phase 8: the verify skill's tiny ESC and a small discriminator, 3 steps
DP_MODEL = dict(ESC_BASE, h_dims=[12, 12, 16, 16, 24, 32],
                swin_heads=[2, 2, 2, 2, 2], swin_depth=1, codebook_size=64)
DP_DISC = {"sample_rate": 16000, "rates": [], "periods": [2, 3],
           "fft_sizes": [512, 256], "bands": [[0.0, 0.25], [0.25, 1.0]]}
DP_SAMPLES, DP_EPOCHS = 8000, 3
ROOT = Path(__file__).resolve().parent
ESC_BASE_YAML = ROOT / "configs" / "9kbps_esc_base.yaml"  # as published
ESC_ADV_YAML = ROOT / "configs" / "9kbps_esc_base_adv.yaml"
# phase 9: the paper's ablations as published (codebook dims 8)
ABLATION_YAMLS = {name: ROOT / "configs" / "ablations" /
                  f"9kbps_{name.replace('+', '_')}.yaml"
                  for name in ("rvq+swinT", "csvq+conv", "rvq+conv")}
ABLATION_CLI_SECONDS = 10
# the standalone residual VQ at esc_tpu's defaults: 6 x 64 x overlap 4 =
# 1,536 wide, projected to 8, 6 codebooks of 1024 (one group of rvq+swinT's
# bottleneck is as wide: 6 x 384 x overlap 2 / 3 groups); 4 latents of 600
# frames give 600 rows a search, as that bottleneck has at 4 x 3 s
RVQ_BATCH, RVQ_FRAMES = 4, 600
ABLATION_STEPS = 10
# phase 10: ESC-Base as published, a 25 s file in 10 s chunks with 1 s
# margins over every visible card
DP_SECONDS, DP_CHUNK, DP_MARGIN = 25, 10.0, 1.0
# phase 11: the DAC as published; its forward on 4 clips of 3 s, compress
# of a 10 s file in 1 s windows, 4 adversarial training steps at batch 2
DAC_YAML = ROOT / "configs" / "dac" / "16khz_dns_9k.yml"
DAC_CLIPS, DAC_CLIP = 4, 48000
DAC_FILE_SECONDS, DAC_WIN = 10, 1.0
DAC_STEPS, DAC_TIMED_STEPS = 4, 4
DAC_TRAIN_BATCH, DAC_TRAIN_SAMPLES = 2, 32000
# phase 12: EnCodec 24 kHz as published (encodec_24khz), 4 clips of 3 s at
# 16 kHz resampled in and out, as the paper's comparison does; codes and
# waveforms card against CPU within the bars of phase 3
ENCODEC_BANDWIDTHS = (1.5, 6.0, 24.0)
ENCODEC_CLIPS, ENCODEC_SR, ENCODEC_SECONDS = 4, 16000, 3
ENCODEC_TIMED = (6.0, 24.0)


def phase(name: str, t0: float, msg: str = "") -> float:
    """Print the line that ends a phase, with its seconds; return now."""
    now = time.time()
    print(" ".join(filter(None, [f"[{name}]", msg, f"({now - t0:.2f} s)"])),
          flush=True)
    return now


def call_ms(fn, reps: int = 20) -> float:
    """Mean time of one ``fn()`` in ms as the caller pays it, host work
    included: CUDA events around ``reps`` back-to-back calls, after
    warm-up. Once a kernel takes less than its wrapper's host work, this
    measures the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _on_device(event) -> bool:
    return getattr(event, "device_type", None) is not None and \
        "CUDA" in str(event.device_type)


def queued_ms(fn, reps: int = 20) -> float:
    """Mean device time of one ``fn()`` in ms by CUDA events around
    ``reps`` calls queued behind a sleeping kernel, so that the host's
    launches overlap the sleep and the calls run back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms at H100 clocks
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str | None = None, reps: int = 20) -> float:
    """Mean device time of one ``fn()`` in ms: the durations of the CUDA
    kernels it launches, summed by ``torch.profiler`` over ``reps`` calls
    after warm-up. With ``kernel``, the mean over the launches of the
    kernels whose name holds it (a trace may drop one; one that kept fewer
    than half is taken again, twice at most). Where the traces lost the
    kernel three times, as happens now and then on the card's machine,
    :func:`queued_ms` times it instead, and says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if _on_device(e)]
        n = reps
        if kernel is not None:
            events = [e for e in events if kernel in e.key]
            n = sum(e.count for e in events)
            if not reps // 2 <= n <= reps:
                continue
        us = sum(e.self_device_time_total for e in events)
        if us > 0:
            return us / 1e3 / n
    print(f"  profiler traces lost {kernel or 'the device'} three times: "
          f"timed by events behind a queued sleep", flush=True)
    return queued_ms(fn, reps)


# per clock, the keys of (kernel, plain version, library call)
_KEYS = {"device": ("device_ms", "plain_ms", "library_ms"),
         "call": ("call_ms", "plain_call_ms", "library_call_ms")}


def clocked(clock: str, fn, kernel: str | None = None) -> float:
    """ms of one ``fn()`` by ``clock``: "device" (:func:`device_ms`) or
    "call" (:func:`call_ms`)."""
    return device_ms(fn, kernel) if clock == "device" else call_ms(fn)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------ the main path's calls
def main_path_calls(cfg: dict, batch: int, length: int, num_streams: int,
                    forward: bool = False):
    """The kernel calls of one ``roundtrip(x, num_streams)``, or with
    ``forward`` of one eval forward ``model(x, num_streams=...)`` (the
    encoder, then the decoder once, quantizing as it goes): a list of
    argmin shapes (N, K, d) and of attention shapes (G, nh, hd, masked)."""
    hop = int(cfg["hop_len"] * cfg["sr"] * 1e-3)
    ws, depth = cfg["window_size"], cfg["swin_depth"]
    H = cfg["in_freq"] // cfg["patch_size"][0]
    W = (length // hop + 1) // cfg["patch_size"][1]
    h, heads = cfg["h_dims"], cfg["swin_heads"]
    attn = []

    def layer(Hl, C, nh):
        G = batch * (-(-Hl // ws)) * (-(-W // ws))
        attn.extend((G, nh, C // nh, i % 2 == 1) for i in range(depth))

    enc_H = [H]
    for _ in range(len(h) - 1):
        enc_H.append((enc_H[-1] + 1) // 2)
    layer(enc_H[0], h[0], heads[0])                 # encoder pre_nn
    for i in range(len(h) - 1):                     # encoder blocks
        layer(enc_H[i], h[i], heads[i])
    dec_h, dec_heads, dec_H = h[::-1], heads[::-1], enc_H[::-1]
    for i in range(0 if forward else num_streams - 2):  # decoder.encode's
        layer(dec_H[i], dec_h[i], dec_heads[i])
    for i in range(len(h) - 1):                     # decoder.decode's blocks
        layer(dec_H[i], dec_h[i], dec_heads[i])
    layer(dec_H[-1], dec_h[-1], dec_heads[-1])      # post_nn
    n_rows = batch * W // cfg["overlap"]
    argmin = [(n_rows, cfg["codebook_size"], cfg["codebook_dims"][s])
              for s in range(num_streams) for _ in range(cfg["group_size"])]
    return argmin, attn


def layer_norm_calls(cfg: dict, batch: int, length: int, num_streams: int,
                     forward: bool = False) -> list:
    """The LayerNorm calls (rows, C) of the same pass as
    :func:`main_path_calls`: the patch embedding's, two in each Swin block,
    one in each patch merge (width 2C, H halved and rounded up) or split."""
    hop = int(cfg["hop_len"] * cfg["sr"] * 1e-3)
    depth = cfg["swin_depth"]
    H = cfg["in_freq"] // cfg["patch_size"][0]
    W = (length // hop + 1) // cfg["patch_size"][1]
    h = cfg["h_dims"]
    calls = []

    def layer(Hl, C, scale=None):
        calls.extend([(batch * Hl * W, C)] * (2 * depth))
        if scale == "down":
            calls.append((batch * ((Hl + 1) // 2) * W, 2 * C))
        elif scale == "up":
            calls.append((batch * Hl * W, C))

    enc_H = [H]
    for _ in range(len(h) - 1):
        enc_H.append((enc_H[-1] + 1) // 2)
    calls.append((batch * H * W, h[0]))             # patch embedding
    layer(enc_H[0], h[0])                           # encoder pre_nn
    for i in range(len(h) - 1):                     # encoder blocks
        layer(enc_H[i], h[i], "down")
    dec_h, dec_H = h[::-1], enc_H[::-1]
    for i in range(0 if forward else num_streams - 2):  # decoder.encode's
        layer(dec_H[i], dec_h[i], "up")
    for i in range(len(h) - 1):                     # decoder.decode's blocks
        layer(dec_H[i], dec_h[i], "up")
    layer(dec_H[-1], dec_h[-1])                     # post_nn
    return calls


def norm_launches(attn: list, depth: int, runs: int) -> int:
    """LayerNorm launches of a path of ``runs`` passes (encoder, then
    decoder) whose attention calls are ``attn``: two in each Swin block
    (one attention call each), one in each Swin layer that merges or splits
    (all but a pass's pre_nn and post_nn), one patch embedding a pass; none
    in a codec without Swin blocks."""
    if not attn:
        return 0
    return 2 * len(attn) + (len(attn) // depth - 2 * runs) + runs


def predicted(argmin: list, attn: list, runs: int,
              depth: int = ESC_BASE["swin_depth"]) -> dict:
    """Each kernel's launches on a path of ``runs`` passes with these
    argmin and attention calls."""
    return {"codebook_argmin": len(argmin), "window_attention": len(attn),
            "layer_norm": norm_launches(attn, depth, runs)}


def chunk_grid(cfg: dict, length: int, chunk_seconds: float,
               margin_seconds: float):
    """(samples per code frame, chunk, margin, code frames of a file of
    ``length`` samples): chunks and margins in code frames, both multiples
    of ``window_size // overlap``, as ``ESC._chunking`` and
    ``parallel/chunked.py::_grid`` round them."""
    hop = int(cfg["hop_len"] * cfg["sr"] * 1e-3)
    spc = hop * cfg["patch_size"][1] * cfg["overlap"]
    align = max(1, cfg["window_size"] // cfg["overlap"])
    chunk = max(align, int(chunk_seconds * cfg["sr"]) // spc // align * align)
    margin = max(align, -(-int(margin_seconds * cfg["sr"]) // spc)
                 // align * align)
    total = (length // hop + 1) // cfg["patch_size"][1] // cfg["overlap"]
    return spc, chunk, margin, total


def chunk_lengths(cfg: dict, length: int, chunk_seconds: float,
                  margin_seconds: float = 1.0) -> list:
    """Sample lengths of the segments ``ESC.encode_chunked`` and
    ``decode_chunked`` hand the model for a file of ``length`` samples
    (``esc_tpu_torch/models/codecs.py``, ``ESC._chunking``)."""
    spc, chunk, margin, total = chunk_grid(cfg, length, chunk_seconds,
                                           margin_seconds)
    if total <= chunk:
        return [length]
    return [(min(total, s + chunk + margin) - max(0, s - margin)) * spc
            for s in range(0, total, chunk)]


def cli_calls(cfg: dict):
    """The kernel calls of phase 3c's paths on its 25 s file at num_streams
    6, as :func:`main_path_calls` gives them: those of the whole file (the
    fp32 CLI) and those of all its chunks (the chunked path)."""
    L = CLI_SECONDS * cfg["sr"]
    argmin, attn = [], []
    for n in chunk_lengths(cfg, L, CLI_CHUNK_SECONDS):
        a, t = main_path_calls(cfg, 1, n, 6)
        argmin += a
        attn += t
    return main_path_calls(cfg, 1, L, 6), (argmin, attn)


def _count(calls):
    out = {}
    for c in calls:
        out[c] = out.get(c, 0) + 1
    return out


# ------------------------------------------------------------- phase 2
def check_argmin(kern, rng, dev, extra=()):
    """Exact codes but for near ties, at the shapes below and ``extra``;
    returns the largest distance error."""
    wrapper, plain = kern["codebook_argmin"]
    excused = checked = 0
    max_err = 0.0

    def normed(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    cases = [(600, 1024, 8)] + [(1200, 1024, d) for d in (6, 8, 12, 16, 32)]
    cases += [(N, K, d) for N in (1, 7, 4801) for K in (128, 1024)
              for d in range(6, 33)]
    cases += ARGMIN_WIDE + sorted(set(extra))
    for N, K, d in cases:
        z = torch.tensor(normed(rng.standard_normal((N, d))),
                         dtype=torch.float32, device=dev)
        cb = torch.tensor(normed(rng.standard_normal((K, d))),
                          dtype=torch.float32, device=dev)
        ours, ref = wrapper(z, cb), plain(z, cb)
        dist = torch.cdist(z.double(), cb.double()) ** 2
        two = dist.topk(2, largest=False).values
        tie = (two[:, 1] - two[:, 0]) <= NEAR_TIE
        diff = ours != ref
        if bool((diff & ~tie).any()):
            raise RuntimeError(f"codebook_argmin N={N} K={K} d={d}: "
                               f"{int((diff & ~tie).sum())} rows differ")
        rows = torch.arange(N, device=dev)
        err = (dist[rows, ours.long()] - dist[rows, ref.long()]).abs().max()
        max_err = max(max_err, float(err))
        excused += int(diff.sum())
        checked += N
    cb = torch.tensor(rng.standard_normal((1024, 8)), dtype=torch.float32,
                      device=dev)
    cb[11] = cb[3]
    cb[700] = cb[3]
    z = cb[[3, 11, 700, 5]].clone()
    dup = wrapper(z, cb).tolist()
    if dup != [3, 3, 3, 5] or plain(z, cb).tolist() != dup:
        raise RuntimeError(f"codebook_argmin duplicate rows gave {dup}")
    z = torch.randn(6, 8, device=dev)
    z[[0, 4]] = float("nan")
    nan = wrapper(z, cb)
    if not torch.equal(nan, plain(z, cb)) or nan[0] != 0 or nan[4] != 0:
        raise RuntimeError(f"codebook_argmin all-NaN rows gave {nan.tolist()}")
    print(f"  codebook_argmin: {checked} rows in {len(cases)} shapes (N 1 "
          f"to 4801, K 128 to 4096, d 6..32, K-tiled {ARGMIN_WIDE}, and "
          f"the other paths' {sorted(set(extra))}): "
          f"{excused} differ, all near ties (float64 gap <= {NEAR_TIE}); "
          f"duplicate rows -> {dup}; all-NaN rows -> 0; max |dist diff| "
          f"{max_err:.3g}", flush=True)
    return max_err


def attention_inputs(rng, dev, G, nh, hd, masked, dtype, batch=BATCH):
    """Random qkv and bias; the mask has one entry per window of a clip of
    ``batch`` clips, as the SW-MSA mask of the main path."""
    C, nW = nh * hd, (G // batch if G % batch == 0 else G)
    qkv = torch.tensor(rng.standard_normal((G, 16, 3 * C)),
                       dtype=torch.float32, device=dev).to(dtype)
    bias = torch.tensor(rng.standard_normal((nh, 16, 16)),
                        dtype=torch.float32, device=dev)
    mask = None
    if masked:
        mask = torch.tensor(np.where(rng.random((nW, 16, 16)) > 0.5, 0.0,
                                     -100.0), dtype=torch.float32, device=dev)
    return qkv, bias, mask


def check_attention(kern, rng, dev, shapes, batch=BATCH):
    wrapper, plain = kern["window_attention"]
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for G, nh, hd in shapes:
        for masked in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                qkv, bias, mask = attention_inputs(rng, dev, G, nh, hd,
                                                   masked, dtype, batch)
                ours = wrapper(qkv, bias, mask, nh, hd ** -0.5)
                ref = plain(qkv, bias, mask, nh, hd ** -0.5)
                atol, rtol = ATTN_TOL[dtype]
                torch.testing.assert_close(
                    ours, ref, atol=atol, rtol=rtol,
                    msg=lambda m: f"window_attention G={G} nh={nh} hd={hd} "
                                  f"masked={masked} {dtype}: {m}")
                max_err[dtype] = max(max_err[dtype],
                                     float((ours - ref).abs().max()))
    print(f"  window_attention: {len(shapes)} geometries ({shapes[0]} .. "
          f"{shapes[-1]}, batch {batch}) x masked/unmasked "
          f"x f32/bf16 agree; max abs err f32 "
          f"{max_err[torch.float32]:.3g} (atol 2e-5), bf16 "
          f"{max_err[torch.bfloat16]:.3g} (atol 5e-2)", flush=True)
    return max_err[torch.float32]


def check_layer_norm(kern, rng, dev, shapes):
    """The LayerNorm kernel against F.layer_norm at (rows, C) shapes, on a
    contiguous input and on one 4 bytes past a 16-byte boundary; rows of
    one value give the bias. Returns the largest difference."""
    wrapper, plain = kern["layer_norm"]
    worst = 0.0
    for rows, C in shapes:
        x = torch.randn(rows, C, device=dev) * 3 + 0.5
        w = torch.rand(C, device=dev) + 0.5
        b = torch.randn(C, device=dev)
        flat = torch.empty(rows * C + 1, device=dev)
        shifted = flat[1:].view(rows, C)
        shifted.copy_(x)
        want = plain(x, w, b, 1e-6)
        for got in (wrapper(x, w, b, 1e-6), wrapper(shifted, w, b, 1e-6)):
            torch.testing.assert_close(
                got, want, atol=LN_TOL[0], rtol=LN_TOL[1],
                msg=lambda m: f"layer_norm rows={rows} C={C}: {m}")
            worst = max(worst, float((got - want).abs().max()))
        flat = wrapper(torch.full((rows, C), 2.5, device=dev), w, b, 1e-6)
        if not torch.equal(flat, b.expand(rows, C)):
            raise RuntimeError(f"layer_norm rows={rows} C={C}: constant "
                               "rows do not give the bias")
    print(f"  layer_norm: {len(shapes)} shapes ({shapes[0]} .. "
          f"{shapes[-1]}), aligned and shifted inputs, max abs diff "
          f"{worst:.3g} (<= {LN_TOL[0]} + {LN_TOL[1]} |y|)", flush=True)
    return worst


def time_argmin(kern, rng, dev, calls, clock):
    """Times by ``clock`` of the kernel, its plain version and
    ``torch.cdist`` + ``argmin`` at each shape, summed over the calls of one
    roundtrip."""
    wrapper, plain = kern["codebook_argmin"]
    tot = dict.fromkeys(_KEYS[clock] + ("bytes", "flops"), 0.0)
    for (N, K, d), n in _count(calls).items():
        z = torch.nn.functional.normalize(torch.randn(N, d, device=dev), dim=1)
        cb = torch.nn.functional.normalize(torch.randn(K, d, device=dev),
                                           dim=1)
        times = (clocked(clock, lambda: wrapper(z, cb),
                         "codebook_argmin_kernel"),
                 clocked(clock, lambda: plain(z, cb)),
                 clocked(clock, lambda: torch.cdist(z, cb).argmin(1)))
        print(f"  codebook_argmin N={N} K={K} d={d} x{n}: {clock} ms: kernel "
              f"{times[0]:.4f}, plain {times[1]:.4f}, cdist+argmin "
              f"{times[2]:.4f}", flush=True)
        for key, t in zip(_KEYS[clock], times):
            tot[key] += n * t
        tot["bytes"] += n * 4 * (N * d + K * d + N)
        tot["flops"] += n * (2 * N * K * d + 3 * N * K)
    return tot


def time_attention(kern, rng, dev, calls, clock):
    """As :func:`time_argmin`, against ``scaled_dot_product_attention``
    with bias and mask as one float mask."""
    wrapper, plain = kern["window_attention"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tot = dict.fromkeys(_KEYS[clock] + ("bytes", "flops"), 0.0)
    for (G, nh, hd, masked), n in _count(calls).items():
        qkv, bias, mask = attention_inputs(rng, dev, G, nh, hd, masked,
                                           torch.float32)
        scale = hd ** -0.5
        q, k, v = qkv.reshape(G, 16, 3, nh, hd).permute(2, 0, 3, 1,
                                                        4).contiguous()
        full = bias[None].expand(G, nh, 16, 16)
        if mask is not None:
            nW = mask.shape[0]
            full = (full.reshape(G // nW, nW, nh, 16, 16)
                    + mask[None, :, None]).reshape(G, nh, 16, 16)
        full = full.contiguous()
        times = (clocked(clock, lambda: wrapper(qkv, bias, mask, nh, scale),
                         "window_attention_kernel"),
                 clocked(clock, lambda: plain(qkv, bias, mask, nh, scale)),
                 clocked(clock, lambda: sdpa(q, k, v, attn_mask=full,
                                             scale=scale)))
        C = nh * hd
        nbytes = 4 * (G * 16 * 4 * C + nh * 256
                      + (mask.shape[0] * 256 if masked else 0))
        print(f"  window_attention G={G} nh={nh} hd={hd} "
              f"{'masked' if masked else 'unmasked'} x{n}: {clock} ms: "
              f"kernel {times[0]:.4f} (bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}), plain {times[1]:.4f}, "
              f"sdpa {times[2]:.4f}", flush=True)
        for key, t in zip(_KEYS[clock], times):
            tot[key] += n * t
        tot["bytes"] += n * nbytes
        tot["flops"] += n * G * nh * (4 * 256 * hd + 5 * 256)
    return tot


def time_layer_norm(kern, rng, dev, calls, clock):
    """Times by ``clock`` of the kernel and of its plain version, which is
    PyTorch's own call (``F.layer_norm``, ATen's kernels), summed over
    ``calls`` (rows, C)."""
    wrapper, plain = kern["layer_norm"]
    keys = _KEYS[clock][:2]
    tot = dict.fromkeys(keys + ("bytes", "flops"), 0.0)
    for (rows, C), n in _count(calls).items():
        x = torch.randn(rows, C, device=dev)
        w = torch.rand(C, device=dev) + 0.5
        b = torch.randn(C, device=dev)
        times = (clocked(clock, lambda: wrapper(x, w, b, 1e-6),
                         "layer_norm_kernel"),
                 clocked(clock, lambda: plain(x, w, b, 1e-6)))
        nbytes = 4 * (2 * rows * C + 2 * C)
        print(f"  layer_norm rows={rows} C={C} x{n}: {clock} ms: kernel "
              f"{times[0]:.4f} (bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f}),"
              f" plain (F.layer_norm) {times[1]:.4f}", flush=True)
        for key, t in zip(keys, times):
            tot[key] += n * t
        tot["bytes"] += n * nbytes
        tot["flops"] += n * 8 * rows * C
    return tot


def time_wide(kern, rng, dev) -> dict:
    """Device ms of each kernel, its plain version and the library call at
    one width beyond ESC-Base's (heads in groups; a K-tiled codebook)."""
    out = {}
    G, nh, hd = ATTN_WIDE_TIMED
    wrapper, plain = kern["window_attention"]
    qkv, bias, mask = attention_inputs(rng, dev, G, nh, hd, True,
                                       torch.float32)
    scale = hd ** -0.5
    q, k, v = qkv.reshape(G, 16, 3, nh, hd).permute(2, 0, 3, 1,
                                                    4).contiguous()
    nW = mask.shape[0]
    full = (bias[None].expand(G, nh, 16, 16).reshape(G // nW, nW, nh, 16, 16)
            + mask[None, :, None]).reshape(G, nh, 16, 16).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes = 4 * (G * 16 * 4 * nh * hd + nh * 256 + nW * 256)
    flops = G * nh * (4 * 256 * hd + 5 * 256)
    out["window_attention"] = {
        "shape": f"G {G} nh {nh} hd {hd} masked f32",
        "ms": device_ms(lambda: wrapper(qkv, bias, mask, nh, scale),
                        "window_attention_grouped_kernel"),
        "plain_ms": device_ms(lambda: plain(qkv, bias, mask, nh, scale)),
        "library_ms": device_ms(lambda: sdpa(q, k, v, attn_mask=full,
                                             scale=scale)),
        "bound_ms": bound_ms(nbytes, flops)[0]}
    N, K, d = ARGMIN_WIDE_TIMED
    wrapper, plain = kern["codebook_argmin"]
    z = torch.nn.functional.normalize(torch.randn(N, d, device=dev), dim=1)
    cb = torch.nn.functional.normalize(torch.randn(K, d, device=dev), dim=1)
    out["codebook_argmin"] = {
        "shape": f"N {N} K {K} d {d} (K-tiled)",
        "ms": device_ms(lambda: wrapper(z, cb),
                        "codebook_argmin_tiled_kernel"),
        "plain_ms": device_ms(lambda: plain(z, cb)),
        "library_ms": device_ms(lambda: torch.cdist(z, cb).argmin(1)),
        "bound_ms": bound_ms(4 * (N * d + K * d + N),
                             2 * N * K * d + 3 * N * K)[0]}
    for name, tm in out.items():
        print(f"  {name} at {tm['shape']}: device ms: kernel {tm['ms']:.4f},"
              f" plain {tm['plain_ms']:.4f}, library {tm['library_ms']:.4f},"
              f" bound {tm['bound_ms']:.4f}", flush=True)
    return out


# ------------------------------------------------------------- phase 3
@contextlib.contextmanager
def eager_codecs():
    """Every codec call eager meanwhile: no stage graph is captured or
    replayed (``esc_tpu_torch/utils/graphs.py``), so that each kernel's
    launch count is its wrapper's own count of the path's launches."""
    from esc_tpu_torch.models.codecs import Codec
    graphs = Codec._graphs
    Codec._graphs = lambda self: None
    try:
        yield
    finally:
        Codec._graphs = graphs


def counted(kern, what: str, fn, ran: bool = True, expect=None):
    """Run ``fn`` eagerly with every launch count set to 0 just before and
    read just after; raise unless every kernel ran (with ``ran=False``:
    unless none did; with ``expect``, a set of names: unless those ran and
    no other did). Returns (result, counts)."""
    for wrapper, _ in kern.values():
        wrapper.launches = 0
    with eager_codecs():
        result = fn()
    torch.cuda.synchronize()
    counts = {name: wrapper.launches for name, (wrapper, _) in kern.items()}
    print(f"  launches on {what}: {counts}", flush=True)
    must = set(kern) if ran else set()
    if expect is not None:
        must = set(expect)
    if any(counts[k] == 0 for k in must):
        raise RuntimeError(f"a kernel never ran on {what}: {counts}")
    if any(counts[k] != 0 for k in set(kern) - must):
        raise RuntimeError(f"a kernel ran on {what}: {counts}")
    return result, counts


def real_time_factor(model, x, reps: int = 10) -> float:
    """Audio seconds per wall second of ``roundtrip`` at num_streams 6."""
    model.roundtrip(x, num_streams=6)
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        model.roundtrip(x, num_streams=6)
    torch.cuda.synchronize()
    return x.shape[0] * x.shape[1] / ESC_BASE["sr"] / (
        (time.perf_counter() - start) / reps)


def check_bf16(kern, model, x, out):
    """Phase 3b: ESC-Base in bf16 at num_streams 1, 3, 6 against the fp32
    codes of phase 3; the real-time factors side by side."""
    from esc_tpu_torch.models import make_model

    model16 = make_model(ESC_BASE, seed=SEED, device=x.device,
                         dtype=torch.bfloat16)
    if {p.dtype for p in model16.module.parameters()} != {torch.float32}:
        raise RuntimeError("bf16 mode: parameters are not float32")
    model16.roundtrip(x, num_streams=6)            # warm-up, not counted

    def drive():
        res = {}
        for ns in STREAMS:
            codes, fs = model16.encode(x, num_streams=ns)
            res[ns] = (codes, fs, model16.decode(codes, fs))
        return res

    res, _ = counted(kern, "the bf16 path", drive)
    agree = {}
    for ns, (codes, fs, recon) in res.items():
        agree[ns] = float((codes == out[ns][0]).float().mean())
        if tuple(fs) != tuple(out[ns][1]) or agree[ns] < BF16_AGREE_MIN:
            raise RuntimeError(f"bf16 ns={ns}: codes agree with fp32 on "
                               f"{agree[ns]:.2%} (< {BF16_AGREE_MIN:.0%})")
        if recon.dtype != torch.float32 or tuple(recon.shape) != tuple(
                x.shape) or not bool(torch.isfinite(recon).all()):
            raise RuntimeError(f"bf16 ns={ns}: waveform {recon.dtype} "
                               f"{tuple(recon.shape)} misshaped or not "
                               "finite")
    rtf = paired({"fp32": lambda: real_time_factor(model, x),
                  "bf16": lambda: real_time_factor(model16, x)})
    print(f"  bf16 codes agree with fp32: " + ", ".join(
        f"ns={ns} {a:.2%}" for ns, a in agree.items())
        + f" (>= {BF16_AGREE_MIN:.0%}); waveforms finite; real-time factor "
        f"bf16 {rtf['bf16']}, fp32 {rtf['fp32']} (pairs, order "
        "alternating)", flush=True)
    return agree, rtf


def paired(variants: dict) -> dict:
    """Each variant's number from :data:`PAIRS` rounds, the variants'
    order reversed every other round: name -> list of numbers."""
    out = {name: [] for name in variants}
    names = list(variants)
    for i in range(PAIRS):
        for name in (names if i % 2 == 0 else names[::-1]):
            out[name].append(round(variants[name](), 1))
    return out


def check_cli(kern, dev, rng, tmp, chunked_calls):
    """Phase 3c: the compress CLI as a user runs it, twice, on a model
    directory holding config.yaml and a model.pth; then the whole-file and
    the chunked fp32 paths against the plain versions, and the chunked
    bf16 path's launches against ``chunked_calls`` (:func:`cli_calls`)."""
    from esc_tpu_torch.cli.bitstream import unpack_codes
    from esc_tpu_torch.cli.compress import compress_file, load_model
    from esc_tpu_torch.io import load_wav, save_wav
    from esc_tpu_torch.models import make_model

    model_dir, cfg, weights = model_dir_with(Path(tmp), "esc_base", SEED + 1)
    wav = Path(tmp) / "long.wav"
    L = CLI_SECONDS * ESC_BASE["sr"]
    save_wav(str(wav), (0.1 * rng.standard_normal(L)).astype(np.float32))
    runs = {"fp32": [], "bf16 chunked": ["--dtype", "bfloat16",
                                         "--chunk_seconds",
                                         str(CLI_CHUNK_SECONDS)]}
    results = {}
    for label, extra in runs.items():
        out_dir = Path(tmp) / label.replace(" ", "_")
        said, wall = run_module("esc_tpu_torch.cli.compress", [
            "--input", str(wav), "--model_path", str(model_dir),
            "--save_path", str(out_dir), "--num_streams", "6", *extra])
        if "model.pth" not in said:
            raise RuntimeError(f"compress CLI ({label}) did not load "
                               f"model.pth:\n{said}")
        npy = np.load(out_dir / "encoded_9.0kbps_long.npy")
        blob = (out_dir / "encoded_9.0kbps_long.escb").read_bytes()
        codes, fs = unpack_codes(blob)
        recon = load_wav(str(out_dir / "decoded_9.0kbps_long.wav"))
        if not np.array_equal(codes, npy) or not np.isfinite(recon).all():
            raise RuntimeError(f"compress CLI ({label}): .escb codes differ "
                               "from the .npy, or the wav is not finite")
        results[label] = (codes, fs, recon, wall, blob[4])
        print(f"  compress CLI {label}: {wall:.2f} s for {CLI_SECONDS} s of "
              f"audio (process start included); .escb v{blob[4]} "
              f"{len(blob)} B unpacks to the .npy codes {codes.shape}, "
              f"feat_shape {fs}, wav {recon.shape}", flush=True)
    (c32, fs32, r32, _, _), (c16, fs16, r16, _, _) = results.values()
    agree = float((c32 == c16).mean())
    if fs32 != fs16 or r32.shape != r16.shape or agree < BF16_AGREE_MIN:
        raise RuntimeError(f"compress CLI: bf16 chunked codes agree with "
                           f"fp32 on {agree:.2%}, shapes {fs16} {r16.shape}")
    # the whole file and its chunks in fp32, on the kernels and on the
    # plain versions, in this process
    x = load_wav(str(wav))[None]
    model = load_model(str(model_dir), device=dev)
    plain = make_model(cfg["model"], cfg["model_name"], device=dev,
                       plain_ops=True)
    plain.load_state_dict(weights)
    whole_plain, _ = plain.encode(x, num_streams=6)
    mismatch = {"whole": float((whole_plain.cpu().numpy() != c32).mean())}
    chunk = model.encode_chunked(x, 6, CLI_CHUNK_SECONDS)
    chunk_plain, _ = plain.encode_chunked(x, 6, CLI_CHUNK_SECONDS)
    mismatch["chunked"] = float((chunk[0] != chunk_plain).float().mean())
    wave_err = float((model.decode_chunked(*chunk, CLI_CHUNK_SECONDS)
                      - plain.decode_chunked(*chunk, CLI_CHUNK_SECONDS))
                     .abs().max())
    if max(mismatch.values()) > CODE_MISMATCH_MAX or wave_err > WAVE_ATOL:
        raise RuntimeError(f"compress CLI: fp32 codes differ from the plain "
                           f"versions' on {mismatch}, or the chunked decode "
                           f"by {wave_err:.3g}")
    # the chunked bf16 path with the launch counts
    model16 = load_model(str(model_dir), device=dev, dtype="bfloat16")
    compress_file(model16, str(wav), str(Path(tmp) / "warm"), 6,
                  CLI_CHUNK_SECONDS)                # warm-up, not counted
    start = time.perf_counter()
    _, launches = counted(kern, "the chunked bf16 compress path",
                          lambda: compress_file(model16, str(wav),
                                                str(Path(tmp) / "in"), 6,
                                                CLI_CHUNK_SECONDS))
    per_s = (time.perf_counter() - start) / CLI_SECONDS
    want = predicted(*chunked_calls, runs=len(chunk_lengths(
        cfg["model"], L, CLI_CHUNK_SECONDS)))
    if launches != want:
        raise RuntimeError(f"chunked bf16 path: launches {launches}, the "
                           f"chunks phase 2 checked give {want}")
    print(f"  compress CLI: bf16 chunked codes agree with fp32 whole-file "
          f"on {agree:.2%}; fp32 codes against the plain versions: whole "
          f"file (CLI) {mismatch['whole']:.4%}, chunked "
          f"{mismatch['chunked']:.4%} differ (<= 0.2%), chunked decode of "
          f"the same codes within {wave_err:.3g} (<= 5e-4); chunked bf16 "
          f"launches {launches} as phase 2's chunk shapes predict; "
          f"compress_file in process {per_s * 1e3:.2f} ms per audio second",
          flush=True)
    return {"cli_s": {k: v[3] for k, v in results.items()},
            "bf16_chunked_ms_per_audio_s": per_s * 1e3,
            "agree": agree, "escb_version": {k: v[4] for k, v in
                                             results.items()}}


def check_serving(kern, model, rng):
    """Phase 3d: stream_roundtrip at depth 2 against the serial loop."""
    from esc_tpu_torch.serving import stream_roundtrip

    batches = [(0.1 * rng.standard_normal((BATCH, CLIP))).astype(np.float32)
               for _ in range(STREAM_BATCHES)]
    list(stream_roundtrip(model, batches[:2], depth=STREAM_DEPTH))  # warm-up
    outs, _ = counted(kern, "stream_roundtrip", lambda: list(
        stream_roundtrip(model, batches, num_streams=6,
                         depth=STREAM_DEPTH)))

    def serial_loop():
        out = []
        for x in batches:
            codes, _, recon = model.roundtrip(x, num_streams=6)
            out.append((codes.cpu().numpy(), recon.cpu().numpy()))
        return out

    for i, ((c, r), (sc, sr)) in enumerate(zip(outs, serial_loop())):
        if not (np.array_equal(c, sc) and np.array_equal(r, sr)):
            raise RuntimeError(f"stream_roundtrip batch {i} differs from the "
                               "serial loop")
    audio_s = STREAM_BATCHES * BATCH * CLIP / ESC_BASE["sr"]

    def rtf(fn):
        start = time.perf_counter()
        fn()
        return audio_s / (time.perf_counter() - start)

    rtfs = paired({
        "pipelined": lambda: rtf(lambda: list(stream_roundtrip(
            model, batches, num_streams=6, depth=STREAM_DEPTH))),
        "serial": lambda: rtf(serial_loop)})
    print(f"  stream_roundtrip: {STREAM_BATCHES} batches of {BATCH} x 3 s at "
          f"depth {STREAM_DEPTH} equal the serial loop; real-time factor "
          f"pipelined {rtfs['pipelined']}, serial {rtfs['serial']} (pairs, "
          "order alternating; results on the host)", flush=True)
    return rtfs


def drive_main_path(model, x, compress_file, tmp):
    """The main path as a user drives it; returns what it produced."""
    out = {}
    for ns in STREAMS:
        codes, fs = model.encode(x, num_streams=ns)
        recon = model.decode(codes, fs)
        rc, rfs, rrecon = model.roundtrip(x, num_streams=ns)
        out[ns] = (codes, fs, recon, rc, rrecon)
    cli = compress_file(model, os.path.join(tmp, "clip.wav"),
                        os.path.join(tmp, "out"), num_streams=6)
    torch.cuda.synchronize()
    return out, cli


# the kernels' names, as the profiler reports them, by wrapper
KERNEL_NAMES = {"codebook_argmin": "codebook_argmin",
                "window_attention": "window_attention",
                "layer_norm": "layer_norm_kernel"}


def check_replay(model, x, per_rt: dict) -> dict:
    """A replayed roundtrip of ``model`` at ns 6 (stage graphs): in a
    profiler window of its own, each kernel runs as often as an eager
    roundtrip launches it (``per_rt``), by the kernel records the profiler
    takes of the graphs' kernels; no wrapper is called; encode and decode
    each replay one chain; codes and waveform equal the eager ones bit
    for bit. Returns the kernel counts."""
    from torch.profiler import ProfilerActivity, profile

    from esc_tpu_torch.ops.kernels import KERNELS
    with eager_codecs():
        want = model.roundtrip(x, num_streams=6)
    for _ in range(2):              # a key's first call (or its capture)
        model.roundtrip(x, num_streams=6)
    chains = model._graphs().chains
    replays = {key: c.replays for key, c in chains.items()}
    before = {name: w.launches for name, (w, _) in KERNELS.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = model.roundtrip(x, num_streams=6)
        torch.cuda.synchronize()
    ran = {name: sum(e.count for e in prof.key_averages()
                     if _on_device(e) and sub in e.key and "at::" not in e.key)
           for name, sub in KERNEL_NAMES.items()}
    called = {name: w.launches - before[name]
              for name, (w, _) in KERNELS.items()}
    replayed = [c for key, c in chains.items()
                if c.replays != replays.get(key)]
    held = {name: sum(c.kernels.get(name, 0) for c in replayed)
            for name in KERNELS}
    print(f"  a replayed roundtrip at ns=6: kernels run {ran} (profiler), "
          f"wrappers called {called}, {len(replayed)} chains replayed, "
          f"holding {held}", flush=True)
    if ran != per_rt or any(called.values()) or held != per_rt:
        raise RuntimeError(f"a replayed roundtrip ran {ran}, wrappers "
                           f"called {called}, its chains hold {held}; an "
                           f"eager one launches {per_rt}")
    if len(replayed) != 2 or any(c.replays != replays.get(key, 0) + 1
                                 for key, c in chains.items()
                                 if c in replayed):
        raise RuntimeError("the roundtrip did not replay encode and decode "
                           "once each")
    if not (torch.equal(got[0], want[0]) and tuple(got[1]) == tuple(want[1])
            and torch.equal(got[2], want[2])):
        raise RuntimeError("a replayed roundtrip differs from the eager one")
    return ran


def check_main_path(model, plain_model, x, out, cli, tmp):
    from esc_tpu_torch.cli.bitstream import unpack_codes
    from esc_tpu_torch.io import load_wav

    L = x.shape[-1]
    for ns, (codes, fs, recon, rc, rrecon) in out.items():
        want = (BATCH, ns, ESC_BASE["group_size"],
                 fs[1] // ESC_BASE["overlap"])
        if tuple(codes.shape) != want or codes.dtype != torch.int32:
            raise RuntimeError(f"codes {tuple(codes.shape)} {codes.dtype}, "
                               f"expected {want} int32")
        if not (torch.equal(codes, rc) and torch.equal(recon, rrecon)):
            raise RuntimeError(f"ns={ns}: roundtrip differs from "
                               "encode + decode")
        if tuple(recon.shape) != (BATCH, L) or not bool(
                torch.isfinite(recon).all()):
            raise RuntimeError(f"ns={ns}: waveform {tuple(recon.shape)} "
                               "not finite or misshaped")
        if int(codes.min()) < 0 or \
                int(codes.max()) >= ESC_BASE["codebook_size"]:
            raise RuntimeError(f"ns={ns}: codes out of range")
        pcodes, pfs = plain_model.encode(x, num_streams=ns)
        mismatch = float((pcodes != codes).float().mean())
        if mismatch > CODE_MISMATCH_MAX or tuple(pfs) != tuple(fs):
            raise RuntimeError(f"ns={ns}: code mismatch {mismatch:.4%} "
                               f"against the plain versions")
        precon = plain_model.decode(codes, fs)
        err = float((precon - recon).abs().max())
        if err > WAVE_ATOL:
            raise RuntimeError(f"ns={ns}: waveform differs by {err:.3g}")
        print(f"  ns={ns}: codes {tuple(codes.shape)} mismatch vs plain "
              f"{mismatch:.4%} (<= 0.2%), same codes decoded: max abs "
              f"diff {err:.3g} (<= 5e-4)", flush=True)
    with open(cli["escb"], "rb") as f:
        blob_codes, fs = unpack_codes(f.read())
    wav = load_wav(os.path.join(tmp, "clip.wav"))
    direct, dfs = model.encode(wav[None], num_streams=6)
    if not (np.array_equal(blob_codes, np.load(cli["npy"]))
            and np.array_equal(blob_codes, direct.cpu().numpy())
            and tuple(fs) == tuple(dfs)):
        raise RuntimeError("compress CLI: .escb codes differ")
    print(f"  compress CLI: {os.path.getsize(cli['escb'])} B .escb unpacks "
          f"to the .npy codes {blob_codes.shape}", flush=True)


# ------------------------------------------------------- phases 5 and 6
def speech_like(rng, n: int, f0: float) -> np.ndarray:
    """Harmonics of ``f0`` with a gliding pitch under a syllable-rate
    envelope, plus noise: float32 of ``n`` samples."""
    t = np.arange(n) / ESC_BASE["sr"]
    phase = 2 * np.pi * f0 * (t + 0.05 * np.sin(2 * np.pi * 0.7 * t))
    x = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k
            for k in range(1, 9))
    env = 0.25 + 0.75 * np.sin(2 * np.pi * 2.5 * t + rng.uniform(0, 3)) ** 2
    return (0.12 * env * x + 0.005 * rng.standard_normal(n)).astype(
        np.float32)


def eval_shapes(cfg: dict) -> tuple:
    """Phase 5's padded eval batch: (batch, length after the trim and the
    codec-grid padding)."""
    from esc_tpu_torch.io import esc_pad_length

    hop = int(cfg["hop_len"] * cfg["sr"] * 1e-3)
    longest = int(max(EVAL_SECONDS) * cfg["sr"]) - 80
    return EVAL_BATCH, esc_pad_length(longest, hop, cfg["patch_size"][1])


def eval_calls(cfg: dict):
    """The kernel calls of phase 5's sweep (one batch, num_streams 1-6) and
    of phase 6's evaluation (one validation batch at num_streams 6)."""
    B, L = eval_shapes(cfg)
    sweep = [main_path_calls(cfg, B, L, ns, forward=True)
             for ns in range(1, cfg["max_streams"] + 1)]
    val = main_path_calls(cfg, TRAIN_BATCH, TRAIN_SAMPLES - 80,
                          cfg["max_streams"], forward=True)
    return sweep, val


def model_dir_with(tmp: Path, name: str, seed: int):
    """A model directory as a user keeps one: ESC-Base's config.yaml and a
    model.pth of random weights from ``seed``. Returns (dir, config,
    weights)."""
    from esc_tpu_torch.models import make_model
    from esc_tpu_torch.utils.config import read_yaml

    d = tmp / name
    d.mkdir()
    shutil.copy(ESC_BASE_YAML, d / "config.yaml")
    cfg = read_yaml(str(d / "config.yaml"))
    weights = make_model(cfg["model"], cfg["model_name"], seed=seed,
                         device="cpu").state_dict()
    torch.save(weights, d / "model.pth")
    return d, cfg, weights


def run_module(module: str, args, timeout: int = 600):
    """``python -m module args`` in a subprocess; returns (its standard
    output, its wall seconds)."""
    start = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(f"{module} {args} exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout, wall


PERF_KEYS = ["PESQ", "MelDistance", "SISDR", "STOI", "utilization"]


def check_eval(kern, dev, rng, tmp: Path, sweep_calls) -> dict:
    """Phase 5: the test CLI as a user runs it, then the sweep in this
    process on the kernels and on the plain versions."""
    from esc_tpu_torch.cli.compress import load_model
    from esc_tpu_torch.io import save_wav
    from esc_tpu_torch.metrics import (PESQ, SISDR, STOI, EntropyCounter,
                                       MelSpectrogramDistance)
    from esc_tpu_torch.models import make_model
    from esc_tpu_torch.train.data import make_dataloader
    from esc_tpu_torch.train.evaluate import eval_epoch

    model_dir, cfg, weights = model_dir_with(tmp, "esc_base_eval", SEED + 2)
    wavs = tmp / "eval_wavs"
    wavs.mkdir()
    for i, sec in enumerate(EVAL_SECONDS):
        save_wav(str(wavs / f"utt_{i}.wav"),
                 speech_like(rng, int(sec * ESC_BASE["sr"]), 95.0 + 45 * i))
    out_dir = tmp / "eval_out"
    said, cli_s = run_module("esc_tpu_torch.cli.test", [
        "--eval_folder_path", str(wavs), "--model_path", str(model_dir),
        "--batch_size", str(EVAL_BATCH), "--num_streams", "6",
        "--save_path", str(out_dir)])
    if "model.pth" not in said:
        raise RuntimeError(f"test CLI did not load model.pth:\n{said}")
    stats = json.loads((out_dir / "perf_stats.json").read_text())
    if list(stats) != PERF_KEYS or any(
            len(v) != 1 or not np.isfinite(v[0]) for v in stats.values()):
        raise RuntimeError(f"perf_stats.json: {stats}")
    print(f"  test CLI ({cli_s:.2f} s, process start included): "
          f"perf_stats.json at 9 kbps {stats}", flush=True)

    m = cfg["model"]
    model = load_model(str(model_dir), device=dev)
    plain = make_model(m, cfg["model_name"], device=dev, plain_ops=True)
    plain.load_state_dict(weights)
    loader = make_dataloader(str(wavs), EVAL_BATCH, False, pad_eval=True,
                             pad_fn=model.pad_length)
    (x, lengths), = list(loader)
    if (len(x), x.shape[1]) != eval_shapes(m):
        raise RuntimeError(f"eval batch {x.shape}, phase 2 checked "
                           f"{eval_shapes(m)}")

    metric_s = {}

    def timed(name, fn):
        """``fn`` with its seconds added to ``metric_s[name]``; the card
        is synchronised first, so the forward's time is not the metric's."""
        def call(*a):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*a)
            metric_s[name] = metric_s.get(name, 0.0) + (
                time.perf_counter() - start)
            return out
        return call

    def sweep(codec):
        metrics = {"PESQ": PESQ(), "MelDistance": MelSpectrogramDistance(),
                   "SISDR": SISDR(), "STOI": STOI()}
        counter = EntropyCounter(m["codebook_size"], m["max_streams"],
                                 m["group_size"])
        return eval_epoch(codec, loader, {k: timed(k, fn) for k, fn in
                                          metrics.items()}, counter,
                          verbose=False)

    model(x, num_streams=6)                     # warm-up, not counted
    start = time.perf_counter()
    perf, launches = counted(kern, "the eval sweep", lambda: sweep(model))
    sweep_s = time.perf_counter() - start
    split = {k: round(v, 4) for k, v in metric_s.items()}
    split["the rest (forward, codes, host)"] = round(
        sweep_s - sum(metric_s.values()), 4)
    want = predicted([c for a, _ in sweep_calls for c in a],
                     [c for _, t in sweep_calls for c in t],
                     runs=len(sweep_calls))
    if launches != want:
        raise RuntimeError(f"eval sweep launches {launches}, predicted "
                           f"{want}")
    ref = sweep(plain)
    for key, rtol in (("MelDistance", EVAL_MEL_RTOL),
                      ("SISDR", EVAL_SISDR_RTOL)):
        if not np.allclose(perf[key], ref[key], rtol=rtol, atol=2e-4):
            raise RuntimeError(f"eval {key}: kernels {perf[key]}, plain "
                               f"{ref[key]} (rtol {rtol})")
    if any(not np.isfinite(v).all() for v in perf.values()):
        raise RuntimeError(f"eval sweep: a value is not finite: {perf}")
    # codes of the utterances' own frames, kernels against plain
    spc = model._samples_per_code()
    mismatch = {}
    xd = torch.as_tensor(x, device=dev)
    for ns in range(1, m["max_streams"] + 1):
        a = model(xd, num_streams=ns)["codes"]
        b = plain(xd, num_streams=ns)["codes"]
        own = torch.arange(a.shape[-1], device=dev)[None, :] < torch.as_tensor(
            -(-lengths // spc), device=dev)[:, None]
        diff = (a != b) & own[:, None, None, :]
        mismatch[ns] = float(diff.sum()) / float(own.sum() * ns
                                                 * a.shape[2])
    if max(mismatch.values()) > CODE_MISMATCH_MAX:
        raise RuntimeError(f"eval forward codes differ from the plain "
                           f"model's on {mismatch}")
    audio_s = float(lengths.sum()) / ESC_BASE["sr"] * m["max_streams"]
    per_audio_s = sweep_s / audio_s
    print(f"  eval sweep ns 1-6 on {EVAL_BATCH} clips of {EVAL_SECONDS} s "
          f"(one batch padded to {x.shape[1]}): launches {launches} as "
          f"predicted; kernels {perf}; plain MelDistance {ref['MelDistance']}"
          f", SISDR {ref['SISDR']}; codes of the utterances' frames differ "
          f"from the plain model's: " + ", ".join(
              f"ns={ns} {v:.4%}" for ns, v in mismatch.items())
          + " (<= 0.2%)", flush=True)
    print(f"  eval sweep seconds by part: {split}", flush=True)
    print(f"eval: {per_audio_s:.5f} s per audio second ({sweep_s:.2f} s for "
          f"{audio_s:.1f} s of audio over 6 bitrates, PESQ and STOI on the "
          f"host included)", flush=True)
    return {"perf_stats_cli": stats, "sweep": perf, "launches": launches,
            "s_per_audio_s": per_audio_s, "sweep_s": split, "cli_s": cli_s,
            "code_mismatch": mismatch,
            "dirs": {"tmp": str(tmp), "wavs": str(wavs),
                     "model_dir": str(model_dir)}}


def _loss_lines(text: str) -> list:
    """The losses of each ``[step n/N ...] k: v | ...`` line of a log."""
    import re
    lines = []
    for line in text.splitlines():
        m = re.match(r"\[step (\d+)/\d+ \d+s\] (.*)", line)
        if m:
            lines.append({k.strip(): float(v) for k, v in (
                kv.split(":") for kv in m.group(2).split("|"))
                if k.strip().endswith("loss")})
    return lines


def train_data(tmp: Path, rng, clips: int = TRAIN_BATCH,
               samples: int = TRAIN_SAMPLES) -> dict:
    """Folders of ``clips`` generated clips of ``samples`` samples for
    training and for validation, as a config's ``data`` section (batch
    ``TRAIN_BATCH``)."""
    from esc_tpu_torch.io import save_wav

    folders = {}
    for split, f0 in (("train", 110.0), ("val", 170.0)):
        folders[split] = tmp / f"{split}_wavs"
        folders[split].mkdir()
        for i in range(clips):
            save_wav(str(folders[split] / f"utt_{i}.wav"),
                     speech_like(rng, samples, f0 + 60 * i))
    return {"train_data_path": str(folders["train"]),
            "val_data_path": str(folders["val"]), "num_workers": 2,
            "train_bs_per_device": TRAIN_BATCH,
            "val_bs_per_device": TRAIN_BATCH}


def load_checkpoints(exp: Path, tmp: Path, dev) -> None:
    """Each of ``pretrained``, ``best`` and ``checkpoint.ckpt`` under
    ``exp`` loads, strictly, into the port's ``load_model``."""
    from esc_tpu_torch.checkpoint import load_model_state
    from esc_tpu_torch.cli.compress import load_model

    for tag in ("pretrained.ckpt", "best.ckpt", "checkpoint.ckpt"):
        d = tmp / f"load_{exp.name}_{tag}"
        d.mkdir()
        shutil.copy(exp / "config.yaml", d / "config.yaml")
        shutil.copy(exp / tag, d / tag)
        load_model(str(d), device=dev)          # strict: every weight
        load_model_state(str(exp / tag))


def check_resume(train_flags, ckpt: Path) -> int:
    """Phase 6: ``ckpt``'s optimizer state is optax's for esc_tpu's
    ``chain(clip_by_global_norm, adamw(schedule))``, and the train CLI's
    ``--resume`` takes it on the card with the count and every moment equal
    bit for bit. Returns the count."""
    from esc_tpu_torch.checkpoint import load_checkpoint
    from esc_tpu_torch.cli import train as train_cli

    state = load_checkpoint(str(ckpt))["optimizer_state_dict"]
    adamw = state.get("1", {})
    layout = (sorted(state), state.get("0"), sorted(adamw),
              sorted(adamw.get("0", {})), adamw.get("1"))
    if layout != (["0", "1"], {}, ["0", "1", "2"], ["count", "mu", "nu"],
                  {}) or adamw["2"]["count"] != adamw["0"]["count"]:
        raise RuntimeError(f"{ckpt.name}: not optax's layout: {layout}")
    trainer = train_cli._trainer(train_cli.parse_args(
        train_flags + ["--resume"]))
    trainer.model, _, trainer.val_dl = trainer.load()
    trainer._restore()
    want, got = _flat_tree(state), _flat_tree(trainer.opt.state_dict())
    if want.keys() != got.keys() or not all(
            np.array_equal(want[k], got[k]) for k in want):
        raise RuntimeError(f"--resume: the optimizer state of {ckpt.name} "
                           "did not come back equal")
    if not all(m.is_cuda for m in trainer.opt.mu + trainer.opt.nu):
        raise RuntimeError("--resume left moments off the card")
    count = int(adamw["0"]["count"])
    print(f"  {ckpt.name}: optimizer state in optax's layout, count {count}"
          f", {len(want) - 2} arrays; --resume on the card gives it back bit "
          "for bit", flush=True)
    return count


def check_train(kern, dev, rng, tmp: Path, val_calls) -> dict:
    """Phase 6: the train CLI as a user runs it, a few steps across the
    pretraining switch; then steps on one fixed batch in this process."""
    import argparse

    from esc_tpu_torch.train.trainer import Trainer
    from esc_tpu_torch.utils.config import read_yaml, write_yaml

    cfg = read_yaml(str(ESC_BASE_YAML))
    cfg["data"] = train_data(tmp, rng)
    write_yaml(str(tmp / "train.yaml"), cfg)
    out = tmp / "runs"
    train_flags = [
        "--config_path", str(tmp / "train.yaml"), "--exp_name", "smoke",
        "--num_epochs", str(TRAIN_EPOCHS), "--num_pretraining_epochs", "1",
        "--dropout_rate", "0.5", "--log_steps", "1", "--save_path", str(out),
        "--seed", str(SEED), "--val_metric", "SISDR"]
    said, cli_s = run_module("esc_tpu_torch.cli.train", train_flags)
    logged = _loss_lines(said)
    if len(logged) != TRAIN_EPOCHS or not all(
            np.isfinite(v) for line in logged for v in line.values()):
        raise RuntimeError(f"train CLI logged {logged}:\n{said}")
    for word in ("Optimizer Renewed", "Performance at 9.00kbps",
                 "checkpoint saved as pretrained.ckpt"):
        if word not in said:
            raise RuntimeError(f"train CLI never said {word!r}:\n{said}")
    load_checkpoints(out / "smoke", tmp, dev)
    print(f"  train CLI ({cli_s:.2f} s, process start included): "
          f"{len(logged)} steps, losses {logged}; pretrained, best and "
          f"checkpoint.ckpt load into the port's load_model", flush=True)
    resumed_count = check_resume(train_flags,
                                 out / "smoke" / "checkpoint.ckpt")

    args = argparse.Namespace(
        exp_name="in_process", lr=FIXED_BATCH_LR, num_epochs=1,
        num_pretraining_epochs=0, num_warmup_steps=0, val_metric="SISDR",
        scheduler_type="constant", dropout_rate=0.0, pretrain_ckp=None,
        log_steps=5, save_path=str(out), seed=SEED, resume=False,
        device=str(dev))
    trainer = Trainer(cfg, args)
    trainer.model, _, trainer.val_dl = trainer.load()
    x = np.stack([speech_like(rng, TRAIN_SAMPLES - 80, 130.0 + 50 * i)
                  for i in range(TRAIN_BATCH)])
    trainer.train_step(x, 6, False)             # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def steps():
        start = time.perf_counter()
        losses = [trainer.train_step(x, 6, False)["loss"]
                  for _ in range(FIXED_BATCH_STEPS)]
        torch.cuda.synchronize()
        return [float(v) for v in losses], time.perf_counter() - start

    (losses, steps_s), _ = counted(
        kern, f"{FIXED_BATCH_STEPS} training steps", steps, ran=False)
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and np.mean(losses[-5:])
            < np.mean(losses[:5]) and losses[-1] < losses[0]):
        raise RuntimeError(f"the loss did not fall on a fixed batch: "
                           f"{losses}")
    _, launches = counted(kern, "the trainer's evaluation",
                          lambda: trainer.evaluate(FIXED_BATCH_STEPS))
    want = predicted(*val_calls, runs=1)
    if launches != want:
        raise RuntimeError(f"evaluation launches {launches}, predicted "
                           f"{want}")
    multi = check_multi_step(kern, trainer)
    rate = FIXED_BATCH_STEPS / steps_s
    print(f"  {FIXED_BATCH_STEPS} steps on one batch of {TRAIN_BATCH} x "
          f"{(TRAIN_SAMPLES - 80) / 16000:.3f} s at lr {FIXED_BATCH_LR}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} ({losses}); the "
          f"evaluation launched {launches} as predicted", flush=True)
    print(f"train: {rate:.3f} steps per second, peak memory "
          f"{peak / 2 ** 30:.3f} GiB (ESC-Base, batch {TRAIN_BATCH} x 2 s, "
          f"fp32, TF32 off)", flush=True)
    summary = {"cli_losses": logged, "cli_s": cli_s, "losses": losses,
               "steps_per_s": rate, "peak_bytes": peak,
               "eval_launches": launches, "resumed_count": resumed_count,
               "multi_step": multi}
    return summary, lambda: trainer.train_step(x, 6, False)


def _step_state(trainer) -> list:
    """Every tensor a training step changes: the parameters and both
    moments (the count is kept apart)."""
    return [*trainer.model.module.parameters(), *trainer.opt.mu,
            *trainer.opt.nu]


def check_multi_step(kern, trainer) -> dict:
    """Phase 6's view of ``train/trainer.py::make_multi_step``: from one
    copy of the trainer's state, K steps by one multi-step call and K
    single ``train_step``s, in turns (single, multi, multi, single), on K
    batches with stream counts drawn by ``quantization_dropout`` from the
    seed; every run's losses, parameters, moments and count must equal the
    first's bit for bit, and no kernel may launch. Returns steps per
    second of each, by the freeze flag."""
    from esc_tpu_torch.train.data import quantization_dropout
    from esc_tpu_torch.train.trainer import make_multi_step

    rng = np.random.default_rng(SEED)
    saved = [t.detach().clone() for t in _step_state(trainer)]
    count = trainer.opt.count
    out = {}
    for freeze, k in MULTI_STEPS.items():
        xs = np.stack([np.stack([speech_like(rng, TRAIN_SAMPLES - 80,
                                             120.0 + 40 * i + 10 * j)
                                 for j in range(TRAIN_BATCH)])
                       for i in range(k)])
        streams = [quantization_dropout(0.5, ESC_BASE["max_streams"], rng)
                   for _ in range(k)]
        multi = make_multi_step(trainer.train_step, freeze)

        def single():
            auxs = [trainer.train_step(x, s, freeze)
                    for x, s in zip(xs, streams)]
            return {n: torch.stack([a[n] for a in auxs]) for n in auxs[0]}

        runs = {"single": single, "multi": lambda: multi(xs, streams)}
        first, rates = None, {"single": [], "multi": []}
        for name in ("single", "multi", "multi", "single"):
            with torch.no_grad():
                for t, v in zip(_step_state(trainer), saved):
                    t.copy_(v)
            trainer.opt.count = count
            torch.cuda.synchronize()
            start = time.perf_counter()
            losses, _ = counted(kern, f"{k} steps ({name}, freeze {freeze})",
                                runs[name], ran=False)
            rates[name].append(k / (time.perf_counter() - start))
            result = (losses, [t.detach().clone()
                               for t in _step_state(trainer)],
                      trainer.opt.count)
            if first is None:
                first = result
                continue
            same = (result[2] == first[2] and set(result[0]) == set(first[0])
                    and all(torch.equal(result[0][n], first[0][n])
                            for n in first[0])
                    and all(torch.equal(a, b)
                            for a, b in zip(result[1], first[1])))
            if not same:
                differ = sum(not torch.equal(a, b)
                             for a, b in zip(result[1], first[1]))
                raise RuntimeError(
                    f"{k} steps ({name}, freeze {freeze}) differ from the "
                    f"first run: {differ} of {len(first[1])} state arrays, "
                    f"losses {result[0]} against {first[0]}")
        if first[2] != count + k:
            raise RuntimeError(f"count {first[2]} after {k} steps from "
                               f"{count}")
        print(f"  make_multi_step over K = {k} batches of {TRAIN_BATCH} x "
              f"{(TRAIN_SAMPLES - 80) / 16000:.3f} s, freeze {freeze}, "
              f"num_streams {streams}: losses, {len(first[1])} state arrays "
              f"and the count equal to {k} single train_steps bit for bit, "
              f"no kernel launch; steps per second, in turns: single "
              f"{[round(r, 3) for r in rates['single']]}, multi "
              f"{[round(r, 3) for r in rates['multi']]}", flush=True)
        out[f"freeze={freeze}"] = {
            "K": k, "num_streams": streams, "steps_per_s": rates,
            "loss": first[0]["loss"].tolist()}
    with torch.no_grad():
        for t, v in zip(_step_state(trainer), saved):
            t.copy_(v)
    trainer.opt.count = count
    return out


GAN_LOSSES = ("gen_loss", "feat_loss", "disc_loss")


def check_adv(kern, dev, rng, tmp: Path, val_calls):
    """Phase 7: the adversarial train CLI as a user runs it, across the
    pretraining switch, and its post-adversarial finetuning; then
    adversarial steps on one batch at the config's own batch in this
    process. Returns (summary, trainer, the batch on the card)."""
    import argparse

    from esc_tpu_torch.checkpoint import load_checkpoint
    from esc_tpu_torch.convert import from_jax_params
    from esc_tpu_torch.models.discriminator import Discriminator
    from esc_tpu_torch.train.trainer_adv import TrainerAdv
    from esc_tpu_torch.utils.config import read_yaml, write_yaml

    cfg = read_yaml(str(ESC_ADV_YAML))
    own_batch = cfg["data"]["train_bs_per_device"]
    cfg["data"] = train_data(tmp, rng)
    write_yaml(str(tmp / "adv.yaml"), cfg)
    out = tmp / "runs"
    common = ["--adv_training", "--config_path", str(tmp / "adv.yaml"),
              "--save_path", str(out), "--seed", str(SEED), "--log_steps",
              "1", "--val_metric", "SISDR"]
    said, cli_s = run_module("esc_tpu_torch.cli.train", common + [
        "--exp_name", "smoke_adv", "--num_epochs", str(TRAIN_EPOCHS),
        "--num_pretraining_epochs", "1", "--dropout_rate", "0.5"])
    logged = _loss_lines(said)
    if len(logged) != TRAIN_EPOCHS or not all(
            np.isfinite(v) for line in logged for v in line.values()):
        raise RuntimeError(f"adversarial train CLI logged {logged}:\n{said}")
    if any(logged[0][k] != 0.0 for k in GAN_LOSSES) or not all(
            line[k] > 0.0 for line in logged[1:] for k in GAN_LOSSES):
        raise RuntimeError(f"GAN losses not zero in the freeze step or zero "
                           f"after it: {logged}")
    for word in ("Discriminator #Parameters", "Pretraining done. "
                 "Generator's Optimizer Renewed", "Performance at 9.00kbps",
                 "checkpoint saved as pretrained.ckpt"):
        if word not in said:
            raise RuntimeError(f"adversarial train CLI never said "
                               f"{word!r}:\n{said}")
    exp = out / "smoke_adv"
    load_checkpoints(exp, tmp, dev)
    payload = load_checkpoint(str(exp / "checkpoint.ckpt"))
    disc = Discriminator(**cfg["discriminator"])
    disc.load_state_dict(from_jax_params(payload["model_disc_state_dict"]))
    d_adam = payload["optimizer_disc_state_dict"]["1"]["0"]  # optax's layout
    if d_adam["count"] != TRAIN_EPOCHS - 1:
        raise RuntimeError("checkpoint.ckpt: the discriminator's optimizer "
                           f"counted {d_adam['count']}")
    lr = 1e-4
    said2, finetune_s = run_module("esc_tpu_torch.cli.train", common + [
        "--exp_name", "smoke_finetune", "--num_epochs", "1",
        "--num_pretraining_epochs", "0", "--lr", str(lr), "--pretrain_ckp",
        str(exp / "checkpoint.ckpt")])
    pre_eval = said2.find("[Step 0/1] | Performance at")
    if f"generator LR {lr / 10.0}" not in said2 or not 0 <= pre_eval < \
            said2.find("[step 1/1"):
        raise RuntimeError("--pretrain_ckp: no generator lr/10 or no "
                           f"evaluation before the first step:\n{said2}")
    print(f"  adversarial train CLI ({cli_s:.2f} s, process start "
          f"included): {len(logged)} steps, losses {logged}; pretrained, "
          f"best and checkpoint.ckpt load, the discriminator's weights and "
          f"optimizer state in checkpoint.ckpt; --pretrain_ckp "
          f"({finetune_s:.2f} s): generator lr {lr / 10.0}, evaluation "
          "before the first step", flush=True)

    cfg["data"]["train_bs_per_device"] = own_batch
    args = argparse.Namespace(
        exp_name="adv_in_process", lr=FIXED_BATCH_LR, num_epochs=1,
        num_pretraining_epochs=0, num_warmup_steps=0, val_metric="SISDR",
        scheduler_type="constant", dropout_rate=0.0, pretrain_ckp=None,
        log_steps=5, save_path=str(out), seed=SEED, resume=False,
        device=str(dev))
    trainer = TrainerAdv(cfg, args)
    trainer.model, _, trainer.val_dl = trainer.load()
    x = torch.tensor(np.stack([speech_like(rng, ADV_CLIP, 100.0 + 15 * i)
                               for i in range(own_batch)]), device=dev)
    trainer.train_step(x, 6, False)             # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def steps():
        start = time.perf_counter()
        auxes = [trainer.train_step(x, 6, False) for _ in range(ADV_STEPS)]
        torch.cuda.synchronize()
        return [{k: float(v) for k, v in a.items()} for a in auxes], \
            time.perf_counter() - start

    (auxes, steps_s), step_launches = counted(
        kern, f"{ADV_STEPS} adversarial steps", steps, ran=False)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(v) for a in auxes for v in a.values()) or any(
            a[k] <= 0.0 for a in auxes for k in GAN_LOSSES):
        raise RuntimeError(f"adversarial steps: {auxes}")
    _, launches = counted(kern, "the adversarial trainer's evaluation",
                          lambda: trainer.evaluate(ADV_STEPS))
    want = predicted(*val_calls, runs=1)
    if launches != want:
        raise RuntimeError(f"evaluation launches {launches}, predicted "
                           f"{want}")
    # the discriminator's feature maps on the card against the CPU's
    cpu_disc = Discriminator(**cfg["discriminator"])
    cpu_disc.load_state_dict({k: v.cpu() for k, v in
                              trainer.disc.state_dict().items()})
    with torch.no_grad():
        ours = trainer.disc(x[:1])
        ref = cpu_disc(x[:1].cpu())
    fmap_err = 0.0
    for di, (o, r) in enumerate(zip(ours, ref)):
        for li, (f, g) in enumerate(zip(o, r)):
            torch.testing.assert_close(
                f.cpu(), g, rtol=FMAP_RTOL, atol=FMAP_ATOL,
                msg=lambda m: f"discriminator {di} map {li}: {m}")
            fmap_err = max(fmap_err, float((f.cpu() - g).abs().max()))
    determinism = check_determinism(trainer, x)
    rate = ADV_STEPS / steps_s
    n_disc = sum(p.numel() for p in trainer.disc.parameters())
    print(f"  {ADV_STEPS} adversarial steps on one batch of {own_batch} x "
          f"{ADV_CLIP / 16000:.3f} s: losses {auxes[0]} -> {auxes[-1]}; no "
          f"kernel launch; the evaluation launched {launches} as predicted; "
          f"the discriminator ({n_disc / 1e6:.2f}M parameters) on the card "
          f"within {fmap_err:.3g} of the CPU's (rtol {FMAP_RTOL}, atol "
          f"{FMAP_ATOL})", flush=True)
    print(f"adv: {rate:.3f} adversarial steps per second, peak memory "
          f"{peak / 2 ** 30:.3f} GiB (ESC-Base + MPD/MRD discriminator, batch "
          f"{own_batch} x 3 s, fp32, TF32 off)", flush=True)
    summary = {"cli_losses": logged, "cli_s": cli_s,
               "finetune_cli_s": finetune_s, "losses": auxes,
               "steps_per_s": rate, "peak_bytes": peak,
               "step_launches": step_launches, "eval_launches": launches,
               "fmap_max_abs_err": fmap_err,
               "disc_params": n_disc, "determinism": determinism}
    return summary, trainer, x


def _trainer_state(trainer) -> list:
    """Every tensor an adversarial step changes: both modules' parameters
    and both optimizers' moments (the counts are kept apart)."""
    return [*trainer.model.module.parameters(), *trainer.disc.parameters(),
            *trainer.opt.mu, *trainer.opt.nu, *trainer.opt_disc.mu,
            *trainer.opt_disc.nu]


def check_determinism(trainer, x) -> dict:
    """Phase 7's view of ``train/trainer.py::reproducible``: one adversarial
    step taken twice from the same state, with cuDNN's default algorithms
    and with the deterministic ones a training step runs: the weight arrays
    that differ between the two (none may with the deterministic ones);
    then steps per second of each, in turns."""
    from esc_tpu_torch.train.trainer_adv import TrainerAdv

    gen, disc = (TrainerAdv.generator_step.__wrapped__,
                 TrainerAdv.discriminator_step.__wrapped__)

    def default_step():
        recon = gen(trainer, x, 6, False)[1]
        disc(trainer, recon, x, False)

    def deterministic_step():
        trainer.train_step(x, 6, False)

    steps = {"default": default_step, "deterministic": deterministic_step}
    state = [t.detach().clone() for t in _trainer_state(trainer)]
    counts = (trainer.opt.count, trainer.opt_disc.count)
    n_params = sum(1 for _ in trainer.model.module.parameters()) + sum(
        1 for _ in trainer.disc.parameters())
    differ = {}
    for name, step in steps.items():
        runs = []
        for _ in range(2):
            with torch.no_grad():
                for t, v in zip(_trainer_state(trainer), state):
                    t.copy_(v)
            trainer.opt.count, trainer.opt_disc.count = counts
            step()
            runs.append([t.detach().clone() for t in
                         _trainer_state(trainer)[:n_params]])
        differ[name] = sum(not torch.equal(a, b) for a, b in zip(*runs))
    if differ["deterministic"]:
        raise RuntimeError(f"one adversarial step taken twice from one "
                           f"state differs in {differ} weight arrays")
    rates = {name: [] for name in steps}
    for name in ("deterministic", "default", "default", "deterministic"):
        steps[name]()
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(ADV_TIMED_STEPS):
            steps[name]()
        torch.cuda.synchronize()
        rates[name].append(ADV_TIMED_STEPS / (time.perf_counter() - start))
    print(f"  one adversarial step taken twice from one state: "
          f"{differ['default']} of {n_params} weight arrays differ with "
          f"cuDNN's default algorithms, {differ['deterministic']} with the "
          f"deterministic ones; steps per second, in turns: deterministic "
          f"{[round(r, 3) for r in rates['deterministic']]}, default "
          f"{[round(r, 3) for r in rates['default']]}", flush=True)
    return {"arrays_differ": differ, "arrays": n_params,
            "steps_per_s": rates}


def _weights(path: Path) -> dict:
    """A checkpoint's generator and discriminator weights, by flax path."""
    from esc_tpu_torch.checkpoint import load_checkpoint

    payload = load_checkpoint(str(path))
    return {**_flat_tree(payload["model_state_dict"], "gen/"),
            **_flat_tree(payload["model_disc_state_dict"], "disc/")}


def check_data_parallel(rng, tmp: Path) -> dict:
    """Phase 8: the adversarial train CLI with ``--num_devices`` N, N the
    cards present, through its spawned NCCL ranks at batch 2, against one
    process at batch 2N on the same clips."""
    from esc_tpu_torch.convert import to_jax_params
    from esc_tpu_torch.models import make_model
    from esc_tpu_torch.models.discriminator import (Discriminator,
                                                    init_discriminator)
    from esc_tpu_torch.utils.config import write_yaml

    n = torch.cuda.device_count()
    data = train_data(tmp, rng, clips=2 * n, samples=DP_SAMPLES)
    loss = {"stft_weight": 0.0, "cm_weight": 0.25, "cb_weight": 1.0,
            "mel_weight": 15.0, "gen_weight": 1.0, "feat_weight": 2.0}

    def run(name, per_device, extra):
        cfg = {"data": dict(data, train_bs_per_device=per_device),
               "model_name": "csvq+swinT", "model": DP_MODEL,
               "discriminator": DP_DISC, "loss": loss}
        write_yaml(str(tmp / f"{name}.yaml"), cfg)
        said, wall = run_module("esc_tpu_torch.cli.train", [
            "--adv_training", "--config_path", str(tmp / f"{name}.yaml"),
            "--exp_name", name, "--save_path", str(tmp / "runs"),
            "--num_epochs", str(DP_EPOCHS), "--num_pretraining_epochs", "1",
            "--dropout_rate", "0.5", "--log_steps", "1", "--seed",
            str(SEED), "--val_metric", "SISDR", *extra])
        return said, _loss_lines(said), _weights(
            tmp / "runs" / name / "checkpoint.ckpt"), wall

    said, dp_losses, dp, dp_s = run("dp", 2, ["--num_devices", str(n)])
    want = f"Training on {n} cuda rank"
    if want not in said or f"Devices: {n} (cuda)" not in said:
        raise RuntimeError(f"--num_devices {n}: no {want!r}:\n{said}")
    if n == 1:
        _, one_losses, one, one_s = run("one", 2, [])
        diff = [k for k in one if not np.array_equal(one[k], dp[k])]
        if diff or dp_losses != one_losses:
            raise RuntimeError(f"1 NCCL rank against one process: weights "
                               f"differ in {diff[:5]} ({len(diff)} arrays), "
                               f"losses {dp_losses} / {one_losses}")
        verdict = "weights equal bit for bit, losses equal"
    else:
        _, one_losses, one, one_s = run("one", 2 * n, ["--num_devices", "1"])
        start = {**_flat_tree(to_jax_params(make_model(
            DP_MODEL, seed=SEED, device="cpu").module), "gen/"),
            **_flat_tree(to_jax_params(init_discriminator(
                Discriminator(**DP_DISC), SEED + 1)), "disc/")}
        for a, b in zip(dp_losses, one_losses):    # as logged: 4 decimals
            np.testing.assert_allclose([a[k] for k in b], list(b.values()),
                                       rtol=1e-5, atol=1e-4)
        moved = sum(float(np.sum((one[k] - start[k]) ** 2)) for k in one)
        apart = sum(float(np.sum((one[k] - dp[k]) ** 2)) for k in one)
        if len(dp_losses) != DP_EPOCHS or (apart / moved) ** 0.5 >= 0.1:
            raise RuntimeError(f"{n} ranks against one: {dp_losses} / "
                               f"{one_losses}, weights apart "
                               f"{(apart / moved) ** 0.5:.3g} of the "
                               "distance moved")
        verdict = (f"losses as logged within 1e-4, weights apart "
                   f"{(apart / moved) ** 0.5:.3g} of the distance moved")
    print(f"  --num_devices {n} ({dp_s:.2f} s, process start included) "
          f"against one process ({one_s:.2f} s): {verdict}; losses "
          f"{dp_losses}", flush=True)
    print(f"dp: N = {n} card(s)", flush=True)
    return {"cards": n, "losses": dp_losses,
            "one_process_losses": one_losses, "cli_s": dp_s,
            "one_process_s": one_s, "verdict": verdict}


# ------------------------------------------------------------- phase 9
def ablation_calls(cfg: dict, name: str, batch: int, length: int,
                   num_streams: int, forward: bool = False):
    """The kernel calls of one ``roundtrip(x, num_streams)`` of an ablation
    codec, or with ``forward`` of its eval forward, as
    :func:`main_path_calls` gives ESC's: an RVQ codec quantizes its bottom
    latent with ``num_streams`` residual stages per group (every stage in
    the eval forward) and runs each Swin layer once, encoder then decoder;
    the conv backbone runs no attention."""
    streams = cfg["max_streams"] if forward and name.startswith("rvq") \
        else num_streams
    dims = cfg["codebook_dims"] if name.startswith("csvq") \
        else [cfg["codebook_dim"]] * cfg["max_streams"]
    # the conv configs have no Swin keys; their attention is dropped below
    argmin, attn = main_path_calls(
        {"window_size": 4, "swin_depth": 2, "swin_heads": [1] * 5, **cfg,
         "codebook_dims": dims}, batch, length,
        streams if name.startswith("csvq") else 1, forward)
    if name.startswith("rvq"):
        argmin = [argmin[0]] * (streams * cfg["group_size"])
    return argmin, (attn if cfg["backbone"] == "transformer" else [])


def ablation_model_dir(tmp: Path, name: str, seed: int):
    """A model directory of an ablation: its config.yaml as published and
    a model.pth of random weights from ``seed``. Returns (dir, config,
    weights)."""
    from esc_tpu_torch.models import make_model
    from esc_tpu_torch.utils.config import read_yaml

    d = tmp / name.replace("+", "_")
    d.mkdir()
    shutil.copy(ABLATION_YAMLS[name], d / "config.yaml")
    cfg = read_yaml(str(d / "config.yaml"))
    weights = make_model(cfg["model"], name, seed=seed,
                         device="cpu").state_dict()
    torch.save(weights, d / "model.pth")
    return d, cfg, weights


def check_ablation_roundtrips(kern, dev, rng) -> dict:
    """Each ablation at full width: roundtrips at num_streams 1, 3, 6 with
    the launches predicted, against the plain versions; real-time factor."""
    from esc_tpu_torch.models import make_model
    from esc_tpu_torch.utils.config import read_yaml

    x = torch.tensor(0.1 * rng.standard_normal((BATCH, CLIP)),
                     dtype=torch.float32)
    out = {}
    for name, path in ABLATION_YAMLS.items():
        cfg = read_yaml(str(path))["model"]
        model = make_model(cfg, name, seed=SEED, device=dev)
        plain = make_model(cfg, name, seed=SEED, device=dev, plain_ops=True)
        expect = {"codebook_argmin"} | (
            {"window_attention", "layer_norm"}
            if cfg["backbone"] == "transformer" else set())
        model.roundtrip(x, num_streams=6)           # warm-up, not counted
        res = {"params": model.num_params(), "launches": {},
               "mismatch": {}, "wave_err": {}}
        for ns in STREAMS:
            (codes, fs, recon), launches = counted(
                kern, f"{name} roundtrip ns={ns}",
                lambda: model.roundtrip(x, num_streams=ns), expect=expect)
            calls = ablation_calls(cfg, name, BATCH, CLIP, ns)
            want = predicted(*calls, runs=1)
            if launches != want:
                raise RuntimeError(f"{name} ns={ns}: launches {launches}, "
                                   f"predicted {want}")
            shape = (BATCH, ns, cfg["group_size"], fs[1] // cfg["overlap"])
            if tuple(codes.shape) != shape or codes.dtype != torch.int32 \
                    or int(codes.min()) < 0 \
                    or int(codes.max()) >= cfg["codebook_size"] \
                    or tuple(recon.shape) != (BATCH, CLIP) \
                    or not bool(torch.isfinite(recon).all()):
                raise RuntimeError(f"{name} ns={ns}: codes "
                                   f"{tuple(codes.shape)} {codes.dtype}, "
                                   f"waveform {tuple(recon.shape)}")
            pcodes, pfs = plain.encode(x, num_streams=ns)
            mismatch = float((pcodes != codes).float().mean())
            err = float((plain.decode(codes, fs) - recon).abs().max())
            if mismatch > CODE_MISMATCH_MAX or tuple(pfs) != tuple(fs) \
                    or err > WAVE_ATOL:
                raise RuntimeError(f"{name} ns={ns}: code mismatch "
                                   f"{mismatch:.4%} against the plain "
                                   f"versions, same codes decoded {err:.3g}")
            res["launches"][ns], res["mismatch"][ns] = launches, mismatch
            res["wave_err"][ns] = err
            print(f"  {name} ns={ns}: codes {shape} mismatch vs plain "
                  f"{mismatch:.4%} (<= 0.2%), same codes decoded: max abs "
                  f"diff {err:.3g} (<= 5e-4)", flush=True)
        res["real_time_factor"] = paired({
            "kernels": lambda: real_time_factor(model, x),
            "plain": lambda: real_time_factor(plain, x)})
        print(f"  {name} ({res['params'] / 1e6:.2f}M parameters): "
              f"roundtrip ns=6, {BATCH} x 3 s, real-time factor "
              f"{res['real_time_factor']} (pairs, order alternating)",
              flush=True)
        out[name] = res
    return out


@torch.no_grad()
def check_standalone_rvq(kern, dev) -> dict:
    """The standalone ``ResidualVectorQuantize`` at esc_tpu's defaults, in
    eval mode, weights and latents from the seed: at num_streams 1, 3, 6,
    ``encode`` with ``num_streams`` argmin launches and the eval forward
    with one per codebook (every stage runs at inference), codes against
    the same module on the plain argmin, the same codes decoded on the card
    and on the CPU; call ms of ``encode`` at 6 streams, kernel and plain."""
    from esc_tpu_torch.modules.vq import ResidualVectorQuantize

    torch.manual_seed(SEED)
    cpu = ResidualVectorQuantize().eval()
    rvq = ResidualVectorQuantize().to(dev).eval()
    plain = ResidualVectorQuantize().to(dev).eval()
    rvq.load_state_dict(cpu.state_dict())
    plain.load_state_dict(cpu.state_dict())
    for vq in plain.vqs:
        vq.plain_ops = True
    rng = np.random.default_rng(SEED)
    z = torch.tensor(rng.standard_normal(
        (RVQ_BATCH, rvq.in_freq * RVQ_FRAMES, rvq.in_dim)),
        dtype=torch.float32, device=dev)
    frames = RVQ_FRAMES // rvq.overlap
    num_vqs = len(rvq.vqs)
    res = {"rows": RVQ_BATCH * frames, "launches": {}, "mismatch": {},
           "wave_err": {}}
    rvq.encode(z, num_vqs)                          # warm-up, not counted
    for ns in STREAMS:
        codes, enc = counted(kern, f"standalone RVQ encode ns={ns}",
                             lambda: rvq.encode(z, ns),
                             expect={"codebook_argmin"})
        out, fwd = counted(kern, f"standalone RVQ eval forward ns={ns}",
                           lambda: rvq(z, ns), expect={"codebook_argmin"})
        if enc["codebook_argmin"] != ns or fwd["codebook_argmin"] != num_vqs:
            raise RuntimeError(f"standalone RVQ ns={ns}: launches {enc} per "
                               f"encode, {fwd} per forward, predicted {ns} "
                               f"and {num_vqs}")
        if tuple(codes.shape) != (RVQ_BATCH, ns, frames) \
                or tuple(out["codes"].shape) != (RVQ_BATCH, num_vqs, frames) \
                or tuple(out["z_q"].shape) != tuple(z.shape) \
                or not bool(torch.isfinite(out["z_q"]).all()):
            raise RuntimeError(f"standalone RVQ ns={ns}: codes "
                               f"{tuple(codes.shape)}, forward "
                               f"{tuple(out['codes'].shape)}, z_q "
                               f"{tuple(out['z_q'].shape)}")
        mismatch = max(float((plain.encode(z, ns) != codes).float().mean()),
                       float((plain(z, ns)["codes"] != out["codes"])
                             .float().mean()))
        err = float((rvq.decode(codes).cpu()
                     - cpu.decode(codes.cpu())).abs().max())
        if mismatch > CODE_MISMATCH_MAX or err > WAVE_ATOL:
            raise RuntimeError(f"standalone RVQ ns={ns}: code mismatch "
                               f"{mismatch:.4%} against the plain argmin, "
                               f"the same codes decoded card vs CPU {err:.3g}")
        res["launches"][ns] = {"encode": enc, "forward": fwd}
        res["mismatch"][ns], res["wave_err"][ns] = mismatch, err
        print(f"  standalone RVQ ns={ns}: codes {tuple(codes.shape)}, "
              f"mismatch vs plain {mismatch:.4%} (<= 0.2%), the same codes "
              f"decoded card vs CPU: max abs diff {err:.3g} (<= 5e-4)",
              flush=True)
    res["encode_call_ms"] = {
        "kernel": call_ms(lambda: rvq.encode(z, num_vqs)),
        "plain": call_ms(lambda: plain.encode(z, num_vqs))}
    print(f"  standalone RVQ encode at ns=6 ({num_vqs} searches of "
          f"{res['rows']} x 1024 x 8), call ms: kernel "
          f"{res['encode_call_ms']['kernel']:.4f}, plain "
          f"{res['encode_call_ms']['plain']:.4f}", flush=True)
    return res


def check_ablation_clis(kern, dev, rng, tmp: Path) -> dict:
    """The compress CLI on rvq+conv, through a .escb v2; the test CLI on
    csvq+conv; a rvq+conv .ckpt with its BatchNorm statistics written and
    read back."""
    from esc_tpu_torch.checkpoint import save_checkpoint
    from esc_tpu_torch.cli.bitstream import unpack_codes
    from esc_tpu_torch.cli.compress import load_model
    from esc_tpu_torch.convert import to_jax_variables
    from esc_tpu_torch.io import load_wav, save_wav

    out = {}
    d, cfg, _ = ablation_model_dir(tmp, "rvq+conv", SEED + 2)
    wav = tmp / "speech.wav"
    save_wav(str(wav), speech_like(rng, ABLATION_CLI_SECONDS * 16000, 140.0))
    said, wall = run_module("esc_tpu_torch.cli.compress", [
        "--input", str(wav), "--model_path", str(d), "--save_path",
        str(tmp / "rvq_conv_out"), "--num_streams", "6"])
    npy = np.load(tmp / "rvq_conv_out" / "encoded_9.0kbps_speech.npy")
    blob = (tmp / "rvq_conv_out" / "encoded_9.0kbps_speech.escb").read_bytes()
    codes, fs = unpack_codes(blob)
    recon = load_wav(str(tmp / "rvq_conv_out" / "decoded_9.0kbps_speech.wav"))
    if "model.pth" not in said or blob[4] != 2 \
            or not np.array_equal(codes, npy) \
            or not np.isfinite(recon).all():
        raise RuntimeError(f"compress CLI on rvq+conv: .escb v{blob[4]}, "
                           f"codes equal to the .npy "
                           f"{np.array_equal(codes, npy)}:\n{said}")
    model = load_model(str(d), device=dev)
    direct, _ = model.encode(load_wav(str(wav))[None], num_streams=6)
    if not np.array_equal(direct.cpu().numpy(), npy):
        raise RuntimeError("compress CLI on rvq+conv: codes differ from "
                           "the model's in this process")
    out["compress_cli_s"] = wall
    print(f"  compress CLI on rvq+conv: {wall:.2f} s for "
          f"{ABLATION_CLI_SECONDS} s of audio (process start included); "
          f".escb v2 {len(blob)} B (v1 would be "
          f"{20 + (npy.size * 10 + 7) // 8} B) unpacks to the .npy codes "
          f"{npy.shape}", flush=True)

    save_checkpoint(str(d), "model.ckpt", step=0,
                    model_state=to_jax_variables(model.module))
    (d / "model.pth").unlink()
    reread = load_model(str(d), device=dev)
    again, _ = reread.encode(load_wav(str(wav))[None], num_streams=6)
    stats = sum(1 for k in reread.state_dict() if "running_" in k)
    if not torch.equal(again, direct) or not stats:
        raise RuntimeError("rvq+conv .ckpt read back gives other codes")
    print(f"  rvq+conv model.ckpt ({(d / 'model.ckpt').stat().st_size} B, "
          f"{stats} BatchNorm statistics) read back: the same codes",
          flush=True)

    d, cfg, _ = ablation_model_dir(tmp, "csvq+conv", SEED + 3)
    folder = tmp / "ablation_eval"
    folder.mkdir()
    for i, secs in enumerate(EVAL_SECONDS):
        save_wav(str(folder / f"utt_{i}.wav"),
                 speech_like(rng, int(secs * 16000), 120.0 + 40 * i))
    said, wall = run_module("esc_tpu_torch.cli.test", [
        "--eval_folder_path", str(folder), "--model_path", str(d),
        "--batch_size", str(EVAL_BATCH)])
    with open(d / "perf_stats.json") as f:
        perf = json.load(f)
    if sorted(perf) != sorted(PERF_KEYS) or any(
            len(v) != 6 or not np.isfinite(v).all() for v in perf.values()):
        raise RuntimeError(f"test CLI on csvq+conv: {perf}\n{said}")
    out["test_cli_s"], out["test_cli_perf"] = wall, perf
    print(f"  test CLI on csvq+conv: {wall:.2f} s (process start "
          f"included), perf_stats.json {perf}", flush=True)
    return out


def check_ablation_training(kern, dev, rng, tmp: Path) -> dict:
    """The train CLI on rvq+swinT across the freeze switch; steps on one
    batch in this process; the train CLI's refusal of the conv backbone."""
    import argparse

    from esc_tpu_torch.train.trainer import Trainer
    from esc_tpu_torch.utils.config import read_yaml, write_yaml

    name = "rvq+swinT"
    cfg = read_yaml(str(ABLATION_YAMLS[name]))
    cfg["data"] = train_data(tmp, rng)
    write_yaml(str(tmp / "rvq.yaml"), cfg)
    runs = tmp / "runs"
    said, cli_s = run_module("esc_tpu_torch.cli.train", [
        "--config_path", str(tmp / "rvq.yaml"), "--exp_name", "rvq_swint",
        "--num_epochs", str(TRAIN_EPOCHS), "--num_pretraining_epochs", "1",
        "--dropout_rate", "0.5", "--log_steps", "1", "--save_path",
        str(runs), "--seed", str(SEED), "--val_metric", "SISDR"])
    logged = _loss_lines(said)
    if len(logged) != TRAIN_EPOCHS or not all(
            np.isfinite(v) for line in logged for v in line.values()):
        raise RuntimeError(f"train CLI on {name} logged {logged}:\n{said}")
    load_checkpoints(runs / "rvq_swint", tmp, dev)
    print(f"  train CLI on {name} ({cli_s:.2f} s, process start included): "
          f"{len(logged)} steps, losses {logged}; its checkpoints load",
          flush=True)

    args = argparse.Namespace(
        exp_name="rvq_in_process", lr=FIXED_BATCH_LR, num_epochs=1,
        num_pretraining_epochs=0, num_warmup_steps=0, val_metric="SISDR",
        scheduler_type="constant", dropout_rate=0.0, pretrain_ckp=None,
        log_steps=5, save_path=str(runs), seed=SEED, resume=False,
        device=str(dev))
    trainer = Trainer(cfg, args)
    trainer.model, _, trainer.val_dl = trainer.load()
    x = np.stack([speech_like(rng, TRAIN_SAMPLES - 80, 130.0 + 50 * i)
                  for i in range(TRAIN_BATCH)])
    trainer.train_step(x, 6, False)             # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # this trainer's and others'

    def steps():
        start = time.perf_counter()
        losses = [trainer.train_step(x, 6, False)["loss"]
                  for _ in range(ABLATION_STEPS)]
        torch.cuda.synchronize()
        return [float(v) for v in losses], time.perf_counter() - start

    (losses, steps_s), _ = counted(
        kern, f"{ABLATION_STEPS} {name} training steps", steps, ran=False)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{name} steps: losses {losses}")
    val = ablation_calls(cfg["model"], name, TRAIN_BATCH, TRAIN_SAMPLES - 80,
                         6, forward=True)
    _, launches = counted(kern, f"the {name} trainer's evaluation",
                          lambda: trainer.evaluate(ABLATION_STEPS))
    want = predicted(*val, runs=1)
    if launches != want:
        raise RuntimeError(f"{name} evaluation launches {launches}, "
                           f"predicted {want}")
    rate = ABLATION_STEPS / steps_s
    print(f"train {name}: {rate:.3f} steps per second, peak memory "
          f"{peak / 2 ** 30:.3f} GiB, of which {held / 2 ** 30:.3f} GiB "
          f"allocated before the steps (its weights and optimizer, and "
          f"what earlier phases still hold) (batch {TRAIN_BATCH} x 2 s, "
          f"fp32, TF32 off), losses {losses}", flush=True)

    refused = {}
    for conv in ("csvq+conv", "rvq+conv"):
        ccfg = read_yaml(str(ABLATION_YAMLS[conv]))
        ccfg["data"] = cfg["data"]
        write_yaml(str(tmp / "conv.yaml"), ccfg)
        start = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "esc_tpu_torch.cli.train",
             "--config_path", str(tmp / "conv.yaml"), "--exp_name", "conv",
             "--num_epochs", "1", "--save_path", str(tmp / "conv_runs"),
             "--device", dev.type],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        said = proc.stdout + proc.stderr
        if proc.returncode == 0 or "NotImplementedError" not in said \
                or "BatchNorm" not in said \
                or (tmp / "conv_runs").exists():
            raise RuntimeError(f"the train CLI did not refuse {conv}:\n"
                               f"{said}")
        refused[conv] = time.perf_counter() - start
        last = said.strip().splitlines()[-1]
        print(f"  train CLI on {conv}: refused ({last}), nothing written",
              flush=True)
    return {"cli_losses": logged, "cli_s": cli_s, "losses": losses,
            "steps_per_s": rate, "peak_bytes": peak, "held_bytes": held,
            "eval_launches": launches, "conv_refused_s": refused}


# ------------------------------------------------- phases 10 and 11
def chunked_dp_calls(cfg: dict, length: int, n_dev: int,
                     chunk_seconds: float = DP_CHUNK,
                     margin_seconds: float = DP_MARGIN):
    """The kernel calls of ``encode_chunked_dp`` then ``decode_chunked_dp``
    of a file of ``length`` samples over ``n_dev`` replicas: every segment
    is W = chunk + 2 * margin code frames (a roundtrip at batch 1 of W * 320
    samples, as :func:`main_path_calls` gives it), in waves of ``n_dev``
    with the last one filled. Returns (argmin calls, attention calls, the
    segments of the file)."""
    spc, chunk, margin, total = chunk_grid(cfg, length, chunk_seconds,
                                           margin_seconds)
    segments = -(-total // chunk)
    run = -(-segments // n_dev) * n_dev
    argmin, attn = main_path_calls(cfg, 1, (chunk + 2 * margin) * spc, 6)
    return argmin * run, attn * run, segments


def check_multicard(kern, dev, rng, eval_dirs: dict, eval_stats: dict):
    """Phase 10: ESC-Base as published over every visible card: a 25 s
    file through ``encode_chunked_dp`` / ``decode_chunked_dp`` against the
    same replicas on the plain versions, with the launches predicted; the
    test CLI's ``--data_parallel`` on phase 5's clips and model against
    phase 5's ``perf_stats.json``; ms per audio second, serial and over the
    replicas. Returns (summary, launches)."""
    from esc_tpu_torch.models import make_model
    from esc_tpu_torch.parallel import (Replicas, decode_chunked_dp,
                                        encode_chunked_dp)
    from esc_tpu_torch.utils.config import read_yaml

    cfg = read_yaml(str(ESC_BASE_YAML))
    m = cfg["model"]
    model = make_model(m, cfg["model_name"], seed=SEED, device=dev)
    plain = make_model(m, cfg["model_name"], seed=SEED, device=dev,
                       plain_ops=True)
    dp = Replicas()
    n = dp.num_devices
    L = DP_SECONDS * m["sr"]
    x = speech_like(rng, L, 125.0)[None]
    kw = dict(chunk_seconds=DP_CHUNK, margin_seconds=DP_MARGIN)

    def roundtrip(codec, d):
        codes, fs = encode_chunked_dp(codec, x, 6, dp=d, **kw)
        return codes, fs, decode_chunked_dp(codec, codes, fs, dp=d, **kw)

    roundtrip(model, dp)                       # warm-up, not counted
    (codes, fs, recon), launches = counted(
        kern, f"encode/decode_chunked_dp over {n} card(s)",
        lambda: roundtrip(model, dp))
    argmin_calls, attn_calls, segments = chunked_dp_calls(m, L, n)
    want = predicted(argmin_calls, attn_calls,
                     runs=-(-segments // n) * n)
    if launches != want:
        raise RuntimeError(f"chunked dp launches {launches}, predicted "
                           f"{want} ({segments} segments)")
    total = fs[1] // m["overlap"]
    hop = int(m["hop_len"] * m["sr"] * 1e-3)
    if tuple(codes.shape) != (1, 6, m["group_size"], total) or tuple(
            recon.shape) != (1, (fs[1] * m["patch_size"][1] - 1) * hop) \
            or not bool(torch.isfinite(recon).all()):
        raise RuntimeError(f"chunked dp: codes {tuple(codes.shape)}, "
                           f"waveform {tuple(recon.shape)}")
    pcodes, _ = encode_chunked_dp(plain, x, 6, dp=dp, **kw)
    mismatch = float((pcodes != codes).float().mean())
    wave_err = float((decode_chunked_dp(plain, codes, fs, dp=dp, **kw)
                      - recon).abs().max())
    if mismatch > CODE_MISMATCH_MAX or wave_err > WAVE_ATOL:
        raise RuntimeError(f"chunked dp: codes differ from the plain "
                           f"versions' on {mismatch:.4%}, the same codes "
                           f"decoded by {wave_err:.3g}")

    def ms_per_audio_s(d):
        def run():
            torch.cuda.synchronize()
            start = time.perf_counter()
            roundtrip(model, d)
            torch.cuda.synchronize()
            return (time.perf_counter() - start) * 1e3 / DP_SECONDS
        return run

    walls = paired({"serial": ms_per_audio_s(None),
                    "replicas": ms_per_audio_s(dp)})
    print(f"  encode/decode_chunked_dp of {DP_SECONDS} s ({segments} "
          f"segments of {DP_CHUNK:g} s + 2 x {DP_MARGIN:g} s) over {n} "
          f"card(s): launches {launches} as predicted; codes against the "
          f"plain versions {mismatch:.4%} (<= 0.2%), the same codes decoded "
          f"within {wave_err:.3g} (<= 5e-4)", flush=True)

    out_dir = Path(eval_dirs["tmp"]) / "eval_out_dp"
    said, cli_s = run_module("esc_tpu_torch.cli.test", [
        "--eval_folder_path", eval_dirs["wavs"], "--model_path",
        eval_dirs["model_dir"], "--batch_size", str(EVAL_BATCH),
        "--num_streams", "6", "--save_path", str(out_dir),
        "--data_parallel"])
    if f"Evaluating on {n} device(s)" not in said:
        raise RuntimeError(f"test CLI --data_parallel did not spread over "
                           f"{n} card(s):\n{said}")
    stats = json.loads((out_dir / "perf_stats.json").read_text())
    # phase 5's bars: SI-SDR rtol 1e-2, every other score rtol 1e-3
    if list(stats) != PERF_KEYS or not all(
            len(v) == 1 and np.isfinite(v[0]) and np.allclose(
                v, eval_stats[k], atol=2e-4,
                rtol=EVAL_SISDR_RTOL if k == "SISDR" else EVAL_MEL_RTOL)
            for k, v in stats.items()):
        raise RuntimeError(f"test CLI --data_parallel: {stats}, phase 5 "
                           f"{eval_stats}")
    print(f"  test CLI --data_parallel over {n} card(s) ({cli_s:.2f} s, "
          f"process start included): perf_stats.json {stats}, phase 5's "
          f"{eval_stats}", flush=True)
    print(f"multicard: {n} card(s); ms per audio second of the chunked "
          f"roundtrip: serial {walls['serial']}, {n} replica(s) "
          f"{walls['replicas']} (pairs, order alternating)", flush=True)
    return {"cards": n, "segments": segments, "launches": launches,
            "mismatch": mismatch, "wave_err": wave_err,
            "ms_per_audio_s": walls, "perf_stats_cli": stats,
            "cli_s": cli_s}, launches


def dac_forward_calls(cfg: dict, batch: int, length: int) -> list:
    """The argmin calls of one padded DAC forward of ``batch`` clips of
    ``length`` samples: one per stage, every frame of every clip."""
    hop = int(np.prod(cfg["encoder_rates"]))
    rows = batch * -(-length // hop)
    return [(rows, cfg["codebook_size"], cfg["codebook_dim"])] \
        * cfg["n_codebooks"]


def dac_padded_length(cfg: dict, length: int) -> int:
    """The padded forward's output length: the input padded to whole hops,
    each transposed conv's ``(T - 1) s - 2 ceil(s / 2) + 2 s`` (one sample
    short at an odd rate, as the reference), cropped to the input's."""
    T = -(-length // int(np.prod(cfg["encoder_rates"])))
    for s in cfg["decoder_rates"]:
        T = (T - 1) * s - 2 * -(-s // 2) + 2 * s
    return min(T, length)


def dac_compress_calls(cfg: dict, length: int) -> list:
    """The argmin calls of ``DAC.compress`` of ``length`` samples in
    windows of :data:`DAC_WIN` seconds: unpadded windows of ``n_samples``
    that advance by the whole model's unpadded output, each encoded to the
    encoder's unpadded length (``esc_tpu_torch/baselines/dac/model.py``)."""
    from esc_tpu_torch.baselines.dac.model import conv_specs, output_length

    hop = int(np.prod(cfg["encoder_rates"]))
    if length <= DAC_WIN * cfg["sample_rate"]:
        return dac_forward_calls(cfg, 1, length)
    specs = conv_specs(cfg["encoder_rates"], cfg["decoder_rates"])
    n_samples = -(-int(DAC_WIN * cfg["sample_rate"]) // hop) * hop
    windows = len(range(0, length, output_length(specs, n_samples)))
    rows = output_length(specs[:2 + 7 * len(cfg["encoder_rates"])],
                         n_samples)
    return [(rows, cfg["codebook_size"], cfg["codebook_dim"])] \
        * (cfg["n_codebooks"] * windows)


def _iter_lines(text: str) -> list:
    """The values of each ``[iter n/N ...] k: v | ...`` line of a log."""
    import re
    lines = []
    for line in text.splitlines():
        hit = re.match(r"\[iter \d+/\d+ \d+s\] (.*)", line)
        if hit:
            lines.append({k.strip(): float(v) for k, v in (
                kv.split(":") for kv in hit.group(1).split("|"))})
    return lines


def check_dac(kern, dev, rng, tmp: Path) -> dict:
    """Phase 11: the DAC of ``configs/dac/16khz_dns_9k.yml`` as published
    (random weights from seed 0): the eval forward of 4 clips of 3 s and
    ``compress`` of a 10 s wav, with the argmin's launches predicted,
    against the same model on the plain argmin; the encode / decode CLI as
    subprocesses; ``DACTrainer`` with the config's discriminator for 4
    steps at batch 2 (no kernel launch in a step, the argmin in the
    validation), steps timed by ``StepTimer.tic`` / ``toc``; one
    ``trace()`` of a roundtrip. Returns (summary, the argmin calls of the
    10 s compress, launches)."""
    import contextlib
    import io

    from esc_tpu_torch.baselines.dac import DAC, DACFile
    from esc_tpu_torch.baselines.dac.trainer import DACTrainer
    from esc_tpu_torch.checkpoint import load_checkpoint
    from esc_tpu_torch.convert import from_jax_params
    from esc_tpu_torch.io import load_wav, save_wav
    from esc_tpu_torch.models.discriminator import Discriminator
    from esc_tpu_torch.utils.config import read_yaml
    from esc_tpu_torch.utils.profiling import StepTimer, annotate, trace

    cfg = read_yaml(str(DAC_YAML))
    dcfg = cfg["DAC"]
    sr = dcfg["sample_rate"]
    model = DAC(seed=SEED, device=dev, **dcfg)
    plain = DAC(seed=SEED, device=dev, plain_ops=True, **dcfg)
    n_params = model.num_params()
    x = np.stack([speech_like(rng, DAC_CLIP, 110.0 + 40 * i)
                  for i in range(DAC_CLIPS)])
    L = DAC_FILE_SECONDS * sr
    wav = tmp / "dac_in.wav"
    save_wav(str(wav), speech_like(rng, L, 150.0))

    def drive():
        return model(x), model.compress(str(wav), win_duration=DAC_WIN)

    drive()                                    # warm-up, not counted
    (out, f), launches = counted(kern, "the DAC's forward and compress",
                                 drive, expect={"codebook_argmin"})
    fwd_calls = dac_forward_calls(dcfg, DAC_CLIPS, DAC_CLIP)
    file_calls = dac_compress_calls(dcfg, L)
    windows = f.codes.shape[-1] // f.chunk_length
    if launches["codebook_argmin"] != len(fwd_calls) + len(file_calls) \
            or windows * dcfg["n_codebooks"] != len(file_calls) \
            or f.padding or f.codes.shape[:2] != (1, dcfg["n_codebooks"]):
        raise RuntimeError(f"DAC launches {launches}, predicted "
                           f"{len(fwd_calls)} + {len(file_calls)}; "
                           f"{windows} windows, codes {f.codes.shape}")
    codes = out["codes"]
    if tuple(codes.shape) != (DAC_CLIPS, dcfg["n_codebooks"],
                              DAC_CLIP // model.hop_length) \
            or tuple(out["audio"].shape) != (
                DAC_CLIPS, dac_padded_length(dcfg, DAC_CLIP)) \
            or not bool(torch.isfinite(out["audio"]).all()):
        raise RuntimeError(f"DAC forward: codes {tuple(codes.shape)}, "
                           f"audio {tuple(out['audio'].shape)}")
    mismatch = {"forward": float((plain(x)["codes"] != codes).float()
                                 .mean()),
                "compress": float((plain.compress(
                    str(wav), win_duration=DAC_WIN).codes != f.codes)
                    .mean())}
    wave_err = {"padded": float((plain.decode_codes(codes)
                                 - model.decode_codes(codes)).abs().max()),
                "window": float((plain.decode_codes(
                    f.codes[..., :f.chunk_length], False)
                    - model.decode_codes(f.codes[..., :f.chunk_length],
                                         False)).abs().max())}
    if max(mismatch.values()) > CODE_MISMATCH_MAX \
            or max(wave_err.values()) > WAVE_ATOL:
        raise RuntimeError(f"DAC: codes against the plain argmin "
                           f"{mismatch}, the same codes decoded {wave_err}")
    print(f"  DAC ({n_params / 1e6:.2f}M parameters): forward of "
          f"{DAC_CLIPS} x {DAC_CLIP / sr:g} s and compress of "
          f"{DAC_FILE_SECONDS} s ({windows} windows of {DAC_WIN:g} s): "
          f"argmin launches {launches['codebook_argmin']} as predicted "
          f"({len(fwd_calls)} + {dcfg['n_codebooks']} x {windows}); codes "
          f"against the plain argmin {mismatch} (<= 0.2%); the same codes "
          f"decoded within {wave_err} (<= 5e-4)", flush=True)

    model_dir = tmp / "dac_model"
    model_dir.mkdir()
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               model_dir / "model.pth")
    common = ["--model_path", str(model_dir), "--config", str(DAC_YAML)]
    said, enc_s = run_module("esc_tpu_torch.baselines.dac", [
        "encode", str(wav), "--output", str(tmp / "cli.dac"), *common])
    said2, dec_s = run_module("esc_tpu_torch.baselines.dac", [
        "decode", str(tmp / "cli.dac"), "--output", str(tmp / "cli.wav"),
        *common])
    g = DACFile.load(str(tmp / "cli.dac"))
    y = load_wav(str(tmp / "cli.wav"))
    cli_mismatch = float((g.codes != f.codes).mean()) \
        if g.codes.shape == f.codes.shape else 1.0
    if "model.pth" not in said or "model.pth" not in said2 \
            or cli_mismatch > CODE_MISMATCH_MAX or g.original_length != L \
            or y.shape != (L,) or not np.isfinite(y).all():
        raise RuntimeError(f"DAC CLI: codes {g.codes.shape} differ from "
                           f"compress on {cli_mismatch:.4%}, decoded "
                           f"{y.shape}:\n{said}{said2}")
    print(f"  DAC CLI: encode {enc_s:.2f} s, decode {dec_s:.2f} s (process "
          f"start included); the .dac {g.codes.shape} loads, its codes "
          f"differ from compress in this process on {cli_mismatch:.4%}, the "
          f"decoded wav has the original {L} samples", flush=True)

    data = tmp / "dac_data"
    for split, f0 in (("train", 140.0), ("test", 190.0)):
        (data / split).mkdir(parents=True)
        for i in range(DAC_TRAIN_BATCH):
            save_wav(str(data / split / f"utt_{i}.wav"),
                     speech_like(rng, DAC_TRAIN_SAMPLES, f0 + 50 * i))
    tcfg = dict(cfg, data_path=str(data), save_path=str(tmp / "dac_runs"),
                batch_size=DAC_TRAIN_BATCH, val_batch_size=DAC_TRAIN_BATCH,
                num_iters=DAC_STEPS, valid_freq=DAC_STEPS, log_every=1,
                num_workers=2, seed=SEED)
    trainer = DACTrainer(tcfg, adversarial=True, device=dev)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _, train_launches = counted(
            kern, f"DACTrainer.train, {DAC_STEPS} steps and a validation",
            lambda: trainer.train(DAC_STEPS), expect={"codebook_argmin"})
    said = log.getvalue()
    print(said, end="", flush=True)
    logged = _iter_lines(said)
    val_calls = dac_forward_calls(dcfg, DAC_TRAIN_BATCH,
                                  DAC_TRAIN_SAMPLES - 80)
    if len(logged) != DAC_STEPS or not all(
            np.isfinite(v) for line in logged for v in line.values()) \
            or train_launches["codebook_argmin"] != len(val_calls):
        raise RuntimeError(f"DACTrainer logged {logged}, launched "
                           f"{train_launches} (validation {len(val_calls)})")
    for tag in ("latest", "best"):
        payload = load_checkpoint(str(tmp / "dac_runs" / f"{tag}.ckpt"))
        DAC(device="cpu", **dcfg).load_state_dict(
            from_jax_params(payload["model_state_dict"]))
        Discriminator(**cfg["Discriminator"]).load_state_dict(
            from_jax_params(payload["model_disc_state_dict"]))
        if payload["step"] != DAC_STEPS:
            raise RuntimeError(f"{tag}.ckpt at step {payload['step']}")
    batch = np.stack([load_wav(str(data / "train" / f"utt_{i}.wav"))[:-80]
                      for i in range(DAC_TRAIN_BATCH)])
    n_q = trainer.dropout(DAC_TRAIN_BATCH)
    timer = StepTimer(dev, warmup=1)
    torch.cuda.reset_peak_memory_stats()

    def steps():
        for _ in range(DAC_TIMED_STEPS):
            timer.tic()
            trainer.train_step(batch, n_q)
            timer.toc()

    counted(kern, f"{DAC_TIMED_STEPS} DAC training steps", steps, ran=False)
    peak = torch.cuda.max_memory_allocated()
    rate = timer.summary()["steps_per_s"]
    with tempfile.TemporaryDirectory() as logdir:
        with trace(logdir):
            with annotate("dac_roundtrip"):
                model.decode_codes(model.encode_codes(x[:1]))
        traces = list(Path(logdir).glob("*.json"))
        text = traces[0].read_text() if len(traces) == 1 else ""
    if "dac_roundtrip" not in text or "codebook_argmin" not in text:
        raise RuntimeError(f"trace(): {len(traces)} files, the annotation "
                           "or the argmin kernel missing")
    print(f"  DACTrainer ({DAC_STEPS} adversarial steps at batch "
          f"{DAC_TRAIN_BATCH} x {(DAC_TRAIN_SAMPLES - 80) / sr:.3f} s, a "
          f"validation): losses finite, the argmin {len(val_calls)} times "
          f"in the validation and never in a step; latest and best.ckpt "
          f"load; trace() wrote {traces[0].name} with the annotation and "
          "the argmin kernel", flush=True)
    print(f"dac: {rate:.3f} adversarial DAC steps per second "
          f"(StepTimer tic/toc, {DAC_TIMED_STEPS} steps, the first left "
          f"out), peak memory {peak / 2 ** 30:.3f} GiB (DAC "
          f"{n_params / 1e6:.2f}M + the config's discriminator, batch "
          f"{DAC_TRAIN_BATCH}, fp32, TF32 off)", flush=True)
    return {"params": n_params, "launches": launches, "windows": windows,
            "mismatch": mismatch, "wave_err": wave_err,
            "cli_s": {"encode": enc_s, "decode": dec_s},
            "cli_mismatch": cli_mismatch, "train_losses": logged,
            "train_launches": train_launches, "steps_per_s": rate,
            "peak_bytes": peak}, file_calls, launches


# ------------------------------------------------------------ phase 12
def check_encodec(kern, dev, rng, tmp: Path, smi: str) -> dict:
    """Phase 12: EnCodec 24 kHz as published (encodec_24khz, random weights
    from seed 0) through its comparison wrapper at 1.5, 6 and 24 kbps on 4
    generated clips of 3 s at 16 kHz, resampled in and out, with no kernel
    launch (esc_tpu's EnCodec runs no Pallas kernel); codes and the same
    codes' waveforms, card against CPU; a release-format file through
    ``load_torch_weights``; real-time factor, encode and decode ms and peak
    memory at 6 and 24 kbps."""
    from esc_tpu_torch.baselines.encodec import Encodec
    from esc_tpu_torch.ops.resample import resample

    x = torch.tensor(np.stack([
        speech_like(rng, ENCODEC_SECONDS * ENCODEC_SR, 110.0 + 45 * i)
        for i in range(ENCODEC_CLIPS)]))
    model = Encodec(bandwidth=6.0, seed=SEED, device=dev)
    cpu = Encodec(bandwidth=6.0, seed=SEED, device="cpu")
    n_params = model.num_params()
    model(x, ENCODEC_SR)                        # warm-up, not counted
    for kbps in ENCODEC_BANDWIDTHS:
        model.set_target_bandwidth(kbps)
        recon, _ = counted(kern, f"the EnCodec wrapper at {kbps} kbps",
                           lambda: model(x, ENCODEC_SR), ran=False)
        if recon.shape != x.shape or not bool(torch.isfinite(recon).all()):
            raise RuntimeError(f"EnCodec at {kbps} kbps gave "
                               f"{tuple(recon.shape)}, finite "
                               f"{bool(torch.isfinite(recon).all())}")

    # the codec alone, on one 24 kHz input: the stages of a lower bandwidth
    # are the first of 24 kbps's
    x24 = resample(x, ENCODEC_SR, model.sample_rate)
    model.set_target_bandwidth(24.0)
    cpu.set_target_bandwidth(24.0)
    ours, theirs = model.encode(x24).cpu(), cpu.encode(x24)
    mismatch, wave_err = {}, {}
    for kbps in ENCODEC_BANDWIDTHS:
        model.set_target_bandwidth(kbps)
        n_q = model.n_q
        mismatch[kbps] = float((ours[:, :n_q] != theirs[:, :n_q]).float()
                               .mean())
        wave_err[kbps] = float((model.decode(theirs[:, :n_q]).cpu()
                                - cpu.decode(theirs[:, :n_q])).abs().max())
        print(f"  EnCodec at {kbps} kbps ({n_q} codebooks): codes card vs "
              f"CPU {mismatch[kbps]:.2e} off, the CPU's codes decoded on "
              f"both within {wave_err[kbps]:.2e}", flush=True)
    if max(mismatch.values()) > CODE_MISMATCH_MAX or \
            max(wave_err.values()) > WAVE_ATOL:
        raise RuntimeError(f"EnCodec card vs CPU: codes {mismatch} off "
                           f"(bar {CODE_MISMATCH_MAX}), waveforms "
                           f"{wave_err} (bar {WAVE_ATOL})")

    # a release-format file: {"best_state": ...} with the EMA buffers
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    for q in range(model.module.n_q):
        pre = f"quantizer.vq.layers.{q}._codebook."
        sd[pre + "inited"] = torch.ones(1)
        sd[pre + "cluster_size"] = torch.ones(model.module.bins)
        sd[pre + "embed_avg"] = sd[pre + "embed"].clone()
    torch.save({"best_state": sd}, tmp / "encodec_24khz.th")
    loaded = Encodec(bandwidth=24.0, seed=SEED + 1, device=dev)
    loaded.load_torch_weights(str(tmp / "encodec_24khz.th"))
    model.set_target_bandwidth(24.0)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        same = torch.equal(loaded.encode(x24), model.encode(x24))
    if not same:
        raise RuntimeError("the release-format file gave other codes")
    print(f"  a release-format file ({len(sd)} keys, {3 * model.module.n_q}"
          " of them EMA buffers) loads strictly: the same codes", flush=True)

    timing = {}
    x24d = x24.to(dev)
    audio_s = ENCODEC_CLIPS * ENCODEC_SECONDS
    for kbps in ENCODEC_TIMED:
        model.set_target_bandwidth(kbps)
        codes = model.encode(x24d)
        enc_ms = call_ms(lambda: model.encode(x24d), reps=10)
        dec_ms = call_ms(lambda: model.decode(codes), reps=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rt_ms = call_ms(lambda: model(x, ENCODEC_SR), reps=10)
        peak = torch.cuda.max_memory_allocated()
        timing[kbps] = {"encode_ms": enc_ms, "decode_ms": dec_ms,
                        "roundtrip_ms": rt_ms, "rtf": audio_s * 1e3 / rt_ms,
                        "peak_bytes": peak}
        print(f"encodec: {kbps} kbps, {ENCODEC_CLIPS} x {ENCODEC_SECONDS} s"
              f" at {ENCODEC_SR} Hz: roundtrip {rt_ms:.2f} ms (resampling "
              f"in and out), real-time factor {audio_s * 1e3 / rt_ms:.1f}; "
              f"encode {enc_ms:.2f} ms, decode {dec_ms:.2f} ms at 24 kHz; "
              f"peak memory {peak / 2 ** 30:.3f} GiB (fp32, TF32 off; "
              f"{smi})", flush=True)
    return {"params": n_params, "mismatch": mismatch, "wave_err": wave_err,
            "timing": timing}


def _flat_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def profile_once(what: str, fn, top: int = 12) -> dict:
    """Wall time, device busy time and the top kernels of one ``fn()``
    after a warm-up, by ``torch.profiler``: printed, and returned as
    ``{"wall_ms", "device_ms", "launches"}`` (empty where the profiler
    recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = [e for e in prof.key_averages() if _on_device(e)]
    dev_us = sum(e.self_device_time_total for e in events)
    if dev_us <= 0:
        print(f"  {what}: the profiler recorded no device time: not "
              "measured", flush=True)
        return {}
    launches = sum(e.count for e in events)
    print(f"  {what}: wall {wall * 1e3:.2f} ms, device busy "
          f"{dev_us / 1e3:.2f} ms ({dev_us / 1e3 / (wall * 1e3):.1%}), "
          f"{launches} kernel launches", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms "
              f"({e.self_device_time_total / dev_us:5.1%}) "
              f"x{e.count:<4d} {e.key[:90]}", flush=True)
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "launches": launches}


def profile_adv(trainer, x) -> dict:
    """Phase 4's view of one adversarial step of phase 7: the step, its
    generator half and its discriminator half, each profiled apart, and
    the MRD spectrograms' share of the step's device time (a forward of the
    three on the fake and on the real in each half, and the backward of the
    fake's in the generator's: five products of each DFT a step)."""
    from esc_tpu_torch.models.discriminator import MRD

    step = profile_once("one adversarial step (phase 7)",
                        lambda: trainer.train_step(x, 6, False), top=16)
    gen = profile_once("  its generator half (steps 1-3)",
                       lambda: trainer.generator_step(x, 6, False), top=6)
    recon = trainer.generator_step(x, 6, False)[1]
    disc = profile_once("  its discriminator half (steps 4-5)",
                        lambda: trainer.discriminator_step(recon, x, False),
                        top=6)
    mrds = [d for d in trainer.disc.discriminators if isinstance(d, MRD)]
    y = trainer.disc.preprocess(x)
    spec_ms = device_ms(lambda: [m.spectrogram(y) for m in mrds], reps=5)
    out = {"step": step, "generator": gen, "discriminator": disc,
           "mrd_spectrograms_ms": spec_ms}
    if step and gen and disc:
        halves = gen["device_ms"] + disc["device_ms"]
        out.update(generator_share=gen["device_ms"] / halves,
                   discriminator_share=disc["device_ms"] / halves,
                   mrd_spectrogram_share=5 * spec_ms / step["device_ms"])
        print(f"  adversarial step's device time: generator half "
              f"{out['generator_share']:.1%}, discriminator half "
              f"{out['discriminator_share']:.1%}; the MRD spectrograms "
              f"(FFT {', '.join(str(m.window_length) for m in mrds)}) "
              f"{spec_ms:.3f} ms a forward of the three, ~"
              f"{out['mrd_spectrogram_share']:.1%} of the step", flush=True)
    return out


def time_kernels(kern, rng, dev, clock):
    """Each kernel by ``clock`` at the calls of one roundtrip at ns 6 (the
    LayerNorm kernel where the package has one)."""
    argmin_calls, attn_calls = main_path_calls(ESC_BASE, BATCH, CLIP, 6)
    out = {"codebook_argmin": time_argmin(kern, rng, dev, argmin_calls,
                                          clock),
           "window_attention": time_attention(kern, rng, dev, attn_calls,
                                              clock)}
    if "layer_norm" in kern:
        out["layer_norm"] = time_layer_norm(
            kern, rng, dev, layer_norm_calls(ESC_BASE, BATCH, CLIP, 6), clock)
    return out


def time_ablations(kern, rng, dev) -> dict:
    """Device ms of each kernel, its plain version and the library call,
    summed over the calls of one roundtrip at ns 6 of each ablation, with
    the bound and the launches: codec -> kernel -> numbers."""
    from esc_tpu_torch.utils.config import read_yaml

    out = {}
    for name, path in ABLATION_YAMLS.items():
        cfg = read_yaml(str(path))["model"]
        calls = dict(zip(("codebook_argmin", "window_attention"),
                         ablation_calls(cfg, name, BATCH, CLIP, 6)))
        out[name] = {}
        for kname, kcalls in calls.items():
            if not kcalls:
                continue
            tm = (time_argmin if kname == "codebook_argmin"
                  else time_attention)(kern, rng, dev, kcalls, "device")
            b_ms, b_by = bound_ms(tm["bytes"], tm["flops"])
            out[name][kname] = {
                "ms": tm["device_ms"], "plain_ms": tm["plain_ms"],
                "library_ms": tm["library_ms"], "bound_ms": b_ms,
                "bound_by": b_by, "launches": len(kcalls)}
            print(f"  {name}: {kname} per roundtrip at ns=6 ({len(kcalls)} "
                  f"launches), device ms: kernel {tm['device_ms']:.4f}, "
                  f"plain {tm['plain_ms']:.4f}, library "
                  f"{tm['library_ms']:.4f}, bound {b_ms:.4f} ({b_by})",
                  flush=True)
    return out


def kernel_times(root: str) -> int:
    """Phase 2's timing alone, for the esc_tpu_torch package under ``root``
    (another checkout, e.g. a parent commit unpacked with ``git archive``):
    one JSON line of per-roundtrip device and call ms. Run two checkouts in
    turns in one session to compare them on one card."""
    sys.path.insert(0, os.path.abspath(root))
    import esc_tpu_torch
    from esc_tpu_torch.ops.kernels import KERNELS
    if not esc_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"esc_tpu_torch came from {esc_tpu_torch.__file__}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    times = time_kernels(KERNELS, rng, dev, "call")
    for name, tm in time_kernels(KERNELS, rng, dev, "device").items():
        times[name].update(tm)
    print(json.dumps({"from": root, "kernels": {
        name: {k: tm[k] for k in ("device_ms", "call_ms")}
        for name, tm in times.items()}}), flush=True)
    return 0


def data_parallel_alone() -> int:
    """Phase 8 alone, on every card of the host; its JSON line last."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        result = check_data_parallel(np.random.default_rng(SEED), Path(tmp))
    phase("8 dp", t0, f"--num_devices {result['cards']} ok")
    print(json.dumps({"dp": result}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if len(sys.argv) == 3 and sys.argv[1] == "--kernels-from":
        return kernel_times(sys.argv[2])
    if sys.argv[1:] == ["--data-parallel"]:
        return data_parallel_alone()
    t0 = time.time()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = phase("0 card", t0, f"torch {torch.__version__}, CUDA "
               f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    from esc_tpu_torch.cli.compress import compress_file
    from esc_tpu_torch.io import save_wav
    from esc_tpu_torch.models import make_model
    from esc_tpu_torch.ops.kernels import KERNELS, _build
    from esc_tpu_torch.utils.config import read_yaml

    from esc_tpu_torch import rangecoder

    compiles, link = _build.nvcc_commands(_build.library_path())
    for cmd in compiles + [link]:
        print("  " + " ".join(cmd), flush=True)
    path, built = _build.build()
    _build.library()
    rc_path, rc_built = rangecoder.build()
    for line in _build.build_log().splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            print("  ptxas: " + line.strip().removeprefix("ptxas info    :")
                  .strip(), flush=True)
    t0 = phase("1 build", t0, f"{'built' if built else 'found'} "
               f"{os.path.relpath(path)}; range coder "
               f"{'built' if rc_built else 'found'} "
               f"{os.path.relpath(rc_path)}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    argmin_calls, attn_calls = main_path_calls(ESC_BASE, BATCH, CLIP, 6)
    attn_shapes = sorted({(G, nh, hd) for G, nh, hd, _ in attn_calls})
    # phase 3c's 25 s file: its whole-file and chunked calls, batch 1;
    # phase 5's eval batch at every num_streams and phase 6's validation
    # batch, with the published config (codebook dims 32 to 6)
    published = read_yaml(str(ESC_BASE_YAML))["model"]
    whole, chunked = cli_calls(published)
    sweep_calls, val_calls = eval_calls(published)
    # phase 7's evaluation: the adversarial config's model (codebook dims 8)
    adv_val = main_path_calls(read_yaml(str(ESC_ADV_YAML))["model"],
                              TRAIN_BATCH, TRAIN_SAMPLES - 80,
                              ESC_BASE["max_streams"], forward=True)
    # phase 11's DAC (K 1024, d 8): its forward, the windows of its
    # compress and its trainer's validation
    dac_cfg = read_yaml(str(DAC_YAML))["DAC"]
    dac_argmin = (dac_forward_calls(dac_cfg, DAC_CLIPS, DAC_CLIP)
                  + dac_compress_calls(dac_cfg, DAC_FILE_SECONDS
                                       * dac_cfg["sample_rate"])
                  + dac_forward_calls(dac_cfg, DAC_TRAIN_BATCH,
                                      DAC_TRAIN_SAMPLES - 80))
    sweep_argmin = [c for a, _ in sweep_calls for c in a]
    sweep_attn = {(G, nh, hd) for _, t in sweep_calls for G, nh, hd, _ in t}
    argmin_err = check_argmin(KERNELS, rng, dev, whole[0] + chunked[0]
                              + sweep_argmin + val_calls[0] + adv_val[0]
                              + dac_argmin)
    attn_err = check_attention(KERNELS, rng, dev, attn_shapes + ATTN_RAGGED
                               + ATTN_WIDE + sorted(sweep_attn))
    attn_err = max(attn_err, check_attention(
        KERNELS, rng, dev, sorted({(G, nh, hd) for G, nh, hd, _ in
                                   whole[1] + chunked[1]}), batch=1))
    attn_err = max(attn_err, check_attention(
        KERNELS, rng, dev, sorted({(G, nh, hd) for G, nh, hd, _ in
                                   val_calls[1] + adv_val[1]}),
        batch=TRAIN_BATCH))
    norm_calls = layer_norm_calls(ESC_BASE, BATCH, CLIP, 6)
    ln_err = check_layer_norm(KERNELS, rng, dev,
                              sorted(set(norm_calls)) + LN_RAGGED)
    # call times here, device times in phase 4: a profiler session slows
    # the host's later launches, which would show in phase 3
    timing = time_kernels(KERNELS, rng, dev, "call")
    t0 = phase("2 kernels", t0, "all kernels agree with their plain versions")

    model = make_model(ESC_BASE, seed=SEED, device=dev)
    plain_model = make_model(ESC_BASE, seed=SEED, device=dev, plain_ops=True)
    x = torch.tensor(0.1 * rng.standard_normal((BATCH, CLIP)),
                     dtype=torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        save_wav(os.path.join(tmp, "clip.wav"), 0.5 * x[0].numpy())
        model.roundtrip(x, num_streams=6)          # warm-up, not counted
        torch.cuda.synchronize()
        for wrapper, _ in KERNELS.values():
            wrapper.launches = 0
        with eager_codecs():
            out, cli = drive_main_path(model, x, compress_file, tmp)
        launches = {name: wrapper.launches
                    for name, (wrapper, _) in KERNELS.items()}
        print(f"  launches on the main path: {launches}", flush=True)
        if min(launches.values()) == 0:
            raise RuntimeError(f"a kernel never ran on the main path: "
                               f"{launches}")
        check_main_path(model, plain_model, x, out, cli, tmp)

    per_rt = {"codebook_argmin": len(argmin_calls),
              "window_attention": len(attn_calls),
              "layer_norm": len(norm_calls)}
    if norm_launches(attn_calls, ESC_BASE["swin_depth"], 1) != len(
            norm_calls):
        raise RuntimeError("the LayerNorm calls and the attention calls of "
                           "a roundtrip disagree")
    for name in KERNELS:
        wrapper = KERNELS[name][0]
        wrapper.launches = 0
    with eager_codecs():
        model.roundtrip(x, num_streams=6)
    got = {name: w.launches for name, (w, _) in KERNELS.items()}
    if got != per_rt:
        raise RuntimeError(f"launches per roundtrip {got}, expected {per_rt}")
    print(f"  launches per roundtrip at ns=6: {got}", flush=True)
    audio_s = BATCH * CLIP / ESC_BASE["sr"]
    rtf = {}
    for label, m in (("kernels", model), ("plain", plain_model)):
        m.roundtrip(x, num_streams=6)
        torch.cuda.synchronize()
        reps = 10
        start = time.perf_counter()
        for _ in range(reps):
            m.roundtrip(x, num_streams=6)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) / reps
        rtf[label] = audio_s / wall
        print(f"  roundtrip ns=6, {BATCH} x 3 s on {label}: {wall * 1e3:.2f} "
              f"ms, real-time factor {rtf[label]:.1f}", flush=True)
    t0 = phase("3 main", t0, f"ESC-Base serving ok, real-time factor "
               f"{rtf['kernels']:.1f} (plain {rtf['plain']:.1f})")

    xd = x.to(dev)
    bf16_agree, bf16_rtf = check_bf16(KERNELS, model, xd, out)
    t0 = phase("3b bf16", t0, f"bf16 serving ok, real-time factor "
               f"{bf16_rtf['bf16']} (fp32 {bf16_rtf['fp32']})")
    with tempfile.TemporaryDirectory() as tmp:
        cli_run = check_cli(KERNELS, dev, rng, tmp, chunked)
    t0 = phase("3c cli", t0, "the compress CLI ok, fp32 and bf16 chunked")
    serving = check_serving(KERNELS, model, rng)
    t0 = phase("3d serving", t0, "stream_roundtrip ok")
    # phase 5's clips and model directory serve phase 10's test CLI too
    eval_tmp = tempfile.TemporaryDirectory()
    evaluation = check_eval(KERNELS, dev, rng, Path(eval_tmp.name),
                            sweep_calls)
    t0 = phase("5 eval", t0, "the test CLI and the eval sweep ok")
    with tempfile.TemporaryDirectory() as tmp:
        training, train_step = check_train(KERNELS, dev, rng, Path(tmp),
                                           val_calls)
    t0 = phase("6 train", t0, "the train CLI and training steps ok")
    with tempfile.TemporaryDirectory() as tmp:
        adversarial, adv_trainer, adv_x = check_adv(KERNELS, dev, rng,
                                                    Path(tmp), adv_val)
    t0 = phase("7 adv", t0, "the adversarial train CLI, its finetuning "
               "and adversarial steps ok")
    with tempfile.TemporaryDirectory() as tmp:
        data_parallel = check_data_parallel(rng, Path(tmp))
    t0 = phase("8 dp", t0, f"--num_devices {data_parallel['cards']} ok")
    ablations = {"roundtrips": check_ablation_roundtrips(KERNELS, dev, rng),
                 "rvq": check_standalone_rvq(KERNELS, dev)}
    with tempfile.TemporaryDirectory() as tmp:
        ablations["clis"] = check_ablation_clis(KERNELS, dev, rng, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        ablations["train"] = check_ablation_training(KERNELS, dev, rng,
                                                     Path(tmp))
    t0 = phase("9 ablation", t0, "rvq+swinT, csvq+conv and rvq+conv: "
               "roundtrips, the three CLIs, training and its refusal, "
               "checkpoints; the standalone residual VQ ok")
    with eval_tmp:
        multicard, dp_launches = check_multicard(
            KERNELS, dev, rng, evaluation.pop("dirs"),
            evaluation["perf_stats_cli"])
    t0 = phase("10 multicard", t0, f"chunked serving and --data_parallel "
               f"over {multicard['cards']} card(s) ok")
    with tempfile.TemporaryDirectory() as tmp:
        dac, dac_file_calls, dac_launches = check_dac(KERNELS, dev, rng,
                                                      Path(tmp))
    t0 = phase("11 dac", t0, "the DAC's forward, compress, CLI, trainer "
               "and trace ok")
    with tempfile.TemporaryDirectory() as tmp:
        encodec = check_encodec(KERNELS, dev, rng, Path(tmp), smi)
    t0 = phase("12 encodec", t0, "EnCodec 24 kHz: the wrapper at "
               f"{', '.join(map(str, ENCODEC_BANDWIDTHS))} kbps, card vs "
               "CPU, a release-format file ok")

    replay = check_replay(model, x, per_rt)
    for what, fn in (("one roundtrip", lambda: model.roundtrip(
            x, num_streams=6)), ("one training step (phase 6)", train_step)):
        profile_once(what, fn)
    adversarial["profile"] = profile_adv(adv_trainer, adv_x)
    for name, tm in time_kernels(KERNELS, rng, dev, "device").items():
        timing[name].update(tm)
    wide = time_wide(KERNELS, rng, dev)
    ablation_timing = time_ablations(KERNELS, rng, dev)
    dac_timing = time_argmin(KERNELS, rng, dev, dac_file_calls, "device")
    dac_bound = bound_ms(dac_timing["bytes"], dac_timing["flops"])
    print(f"  codebook_argmin per {DAC_FILE_SECONDS} s DAC compress "
          f"({len(dac_file_calls)} launches), device ms: kernel "
          f"{dac_timing['device_ms']:.4f}, plain {dac_timing['plain_ms']:.4f}"
          f", library {dac_timing['library_ms']:.4f}, bound "
          f"{dac_bound[0]:.4f} ({dac_bound[1]})", flush=True)
    for name, tm in timing.items():
        library = (f", library {tm['library_ms']:.4f} / "
                   f"{tm['library_call_ms']:.4f}" if "library_ms" in tm
                   else "")
        print(f"  {name} per roundtrip at ns=6, device / call ms: kernel "
              f"{tm['device_ms']:.4f} / {tm['call_ms']:.4f}, plain "
              f"{tm['plain_ms']:.4f} / {tm['plain_call_ms']:.4f}{library}, "
              f"bound {bound_ms(tm['bytes'], tm['flops'])[0]:.4f}",
              flush=True)
    t0 = phase("4 profile", t0)

    summary = []
    for name, src, replaces, err in (
            ("codebook_argmin", "esc_tpu_torch/csrc/codebook_argmin.cu",
             "esc_tpu/ops/pallas/vq_kernels.py:56", argmin_err),
            ("window_attention", "esc_tpu_torch/csrc/window_attention.cu",
             "esc_tpu/ops/pallas/attention_kernels.py:131", attn_err),
            ("layer_norm", "esc_tpu_torch/csrc/layer_norm.cu", None,
             ln_err)):
        tm = timing[name]
        b_ms, b_by = bound_ms(tm["bytes"], tm["flops"])
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": tm["device_ms"],
            "device_ms": tm["device_ms"], "call_ms": tm["call_ms"],
            "plain_ms": tm["plain_ms"], "plain_call_ms": tm["plain_call_ms"],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": tm.get("library_ms"),
            "library_call_ms": tm.get("library_call_ms"),
            "wide": wide.get(name),
            "eval_launches": evaluation["launches"][name],
            "adv_step_launches": adversarial["step_launches"][name],
            "adv_eval_launches": adversarial["eval_launches"][name],
            "ablation": {codec: tms[name] for codec, tms in
                         ablation_timing.items() if name in tms},
            "dac_launches": dac_launches[name],
            "rvq_launches": {ns: {path: counts[name] for path, counts in
                                  by_path.items()} for ns, by_path in
                             ablations["rvq"]["launches"].items()},
            "chunked_dp_launches": dp_launches[name],
            "replay_launches": replay[name]})
    summary[0]["dac"] = {
        "shape": f"{len(dac_file_calls)} x {dac_file_calls[0]} per "
                 f"{DAC_FILE_SECONDS} s compress",
        "ms": dac_timing["device_ms"], "plain_ms": dac_timing["plain_ms"],
        "library_ms": dac_timing["library_ms"], "bound_ms": dac_bound[0],
        "bound_by": dac_bound[1], "launches": len(dac_file_calls)}
    print(json.dumps({"paths": {
        "bf16_code_agreement": bf16_agree, "real_time_factor": {
            "fp32_plain": rtf["plain"], "fp32_kernels": rtf["kernels"],
            **{f"{k}_phase_3b": v for k, v in bf16_rtf.items()},
            **{f"stream_{k}": v for k, v in serving.items()}},
        "cli": cli_run, "eval": evaluation, "train": training,
        "adv": adversarial, "dp": data_parallel, "ablation": ablations,
        "multicard": multicard, "dac": dac, "encodec": encodec}}),
        flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
