"""What the drivers share: the codec pair, the serving check, the device.

:func:`codec_pair` builds the plain reference (``portbench/reference/``)
on the device, fills its weights from the seed and hands the same state
dict to the program's ``ESC`` (``Codec.load_state_dict`` takes the
reference's keys). :func:`check_serving` judges what the program served
against the reference, once the window has closed:

- ``code_gap``: the reference walks the encoder and every scale's product
  VQ, taking the program's codes as given, and reads by how much each
  code's distance lies above the nearest codeword's (0 where it is the
  nearest; the widest over every code of the sample). It covers the STFT,
  the encoder, each scale's residual and the argmin;
- ``wave_gap``: the reference decodes the program's codes; the widest
  absolute difference from the program's waveform, over the widest
  absolute sample of the reference's. It covers the decoder, the
  attention and the ISTFT.
"""

from __future__ import annotations

import gc
import subprocess

import torch

from portbench.reference import esc as ref_esc
from portbench.reference.weights import fill, seeded_generator

__all__ = ["codec_pair", "check_serving", "free_device", "peak_memory",
           "sync", "card_line"]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def codec_pair(run, gen: torch.Generator):
    """(reference ESC on the CPU, the program's ESC on the device), with
    the same weights drawn from ``gen``."""
    from esc_tpu_torch.models import make_model

    cfg = run.config["model"]
    with torch.device(run.device):
        ref = ref_esc.ESC(**cfg)
    fill(ref, gen)
    model = make_model(dict(cfg, backbone="transformer"),
                       run.config["model_name"], device=run.device)
    model.load_state_dict(ref.state_dict())
    return ref.cpu(), model


@torch.no_grad()
def check_serving(run, ref, samples) -> None:
    """``samples``: (input (B, L), codes (B, s, groups, T), waveform) host
    arrays of what the program served."""
    ref.to(run.device)
    code_gap = wave_gap = 0.0
    for x, codes, wave in samples:
        x = torch.as_tensor(x, device=run.device)
        codes = torch.as_tensor(codes, device=run.device).long()
        gap, shape = ref.code_gaps(x, codes)
        code_gap = max(code_gap, gap)
        y = ref.decode(codes, shape)
        got = torch.as_tensor(wave, device=run.device)
        wave_gap = max(wave_gap, float((got - y).abs().max()
                                       / y.abs().max()))
    run.check("code_gap", code_gap)
    run.check("wave_gap", wave_gap)
    ref.cpu()


def free_device(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def peak_memory(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def card_line() -> str:
    """The card's name, power limit and clocks, by ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return "card: " + out.replace("\n", " | ")
