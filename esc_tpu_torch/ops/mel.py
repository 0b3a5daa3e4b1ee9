"""Mel spectrograms as ``torchaudio.transforms.MelSpectrogram`` computes them.

Port of ``esc_tpu/ops/mel.py``, used by the multi-scale mel loss and the
Mel-Distance metric: HTK mel scale, no filter normalisation, f_min 0,
f_max sr/2, power 1 (magnitude), reflect-centred frames, periodic Hann
window of ``n_fft``, hop ``n_fft // 4``. The magnitude STFT is the DFT as
one matrix product (:mod:`esc_tpu_torch.ops.stft`), in float32.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from .constants import frozen, on_device
from .stft import _dft_matrices

__all__ = ["mel_filterbank", "mel_spectrogram", "reflect_index",
           "MEL_WINDOWS", "MEL_BINS"]

# the multi-scale settings (reference: esc/modules/loss/generator_loss.py:7-8)
MEL_WINDOWS = [32, 64, 128, 256, 512, 1024, 2048]
MEL_BINS = [5, 10, 20, 40, 80, 160, 320]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=32)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int = 16000,
                   f_min: float = 0.0, f_max: Optional[float] = None
                   ) -> np.ndarray:
    """Triangular HTK mel filterbank ``(n_freqs, n_mels)`` float32, as
    ``torchaudio.functional.melscale_fbanks(norm=None, mel_scale="htk")``."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    f_pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max),
                                   n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return frozen(np.maximum(0.0, np.minimum(down, up)).astype(np.float32))


def reflect_index(L: int, pad: int, n: torch.Tensor) -> torch.Tensor:
    """Source indices of a reflect padding by ``pad`` of signals whose true
    lengths are ``n`` ``(B,)``, as ``(B, L + 2*pad)``: entry ``j`` of row
    ``b`` reads sample ``src[b, j]``. Any number of reflections folds with
    period ``2n - 2``, as ``numpy.pad(mode="reflect")`` does, where
    ``torch.nn.functional.pad`` refuses a pad not smaller than the input.
    Entries past ``n + 2*pad`` are unspecified."""
    idx = torch.arange(L + 2 * pad, device=n.device) - pad
    period = (2 * n.long() - 2).clamp_min(1)[:, None]
    m = idx.abs()[None, :] % period
    return torch.minimum(m, period - m)


def magnitude_mel(frames: torch.Tensor, n_fft: int, n_mels: int,
                  sample_rate: int) -> torch.Tensor:
    """Frames ``(B, T, n_fft)`` -> magnitude mel ``(B, n_mels, T)``: the
    windowed DFT as one product, ``sqrt(re² + im² + 1e-24)``, the bank."""
    nf = n_fft // 2 + 1
    B, T, _ = frames.shape
    fwd = on_device(_dft_matrices, (n_fft, n_fft), 0, frames.device)
    spec = (frames @ fwd).reshape(B, T, 2, nf)
    mag = torch.sqrt((spec * spec).sum(2) + 1e-24)           # (B, T, F)
    fb = on_device(mel_filterbank, (nf, n_mels, sample_rate), -1,
                   frames.device)
    return (mag @ fb).transpose(1, 2)


def mel_spectrogram(x: torch.Tensor, n_fft: int, n_mels: int,
                    sample_rate: int = 16000,
                    hop_length: Optional[int] = None) -> torch.Tensor:
    """Power-1 (magnitude) mel spectrogram of a waveform ``(B, L)``:
    ``(B, n_mels, T)`` with ``T = L // hop + 1``."""
    hop = hop_length if hop_length is not None else n_fft // 4
    B, L = x.shape
    T = L // hop + 1
    pad = n_fft // 2
    n = torch.full((1,), L, device=x.device)
    xp = x.float()[:, reflect_index(L, pad, n)[0]]
    frames = xp.unfold(-1, n_fft, hop)[:, :T]
    return magnitude_mel(frames, n_fft, n_mels, sample_rate)
