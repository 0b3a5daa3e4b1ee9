"""DAC's training losses, each a scalar (ESC's are per sample).

Port of ``esc_tpu/baselines/dac/losses.py`` (reference:
baselines/descript/dac/nn/loss.py): L1 on the waveform, the multi-scale
log-magnitude STFT loss, the multi-scale mel loss and negative SI-SDR, on
the port's DFT-as-one-product spectra (:mod:`esc_tpu_torch.ops.stft`,
:mod:`esc_tpu_torch.ops.mel`). Each crops both waveforms to the shorter.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ...metrics import sisdr
from ...ops.constants import on_device
from ...ops.mel import MEL_BINS, MEL_WINDOWS, mel_spectrogram, reflect_index
from ...ops.stft import _dft_matrices

__all__ = ["l1_loss", "multi_scale_stft_loss", "mel_spectrogram_loss",
           "sisdr_loss"]


def _crop(x: torch.Tensor, y: torch.Tensor):
    n = min(x.shape[-1], y.shape[-1])
    return x[..., :n], y[..., :n]


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean absolute waveform error (loss.py:11-49)."""
    x, y = _crop(x, y)
    return (x - y).abs().mean()


def _mag_stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Magnitude STFT ``(B, T, n_fft // 2 + 1)``: reflect-centred frames,
    a periodic Hann window of ``n_fft``, ``T = L // hop + 1``
    (``esc_tpu/baselines/dac/losses.py:29-41``)."""
    B, L = x.shape
    T = L // hop + 1
    pad = n_fft // 2
    n = torch.full((1,), L, device=x.device)
    xp = x.float()[:, reflect_index(L, pad, n)[0]]
    frames = xp.unfold(-1, n_fft, hop)[:, :T]
    spec = frames @ on_device(_dft_matrices, (n_fft, n_fft), 0, x.device)
    spec = spec.reshape(B, T, 2, n_fft // 2 + 1)
    return torch.sqrt((spec * spec).sum(2) + 1e-24)


def multi_scale_stft_loss(x: torch.Tensor, y: torch.Tensor,
                          window_lengths: Sequence[int] = (2048, 512),
                          clamp_eps: float = 1e-5, mag_weight: float = 1.0,
                          log_weight: float = 1.0) -> torch.Tensor:
    """Magnitude and log-magnitude L1 over windows of several lengths, hop
    a quarter window (loss.py:142-229)."""
    x, y = _crop(x, y)
    loss = 0.0
    for w in window_lengths:
        xm, ym = _mag_stft(x, w, w // 4), _mag_stft(y, w, w // 4)
        lx = torch.log10(xm.clamp_min(clamp_eps) ** 2)
        ly = torch.log10(ym.clamp_min(clamp_eps) ** 2)
        loss = loss + log_weight * (lx - ly).abs().mean()
        loss = loss + mag_weight * (xm - ym).abs().mean()
    return loss


def mel_spectrogram_loss(x: torch.Tensor, y: torch.Tensor,
                         sample_rate: int = 16000,
                         window_lengths: Sequence[int] = tuple(MEL_WINDOWS),
                         n_mels: Sequence[int] = tuple(MEL_BINS),
                         clamp_eps: float = 1e-5, mag_weight: float = 0.0,
                         log_weight: float = 1.0) -> torch.Tensor:
    """DAC's mel loss, reduced to a scalar, ``mag_weight`` 0 by default
    (conf/16khz_dns_9k.yml's MelSpectrogramLoss)."""
    x, y = _crop(x, y)
    loss = 0.0
    for w, m in zip(window_lengths, n_mels):
        xm = mel_spectrogram(x, w, m, sample_rate)
        ym = mel_spectrogram(y, w, m, sample_rate)
        lx = torch.log10(xm.clamp_min(clamp_eps) ** 2)
        ly = torch.log10(ym.clamp_min(clamp_eps) ** 2)
        loss = loss + log_weight * (lx - ly).abs().mean()
        if mag_weight:
            loss = loss + mag_weight * (xm - ym).abs().mean()
    return loss


def sisdr_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Negative SI-SDR, the batch mean (loss.py:51-140)."""
    return -sisdr(*_crop(x, y)).mean()
