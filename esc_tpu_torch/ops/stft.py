"""Complex STFT / inverse STFT as framing + one matrix product.

Port of ``esc_tpu/ops/stft.py``: the same semantics as
``torchaudio.transforms.Spectrogram(power=None)`` / ``InverseSpectrogram``
in the reference codec (n_fft 382, periodic Hann window of 320 zero-padded
to n_fft, hop 80, reflect-centred, one-sided, no normalisation). The DFT is
the same ``(B*T, n_fft) @ (n_fft, 2F)`` product with the window folded in,
built in float64 numpy and rounded to float32 as in the JAX package, so
both compute the same sums.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .constants import frozen, on_device

__all__ = ["stft", "istft", "spec_transform", "audio_reconstruct"]


def _padded_window(n_fft: int, win_length: int) -> np.ndarray:
    """Periodic Hann window zero-padded symmetrically to n_fft (float64)."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[left:left + win_length] = w
    return out


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int, win_length: int):
    """(fwd (n_fft, 2F), inv (2F, n_fft), wsq (n_fft,)) as float32 numpy;
    see ``esc_tpu/ops/stft.py::_dft_matrices``."""
    nf = n_fft // 2 + 1
    w = _padded_window(n_fft, win_length)
    ang = 2.0 * np.pi * np.arange(nf)[:, None] * np.arange(n_fft)[None, :] \
        / n_fft
    cos, sin = np.cos(ang), np.sin(ang)
    fwd = np.concatenate([cos * w[None, :], -sin * w[None, :]], axis=0).T
    c = np.full((nf, 1), 2.0)
    c[0, 0] = 1.0
    if n_fft % 2 == 0:
        c[-1, 0] = 1.0
    inv = np.concatenate([c * cos, -c * sin], axis=0) / n_fft * w[None, :]
    return frozen(fwd.astype(np.float32), inv.astype(np.float32),
                  (w * w).astype(np.float32))


@functools.lru_cache(maxsize=32)
def _ola_envelope(n_fft: int, win_length: int, hop: int, T: int) -> np.ndarray:
    """Overlap-added squared window, zeros replaced by 1 (float32)."""
    _, _, wsq = _dft_matrices(n_fft, win_length)
    env = np.zeros((T - 1) * hop + n_fft, dtype=np.float64)
    for t in range(T):
        env[t * hop:t * hop + n_fft] += wsq
    return frozen(np.where(env > 1e-11, env, 1.0).astype(np.float32))


def stft(x: torch.Tensor, n_fft: int = 382, win_length: int = 320,
         hop_length: int = 80) -> torch.Tensor:
    """Waveform ``(B, L)`` -> ``(B, 2, F, T)`` (real, imag), ``T = L//hop+1``."""
    B, L = x.shape
    T = L // hop_length + 1
    nf = n_fft // 2 + 1
    pad = n_fft // 2
    xp = F.pad(x.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop_length)[:, :T]        # (B, T, n_fft)
    spec = frames @ on_device(_dft_matrices, (n_fft, win_length), 0,
                              x.device)                     # (B, T, 2F)
    return spec.reshape(B, T, 2, nf).permute(0, 2, 3, 1)


def istft(spec: torch.Tensor, n_fft: int = 382, win_length: int = 320,
          hop_length: int = 80, length: Optional[int] = None
          ) -> torch.Tensor:
    """``(B, 2, F, T)`` -> waveform ``(B, L)``, ``L = (T-1)*hop`` by default,
    with least-squares overlap-add normalisation (torch.istft semantics)."""
    B, _, nf, T = spec.shape
    flat = spec.permute(0, 3, 1, 2).reshape(B, T, 2 * nf).float()
    frames = flat @ on_device(_dft_matrices, (n_fft, win_length), 1,
                              spec.device)                  # (B, T, n_fft)
    total = (T - 1) * hop_length + n_fft
    y = F.fold(frames.transpose(1, 2), output_size=(1, total),
               kernel_size=(1, n_fft), stride=(1, hop_length))[:, 0, 0]
    env = on_device(_ola_envelope, (n_fft, win_length, hop_length, T), -1,
                    spec.device)
    pad = n_fft // 2
    out_len = (T - 1) * hop_length if length is None else length
    return y[:, pad:pad + out_len] / env[pad:pad + out_len]


def spec_transform(x: torch.Tensor, in_freq: int = 192, win_len: int = 20,
                   hop_len: int = 5, sr: int = 16000) -> torch.Tensor:
    """Waveform -> complex STFT feature ``(B, 2, F, T)``
    (``esc_tpu/ops/stft.py::spec_transform``)."""
    return stft(x, n_fft=(in_freq - 1) * 2,
                win_length=int(win_len * sr * 1e-3),
                hop_length=int(hop_len * sr * 1e-3))


def audio_reconstruct(feat: torch.Tensor, in_freq: int = 192,
                      win_len: int = 20, hop_len: int = 5, sr: int = 16000,
                      length: Optional[int] = None) -> torch.Tensor:
    """Complex STFT feature ``(B, 2, F, T)`` -> waveform ``(B, L)``
    (``esc_tpu/ops/stft.py::audio_reconstruct``)."""
    return istft(feat, n_fft=(in_freq - 1) * 2,
                 win_length=int(win_len * sr * 1e-3),
                 hop_length=int(hop_len * sr * 1e-3), length=length)
