"""Evaluation metrics: PESQ, STOI, Mel distance, SI-SDR and the codebook
utilisation counter.

Port of ``esc_tpu/metrics.py`` (reference: scripts/metrics.py). Mel distance
and SI-SDR run on the tensors' device, batched, and return per-utterance
scores as numpy; so does the code histogram. PESQ and STOI score on the
host: the ``pesq`` C library where it imports, else the port's numpy
P.862.2 model (:mod:`esc_tpu_torch.metrics_pesq`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .metrics_stoi import STOI  # noqa: F401  (a metric of the eval sweep)
from .ops.mel import (MEL_BINS, MEL_WINDOWS, magnitude_mel, mel_spectrogram,
                      reflect_index)

__all__ = ["PESQ", "STOI", "MelSpectrogramDistance", "SISDR",
           "EntropyCounter", "mel_distance", "sisdr", "mel_distance_masked",
           "sisdr_masked", "HAVE_PESQ", "PESQ_BACKEND"]

SR = 16000

try:
    from pesq import pesq as _pesq_fn  # the ITU-T P.862 C implementation
    HAVE_PESQ = True
except ImportError:
    _pesq_fn = None
    HAVE_PESQ = False

PESQ_BACKEND = "pesq-c" if HAVE_PESQ else "numpy-p862"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


class PESQ:
    """Batch PESQ-WB (scripts/metrics.py:79-94): the ITU C library where it
    imports, the numpy P.862.2 model otherwise (:data:`PESQ_BACKEND`). NaN
    for rows the scorer rejects. ``lengths`` limits each row to its true
    length."""

    def __call__(self, x, y, lengths=None) -> np.ndarray:
        x, y = _host(x), _host(y)
        if HAVE_PESQ:
            def score(a, b):
                return _pesq_fn(SR, a, b, "wb")
        else:
            from .metrics_pesq import pesq_wb

            def score(a, b):
                return pesq_wb(a, b, SR)
        out = []
        for b in range(x.shape[0]):
            n = int(lengths[b]) if lengths is not None else x.shape[-1]
            try:
                out.append(score(x[b, :n], y[b, :n]))
            except Exception:  # the C library raises on what it rejects
                out.append(np.nan)
        return np.asarray(out, dtype=np.float32)


def _log_power(mel: torch.Tensor) -> torch.Tensor:
    return torch.log10(mel.clamp_min(1e-5) ** 2)


def mel_distance(raw_audio: torch.Tensor, recon_audio: torch.Tensor
                 ) -> torch.Tensor:
    """7-scale L1 log-mel distance, per sample ``(B,)``
    (scripts/metrics.py:96-121)."""
    loss = 0.0
    for w, m in zip(MEL_WINDOWS, MEL_BINS):
        lx = _log_power(mel_spectrogram(raw_audio, w, m, SR))
        ly = _log_power(mel_spectrogram(recon_audio, w, m, SR))
        loss = loss + (lx - ly).abs().mean((1, 2))
    return loss


def _sisdr(ref: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    eps = 1e-8
    ref_energy = (ref * ref).sum(-1) + eps
    proj = (ref * est).sum(-1) + eps
    e_true = (proj / ref_energy)[..., None] * ref
    e_res = est - e_true
    return 10.0 * torch.log10((e_true ** 2).sum(-1) / (e_res ** 2).sum(-1)
                              + eps)


def sisdr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SDR, per sample (scripts/metrics.py:123-171)."""
    return _sisdr(x - x.mean(-1, keepdim=True), y - y.mean(-1, keepdim=True))


def _masked_log_mel(x: torch.Tensor, lengths: torch.Tensor, n_fft: int,
                    n_mels: int):
    """Log power mel of a zero-padded batch ``(B, L)`` at its true
    ``lengths``: ``(logmel (B, n_mels, T), frame mask (B, T), t_valid
    (B,))``. Frames ``t < n // hop + 1`` are those of
    ``mel_spectrogram(x[:n])``."""
    hop, pad = n_fft // 4, n_fft // 2
    B, L = x.shape
    T = L // hop + 1
    xp = torch.gather(x.float(), 1, reflect_index(L, pad, lengths))
    frames = xp.unfold(-1, n_fft, hop)[:, :T]
    logmel = _log_power(magnitude_mel(frames, n_fft, n_mels, SR))
    t_valid = lengths // hop + 1
    mask = (torch.arange(T, device=x.device)[None, :]
            < t_valid[:, None]).float()
    return logmel, mask, t_valid


def mel_distance_masked(x: torch.Tensor, y: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """:func:`mel_distance` over the true span of each zero-padded sample:
    row ``b`` equals ``mel_distance(x[b, :n], y[b, :n])``."""
    loss = 0.0
    for w, m in zip(MEL_WINDOWS, MEL_BINS):
        lx, mask, t_valid = _masked_log_mel(x, lengths, w, m)
        ly, _, _ = _masked_log_mel(y, lengths, w, m)
        diff = (lx - ly).abs() * mask[:, None, :]
        loss = loss + diff.sum((1, 2)) / (m * t_valid.float())
    return loss


def sisdr_masked(x: torch.Tensor, y: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """:func:`sisdr` over the true span of each zero-padded sample."""
    mask = (torch.arange(x.shape[-1], device=x.device)[None, :]
            < lengths[:, None]).to(x.dtype)
    n = lengths.to(x.dtype)[:, None]
    xm, ym = x * mask, y * mask
    ref = (xm - xm.sum(-1, keepdim=True) / n) * mask
    est = (ym - ym.sum(-1, keepdim=True) / n) * mask
    return _sisdr(ref, est)


class _DeviceMetric:
    """Scores ``(x, y[, lengths])`` on ``y``'s device; numpy ``(B,)`` out."""

    plain = staticmethod(mel_distance)
    masked = staticmethod(mel_distance_masked)

    @torch.no_grad()
    def __call__(self, x, y, lengths=None) -> np.ndarray:
        y = _tensor(y).float()
        x = _tensor(x, y.device).float()
        if lengths is None:
            return _host(self.plain(x, y))
        return _host(self.masked(x, y, _tensor(lengths, y.device).long()))


class MelSpectrogramDistance(_DeviceMetric):
    pass


class SISDR(_DeviceMetric):
    plain = staticmethod(sisdr)
    masked = staticmethod(sisdr_masked)


def _code_histograms(codes: torch.Tensor, codebook_size: int,
                     t_valid: Optional[torch.Tensor] = None) -> np.ndarray:
    """Codes ``(B, S, G, T)`` -> counts ``(S, G, codebook_size)``; with
    ``t_valid`` ``(B,)`` only frames ``t < t_valid[b]`` count."""
    B, S, G, T = codes.shape
    book = torch.arange(S * G, device=codes.device).reshape(1, S, G, 1)
    idx = (book * codebook_size + codes.long()).reshape(-1)
    weight = torch.ones(B, S, G, T, device=codes.device)
    if t_valid is not None:
        weight = weight * (torch.arange(T, device=codes.device)[None, :]
                           < t_valid[:, None]).float()[:, None, None, :]
    counts = torch.zeros(S * G * codebook_size, device=codes.device)
    counts.index_add_(0, idx, weight.reshape(-1))
    return _host(counts).astype(np.float64).reshape(S, G, codebook_size)


class EntropyCounter:
    """Codebook utilisation counter (scripts/metrics.py:12-77): one
    histogram of each (stream, group) codebook's codes, and their entropies
    against ``log2(codebook_size)``."""

    def __init__(self, codebook_size: int = 1024, num_streams: int = 6,
                 num_groups: int = 3):
        self.codebook_size = codebook_size
        self.num_groups = num_groups
        self.reset_stats(num_streams)

    def reset_stats(self, num_streams: int) -> None:
        self.num_streams = num_streams
        self.counts = np.zeros(
            (num_streams, self.num_groups, self.codebook_size), np.float64)
        self.total_counts = 0
        self.dist = None
        self.entropy = None
        self.max_entropy_per_book = np.log2(self.codebook_size)
        self.max_total_entropy = (num_streams * self.num_groups
                                  * self.max_entropy_per_book)

    @torch.no_grad()
    def update(self, codes, lengths=None,
               samples_per_code: Optional[int] = None) -> None:
        """Count codes ``(B, num_streams, num_groups, T)``. With ``lengths``
        (true sample counts of a padded batch) and ``samples_per_code``,
        only the code frames that cover real audio count."""
        codes = _tensor(codes)
        if tuple(codes.shape[1:3]) != (self.num_streams, self.num_groups):
            raise ValueError(f"codes {tuple(codes.shape)} do not hold "
                             f"{self.num_streams} streams of "
                             f"{self.num_groups} groups")
        if lengths is not None and samples_per_code:
            t_valid = np.minimum(-(-np.asarray(lengths) // samples_per_code),
                                 codes.shape[-1])
            self.total_counts += int(t_valid.sum())
            self.counts += _code_histograms(
                codes, self.codebook_size,
                torch.as_tensor(t_valid, device=codes.device))
            return
        self.total_counts += codes.shape[0] * codes.shape[-1]
        self.counts += _code_histograms(codes, self.codebook_size)

    def _form(self) -> None:
        if self.total_counts <= 0:
            raise RuntimeError("no codes counted: call update first")
        self.dist = self.counts / self.total_counts
        self.entropy = -np.sum(self.dist * np.log2(self.dist + 1e-10),
                               axis=-1)

    def compute_utilization(self) -> Tuple[float, Dict[str, float]]:
        """(overall utilisation, utilisation of each codebook)."""
        if self.dist is None or self.entropy is None:
            self._form()
        per_book = {
            f"stream_{s}_group_{g + 1}":
                round(float(self.entropy[s, g]) / self.max_entropy_per_book, 4)
            for s in range(self.num_streams) for g in range(self.num_groups)}
        total = round(float(self.entropy.sum()) / self.max_total_entropy, 4)
        return total, per_book
