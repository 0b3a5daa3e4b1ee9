"""Multi-period / multi-scale / multi-resolution waveform discriminator.

Port of ``esc_tpu/models/discriminator.py`` (DAC's discriminator) as
``nn.Module``s in NCHW:

- MPD: the waveform folded by its period into ``(B, 1, L/p, p)``;
- MSD: the waveform (resampled where ``rate > 1``) as ``(B, 1, L)``;
- MRD: the one-sided complex STFT cut into frequency bands, each
  ``(B, 2, T, F_band)``.

Every convolution is weight-normalised as flax's ``nn.WeightNorm``
(:class:`WNConv`) and followed by LeakyReLU 0.1. Each sub-discriminator
returns its feature maps, the logit map last; :class:`Discriminator`
returns one such list per sub-discriminator. Feature maps are 4-D
``(B, C, H, W)``; ``fmap.permute(0, 2, 3, 1)`` gives the JAX package's
NHWC map (MSD's ``(B, C, 1, W)`` gives its ``(B, 1, W, C)``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.constants import on_device
from ..ops.resample import resample_julius
from ..ops.stft import _dft_matrices

__all__ = ["Discriminator", "MPD", "MSD", "MRD", "WNConv", "BANDS",
           "WN_EPS", "init_discriminator"]

BANDS = [(0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0)]
WN_EPS = 1e-12      # flax nn.WeightNorm's epsilon
_SLOPE = 0.1


class WNConv(nn.Module):
    """A weight-normalised ``conv1d`` / ``conv2d``: the kernel is
    ``weight_g * weight_v / sqrt(sum(weight_v ** 2) + 1e-12)``, the sum over
    every axis but the output channel, as flax's ``nn.WeightNorm`` around
    ``nn.Conv`` (``esc_tpu/models/discriminator.py:38``). ``weight_v`` has
    torch's layout ``(out, in/groups, *kernel)``, ``weight_g`` the shape
    ``(out, 1, ...)``; the names are those of the reference's
    ``torch.nn.utils.weight_norm`` state dicts."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: Tuple[int, ...],
                 stride: Tuple[int, ...], padding: Tuple[int, ...],
                 groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        ones = (1,) * len(kernel_size)
        self.weight_v = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                                 *kernel_size))
        self.weight_g = nn.Parameter(torch.ones(out_ch, 1, *ones))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self._conv = F.conv1d if len(kernel_size) == 1 else F.conv2d

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        dims = tuple(range(1, v.ndim))
        return v * torch.rsqrt((v * v).sum(dims, keepdim=True) + WN_EPS) \
            * self.weight_g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(x, self.weight(), self.bias, self.stride,
                          self.padding, 1, self.groups)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, _SLOPE)


class MPD(nn.Module):
    """Multi-period discriminator (``discriminator.py:69``)."""

    CHANNELS = (32, 128, 512, 1024, 1024)

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        chans = (1,) + self.CHANNELS
        self.convs = nn.ModuleList(
            WNConv(chans[i], chans[i + 1], (5, 1), (3, 1) if i < 4 else
                   (1, 1), (2, 0)) for i in range(5))
        self.conv_post = WNConv(chans[-1], 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        B, L = x.shape
        p = self.period
        # a full period of padding where L % p == 0, as the reference
        # (discriminator.py:82; kept for parity)
        x = F.pad(x[:, None], (0, p - L % p), mode="reflect")
        x = x.reshape(B, 1, -1, p)
        fmap = []
        for conv in self.convs:
            x = _leaky(conv(x))
            fmap.append(x)
        fmap.append(self.conv_post(x))
        return fmap


class MSD(nn.Module):
    """Multi-scale waveform discriminator (``discriminator.py:100``); the
    input resampled by julius's method where ``rate > 1``."""

    # (out channels, kernel, stride, padding, groups)
    SPECS = ((16, 15, 1, 7, 1), (64, 41, 4, 20, 4), (256, 41, 4, 20, 16),
             (1024, 41, 4, 20, 64), (1024, 41, 4, 20, 256),
             (1024, 5, 1, 2, 1))

    def __init__(self, rate: int = 1, sample_rate: int = 16000):
        super().__init__()
        self.rate, self.sample_rate = rate, sample_rate
        chans = [1] + [s[0] for s in self.SPECS]
        self.convs = nn.ModuleList(
            WNConv(chans[i], c, (k,), (s,), (p,), g)
            for i, (c, k, s, p, g) in enumerate(self.SPECS))
        self.conv_post = WNConv(chans[-1], 1, (3,), (1,), (1,))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.rate > 1:
            x = resample_julius(x, self.sample_rate,
                                self.sample_rate // self.rate)
        x = x[:, None]
        fmap = []
        for conv in self.convs:
            x = _leaky(conv(x))
            fmap.append(x[:, :, None])       # (B, C, 1, W)
        fmap.append(self.conv_post(x)[:, :, None])
        return fmap


class MRD(nn.Module):
    """Multi-resolution complex-spectrogram discriminator
    (``discriminator.py:131``)."""

    # (kernel, stride, padding) of each band's stack
    SPECS = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)),
             ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
             ((3, 3), (1, 1), (1, 1)))
    CHANNELS = 32

    def __init__(self, window_length: int, hop_factor: float = 0.25,
                 sample_rate: int = 16000,
                 bands: Sequence[Tuple[float, float]] = tuple(BANDS)):
        super().__init__()
        self.window_length, self.hop_factor = window_length, hop_factor
        self.sample_rate = sample_rate
        self.bands = [tuple(b) for b in bands]
        ch = self.CHANNELS
        self.band_convs = nn.ModuleList(
            nn.ModuleList(WNConv(2 if i == 0 else ch, ch, k, s, p)
                          for i, (k, s, p) in enumerate(self.SPECS))
            for _ in self.bands)
        self.conv_post = WNConv(ch, 1, (3, 3), (1, 1), (1, 1))

    def spectrogram(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``(B, L)`` -> per band ``(B, 2, T, F_band)`` (real, imaginary):
        audiotools' ``match_stride`` framing (hop w/4, ``ceil(L/hop)``
        frames, reflect padding of (w-hop)/2 plus the remainder on the
        right), the one-sided DFT as one product with a periodic Hann
        window of w."""
        w = self.window_length
        hop = int(w * self.hop_factor)
        B, L = x.shape
        T = -(-L // hop)
        pad = (w - hop) // 2
        xp = F.pad(x.float()[:, None], (pad, pad + T * hop - L),
                   mode="reflect")[:, 0]
        short = (T - 1) * hop + w - xp.shape[-1]   # > 0 only for odd w - hop
        if short > 0:
            xp = F.pad(xp, (0, short))
        frames = xp.unfold(-1, w, hop)[:, :T]               # (B, T, w)
        spec = frames @ on_device(_dft_matrices, (w, w), 0, x.device)
        nf = w // 2 + 1
        spec = spec.reshape(B, T, 2, nf).transpose(1, 2)    # (B, 2, T, F)
        return [spec[..., int(lo * nf):int(hi * nf)]
                for lo, hi in self.bands]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        fmap, outs = [], []
        for band, convs in zip(self.spectrogram(x), self.band_convs):
            h = band
            for conv in convs:
                h = _leaky(conv(h))
                fmap.append(h)
            outs.append(h)
        fmap.append(self.conv_post(torch.cat(outs, dim=3)))  # along F
        return fmap


class Discriminator(nn.Module):
    """All sub-discriminators behind DC removal and peak normalisation
    (``discriminator.py:185``): MPDs first, then MSDs, then MRDs."""

    def __init__(self, rates: Sequence[int] = (),
                 periods: Sequence[int] = (2, 3, 5, 7, 11),
                 fft_sizes: Sequence[int] = (2048, 1024, 512),
                 sample_rate: int = 16000,
                 bands: Sequence[Tuple[float, float]] = tuple(BANDS)):
        super().__init__()
        discs: List[nn.Module] = [MPD(p) for p in periods]
        discs += [MSD(r, sample_rate) for r in rates]
        discs += [MRD(f, sample_rate=sample_rate, bands=bands)
                  for f in fft_sizes]
        self.discriminators = nn.ModuleList(discs)

    @staticmethod
    def preprocess(y: torch.Tensor) -> torch.Tensor:
        y = y - y.mean(-1, keepdim=True)
        peak = y.abs().amax(-1, keepdim=True)
        return 0.8 * y / (peak + 1e-9)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        x = self.preprocess(x)
        return [d(x) for d in self.discriminators]


@torch.no_grad()
def init_discriminator(module: nn.Module, seed: int) -> nn.Module:
    """Seeded init as flax's: each direction ``weight_v`` LeCun-normal
    (``nn.Conv``'s default: a normal truncated at two standard deviations,
    scaled to variance 1/fan_in), drawn on the CPU so a seed gives the same
    weights on every machine; ``weight_g`` ones (``nn.WeightNorm``'s
    ``scale``), so each output channel's kernel starts at unit norm; biases
    zero."""
    gen = torch.Generator().manual_seed(seed)
    std = 1.0 / 0.87962566103423978     # unit variance after truncation
    for m in module.modules():
        if isinstance(m, WNConv):
            fan_in = m.weight_v[0].numel()
            v = torch.empty(m.weight_v.shape)
            nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            m.weight_v.copy_(v / math.sqrt(fan_in))
            m.weight_g.fill_(1.0)
            m.bias.zero_()
    return module
