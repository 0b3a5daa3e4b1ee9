"""The plain reference of the adversarial stack: discriminator, GAN losses.

Frozen copy of ``tests/torch_mirror_adv.py``, a torch-only re-creation of
the reference discriminator (esc/models/discriminator.py, DAC's) and GAN
losses (esc/modules/loss/gan_loss.py) with the audiotools dependencies
inlined, kept here so that no later change to the tests or to the program
can move the yardstick. Its state dict has the reference's keys
(``torch.nn.utils.weight_norm``'s ``weight_g`` / ``weight_v`` inside
``nn.Sequential`` s). Changes from the copy, none to the arithmetic: the
resampler's kernel is made on the input's device.

Notes of the copy:

* MRD's ``match_stride`` STFT (audiotools AudioSignal.stft): reflect-pad
  ``(w-hop)/2`` left and ``(w-hop)/2 + right_pad`` right where
  ``right_pad = ceil(L/hop)*hop - L``, then ``torch.stft(center=True)``
  with a periodic hann window, then drop the first/last two frames.
* MSD's resample: julius.ResampleFrac (clamped sinc, cos^2 window,
  replicate pad, floor output length).

Plain ``torch`` only: nothing of ``esc_tpu_torch``, ``esc_tpu`` or JAX.
"""

import math
import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import weight_norm

BANDS = [(0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0)]


def _weight_norm(conv):
    with warnings.catch_warnings():   # deprecated in favour of a
        warnings.simplefilter("ignore", FutureWarning)  # parametrization
        return weight_norm(conv)


def WNConv1d(*args, **kwargs):  # discriminator.py:15-20
    act = kwargs.pop("act", True)
    conv = _weight_norm(nn.Conv1d(*args, **kwargs))
    return nn.Sequential(conv, nn.LeakyReLU(0.1)) if act else conv


def WNConv2d(*args, **kwargs):  # discriminator.py:23-28
    act = kwargs.pop("act", True)
    conv = _weight_norm(nn.Conv2d(*args, **kwargs))
    return nn.Sequential(conv, nn.LeakyReLU(0.1)) if act else conv


class MPD(nn.Module):  # discriminator.py:31-66
    def __init__(self, period):
        super().__init__()
        self.period = period
        self.convs = nn.ModuleList([
            WNConv2d(1, 32, (5, 1), (3, 1), padding=(2, 0)),
            WNConv2d(32, 128, (5, 1), (3, 1), padding=(2, 0)),
            WNConv2d(128, 512, (5, 1), (3, 1), padding=(2, 0)),
            WNConv2d(512, 1024, (5, 1), (3, 1), padding=(2, 0)),
            WNConv2d(1024, 1024, (5, 1), 1, padding=(2, 0)),
        ])
        self.conv_post = WNConv2d(1024, 1, kernel_size=(3, 1),
                                  padding=(1, 0), act=False)

    def forward(self, x):
        t = x.shape[-1]
        # pads a FULL period when t % period == 0 (reference quirk)
        x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
        b, c, lp = x.shape
        x = x.view(b, c, lp // self.period, self.period)
        fmap = []
        for layer in self.convs:
            x = layer(x)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return fmap


def julius_resample(x, old_sr, new_sr, zeros=24, rolloff=0.945):
    """julius.core.ResampleFrac.forward on (B, L): phase-kernel bank of
    clamped sincs with a cos^2 window, replicate padding, stride=old_sr
    conv, floor output length."""
    g = math.gcd(int(old_sr), int(new_sr))
    old, new = old_sr // g, new_sr // g
    if old == new:
        return x
    sr = rolloff * min(old, new)
    width = math.ceil(zeros * old / sr)
    idx = torch.arange(-width, width + old, dtype=torch.float64)
    rows = []
    for i in range(new):
        t = (-i / new + idx / old) * sr
        t = t.clamp(-zeros, zeros) * math.pi
        window = torch.cos(t / zeros / 2) ** 2
        rows.append(torch.sinc(t / math.pi) * window)
    kernel = (torch.stack(rows) * (sr / old)).to(x.device,
                                                 torch.float32)[:, None]
    B, L = x.shape
    xp = F.pad(x[:, None], (width, width + old), mode="replicate")
    ys = F.conv1d(xp, kernel, stride=old)          # (B, new, T)
    y = ys.transpose(1, 2).reshape(B, -1)
    return y[:, : int(L * new / old)]


class MSD(nn.Module):  # discriminator.py:69-99
    def __init__(self, rate: int = 1, sample_rate: int = 16000):
        super().__init__()
        self.rate, self.sample_rate = rate, sample_rate
        self.convs = nn.ModuleList([
            WNConv1d(1, 16, 15, 1, padding=7),
            WNConv1d(16, 64, 41, 4, groups=4, padding=20),
            WNConv1d(64, 256, 41, 4, groups=16, padding=20),
            WNConv1d(256, 1024, 41, 4, groups=64, padding=20),
            WNConv1d(1024, 1024, 41, 4, groups=256, padding=20),
            WNConv1d(1024, 1024, 5, 1, padding=2),
        ])
        self.conv_post = WNConv1d(1024, 1, 3, 1, padding=1, act=False)

    def forward(self, x):
        if self.rate > 1:
            x = julius_resample(x.reshape(x.shape[0], -1), self.sample_rate,
                                self.sample_rate // self.rate)[:, None]
        fmap = []
        for layer in self.convs:
            x = layer(x)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return fmap


def match_stride_stft(x, window_length, hop_factor=0.25):
    """audiotools AudioSignal.stft with match_stride=True on (B, 1, L):
    returns complex (B*1, F, T) with T = ceil(L/hop)."""
    hop = int(window_length * hop_factor)
    length = x.shape[-1]
    right_pad = math.ceil(length / hop) * hop - length
    pad = (window_length - hop) // 2
    x = F.pad(x, (pad, pad + right_pad), mode="reflect")
    window = torch.hann_window(window_length, periodic=True,
                               dtype=x.dtype, device=x.device)
    s = torch.stft(x.reshape(-1, x.shape[-1]), n_fft=window_length,
                   hop_length=hop, window=window, return_complex=True,
                   center=True, pad_mode="reflect")
    return s[..., 2:-2]  # drop the frames torch.stft's centering adds


class MRD(nn.Module):  # discriminator.py:105-176
    def __init__(self, window_length, hop_factor=0.25, sample_rate=16000,
                 bands=BANDS):
        super().__init__()
        self.window_length = window_length
        self.hop_factor = hop_factor
        n_fft = window_length // 2 + 1
        self.bands = [(int(b[0] * n_fft), int(b[1] * n_fft)) for b in bands]
        ch = 32
        convs = lambda: nn.ModuleList([  # noqa: E731
            WNConv2d(2, ch, (3, 9), (1, 1), padding=(1, 4)),
            WNConv2d(ch, ch, (3, 9), (1, 2), padding=(1, 4)),
            WNConv2d(ch, ch, (3, 9), (1, 2), padding=(1, 4)),
            WNConv2d(ch, ch, (3, 9), (1, 2), padding=(1, 4)),
            WNConv2d(ch, ch, (3, 3), (1, 1), padding=(1, 1)),
        ])
        self.band_convs = nn.ModuleList(
            [convs() for _ in range(len(self.bands))])
        self.conv_post = WNConv2d(ch, 1, (3, 3), (1, 1), padding=(1, 1),
                                  act=False)

    def spectrogram(self, x):
        s = match_stride_stft(x, self.window_length, self.hop_factor)
        s = torch.view_as_real(s)            # (B, F, T, 2)
        s = s.permute(0, 3, 2, 1)            # b c t f (rearrange b 1 f t c)
        return [s[..., lo:hi] for lo, hi in self.bands]

    def forward(self, x):
        x_bands = self.spectrogram(x)
        fmap, outs = [], []
        for band, stack in zip(x_bands, self.band_convs):
            for layer in stack:
                band = layer(band)
                fmap.append(band)
            outs.append(band)
        x = torch.cat(outs, dim=-1)
        x = self.conv_post(x)
        fmap.append(x)
        return fmap


class Discriminator(nn.Module):  # discriminator.py:179-221
    def __init__(self, rates=(), periods=(2, 3, 5, 7, 11),
                 fft_sizes=(2048, 1024, 512), sample_rate=16000,
                 bands=BANDS):
        super().__init__()
        discs = [MPD(p) for p in periods]
        discs += [MSD(r, sample_rate=sample_rate) for r in rates]
        discs += [MRD(f, sample_rate=sample_rate, bands=bands)
                  for f in fft_sizes]
        self.discriminators = nn.ModuleList(discs)

    def preprocess(self, y):
        y = y - y.mean(dim=-1, keepdims=True)
        y = 0.8 * y / (y.abs().max(dim=-1, keepdim=True)[0] + 1e-9)
        return y

    def forward(self, x):
        x = self.preprocess(x)
        return [d(x) for d in self.discriminators]


class GANLoss(nn.Module):  # esc/modules/loss/gan_loss.py
    def __init__(self, discriminator):
        super().__init__()
        self.discriminator = discriminator

    def forward(self, fake, real):
        if fake.dim() == 2:
            fake = fake.unsqueeze(1)
        if real.dim() == 2:
            real = real.unsqueeze(1)
        return self.discriminator(fake), self.discriminator(real)

    @staticmethod
    def _dims(t):
        # The reference hardcodes mean(dim=[1,2,3]) — correct for the 4-D
        # MPD/MRD fmaps it actually runs (rates=[] disables MSD, whose
        # 3-D fmaps would crash it). Generalize to non-batch dims so the
        # mirror also covers MSD.
        return list(range(1, t.dim()))

    def discriminator_loss(self, fake, real):
        d_fake, d_real = self.forward(fake.clone().detach(), real)
        loss_d = 0
        for x_fake, x_real in zip(d_fake, d_real):
            loss_d += torch.mean(x_fake[-1] ** 2, dim=self._dims(x_fake[-1]))
            loss_d += torch.mean((1 - x_real[-1]) ** 2,
                                 dim=self._dims(x_real[-1]))
        return loss_d

    def generator_loss(self, fake, real):
        d_fake, d_real = self.forward(fake, real)
        loss_g = 0
        for x_fake in d_fake:
            loss_g += torch.mean((1 - x_fake[-1]) ** 2,
                                 dim=self._dims(x_fake[-1]))
        loss_feature = 0
        for i in range(len(d_fake)):
            for j in range(len(d_fake[i]) - 1):
                loss_feature += F.l1_loss(
                    d_fake[i][j], d_real[i][j].detach(),
                    reduction="none").mean(self._dims(d_fake[i][j]))
        return loss_g, loss_feature
