"""Generator losses, per sample ``(B,)``.

Port of ``esc_tpu/modules/losses.py`` (reference:
esc/modules/loss/generator_loss.py): the trainer weights them and takes the
mean over the batch.
"""

from __future__ import annotations

import torch

from ..ops.mel import MEL_BINS, MEL_WINDOWS, mel_spectrogram

__all__ = ["POWER", "GRAD_FLOOR", "power_law", "complex_stft_loss",
           "mel_spectrogram_loss", "ComplexSTFTLoss", "MelSpectrogramLoss"]

POWER = 0.3
# The derivative of (|x| + 1e-10)^0.3 is ~3e6 at x = 0, so exact-zero STFT
# bins (digital silence) would blow the gradient up by ~1e6 and the global
# clip would erase the step. The forward is exact; the derivative takes |x|
# no smaller than GRAD_FLOOR, below the quietest content a 16-bit recording
# holds (esc_tpu/modules/losses.py:19-29).
GRAD_FLOOR = 1e-4


class _PowerLaw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, power, eps):
        ctx.save_for_backward(x)
        ctx.power, ctx.eps = power, eps
        return torch.sign(x) * (x.abs() + eps) ** power

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        mag = x.abs().clamp_min(GRAD_FLOOR)
        return ctx.power * (mag + ctx.eps) ** (ctx.power - 1.0) * grad, \
            None, None


def power_law(x: torch.Tensor, power: float = POWER,
              eps: float = 1e-10) -> torch.Tensor:
    """Signed power-law compression ``sign(x) |x|^p`` (generator_loss.py:
    31-35), its derivative floored at :data:`GRAD_FLOOR`."""
    return _PowerLaw.apply(x, power, eps)


def complex_stft_loss(raw_feat: torch.Tensor, recon_feat: torch.Tensor,
                      weight: float = 1.0,
                      use_power_law: bool = True) -> torch.Tensor:
    """L2 between power-law compressed complex STFTs ``(B, 2, F, T)``, per
    sample (generator_loss.py:12-29)."""
    if use_power_law:
        raw_feat, recon_feat = power_law(raw_feat), power_law(recon_feat)
    return weight * ((raw_feat - recon_feat) ** 2).mean((1, 2, 3))


def mel_spectrogram_loss(raw_audio: torch.Tensor, recon_audio: torch.Tensor,
                         weight: float = 1.0, clamp_eps: float = 1e-5,
                         sample_rate: int = 16000) -> torch.Tensor:
    """7-scale L1 mel magnitude plus log-magnitude loss, per sample
    (generator_loss.py:37-75)."""
    loss = 0.0
    for w, m in zip(MEL_WINDOWS, MEL_BINS):
        x_m = mel_spectrogram(raw_audio, w, m, sample_rate)
        y_m = mel_spectrogram(recon_audio, w, m, sample_rate)
        loss = loss + (x_m - y_m).abs().mean((1, 2))
        lx = torch.log10(x_m.clamp_min(clamp_eps) ** 2)
        ly = torch.log10(y_m.clamp_min(clamp_eps) ** 2)
        loss = loss + (lx - ly).abs().mean((1, 2))
    return weight * loss


class ComplexSTFTLoss:
    """:func:`complex_stft_loss` as a callable with its weight, the
    reference's class interface."""

    def __init__(self, weight: float = 1.0, power_law: bool = True):
        self.weight = weight
        self.power_law = power_law

    def __call__(self, raw_feat: torch.Tensor,
                 recon_feat: torch.Tensor) -> torch.Tensor:
        return complex_stft_loss(raw_feat, recon_feat, self.weight,
                                 self.power_law)


class MelSpectrogramLoss:
    """:func:`mel_spectrogram_loss` as a callable with its weight, the
    reference's class interface."""

    def __init__(self, weight: float = 1.0, clamp_eps: float = 1e-5,
                 sample_rate: int = 16000):
        self.weight = weight
        self.clamp_eps = clamp_eps
        self.sample_rate = sample_rate

    def __call__(self, raw_audio: torch.Tensor,
                 recon_audio: torch.Tensor) -> torch.Tensor:
        return mel_spectrogram_loss(raw_audio, recon_audio, self.weight,
                                    self.clamp_eps, self.sample_rate)
