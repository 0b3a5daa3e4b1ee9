"""LS-GAN discriminator and generator losses with L1 feature matching.

Port of ``esc_tpu/modules/gan_loss.py`` (reference: esc/modules/loss/
gan_loss.py). Every loss is per sample, ``(B,)``: the mean of each map over
its non-batch dims. The fake waveform is detached for the discriminator's
loss and the real feature maps for feature matching (the reference's
``.detach()`` calls); which parameters receive gradients is the caller's
choice (:class:`esc_tpu_torch.train.trainer_adv.TrainerAdv` holds the
discriminator's fixed during the generator's loss).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

__all__ = ["discriminator_loss", "generator_loss", "GANLoss"]

Fmaps = List[List[torch.Tensor]]


def _mean_fmap(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.ndim)))


def discriminator_loss(disc: Callable[[torch.Tensor], Fmaps],
                       fake: torch.Tensor, real: torch.Tensor
                       ) -> torch.Tensor:
    """LS-GAN discriminator loss (gan_loss.py:30-37), ``(B,)``."""
    d_fake, d_real = disc(fake.detach()), disc(real)
    loss = 0.0
    for f, r in zip(d_fake, d_real):
        loss = loss + _mean_fmap(f[-1] ** 2) + _mean_fmap((1.0 - r[-1]) ** 2)
    return loss


def generator_loss(disc: Callable[[torch.Tensor], Fmaps], fake: torch.Tensor,
                   real: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LS-GAN generator loss and L1 feature matching (gan_loss.py:39-51):
    ``(gen, feat)``, both ``(B,)``; the logit maps take no part in
    feature matching."""
    d_fake = disc(fake)
    with torch.no_grad():
        d_real = disc(real)
    gen = 0.0
    for f in d_fake:
        gen = gen + _mean_fmap((1.0 - f[-1]) ** 2)
    feat = 0.0
    for f_maps, r_maps in zip(d_fake, d_real):
        for f, r in zip(f_maps[:-1], r_maps[:-1]):
            feat = feat + _mean_fmap((f - r).abs())
    return gen, feat


class GANLoss:
    """The reference's class interface (gan_loss.py:5) around a
    discriminator module."""

    def __init__(self, discriminator: torch.nn.Module):
        self.discriminator = discriminator

    def discriminator_loss(self, fake, real):
        return discriminator_loss(self.discriminator, fake, real)

    def generator_loss(self, fake, real):
        return generator_loss(self.discriminator, fake, real)
