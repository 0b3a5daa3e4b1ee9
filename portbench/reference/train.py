"""The plain reference of a training step: ESC alone, or with its GAN.

The steps of the reference trainers (scripts/trainer_no_adv.py:108-117,
scripts/trainer_adv.py:88-158) over :mod:`.esc` and :mod:`.disc`, with
``torch.optim.AdamW`` and ``torch.nn.utils.clip_grad_norm_``:

- the generator's per-sample losses (cm, cb, mel, stft, and with a
  discriminator the LS-GAN and feature-matching terms, the
  discriminator's parameters held out of the backward pass), weighted,
  their batch mean, backward, a global-norm clip (0.5 alone, 1e3 with a
  discriminator), AdamW;
- with a discriminator, its LS-GAN loss on the detached reconstruction,
  backward, a clip of 10, AdamW at the constant rate.

AdamW takes torch's defaults (betas 0.9, 0.999, eps 1e-8, weight decay
0.01), as ``esc_tpu``'s optax chain does. A batch may be taken in blocks
of rows: each block's share of the batch mean is backpropagated in turn,
so the gradient is the whole batch's. Plain ``torch`` only.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .disc import GANLoss
from .esc import complex_stft_loss, mel_spectrogram_loss

__all__ = ["RefTrainer", "LR", "GEN_CLIP", "DISC_CLIP", "CLIP"]

LR = 1e-4                    # the paper's --lr (scripts_all.sh)
CLIP = 0.5                   # trainer_no_adv.py:116
GEN_CLIP, DISC_CLIP = 1e3, 10.0   # trainer_adv.py:50,53


def _adamw(params, lr):
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.01)


class RefTrainer:
    """One object per run: ``gen`` (:class:`.esc.ESC`), ``disc``
    (:class:`.disc.Discriminator` or None) and ``weights``, the loss
    weights by name (cm, cb, mel, stft, and gen, feat with a
    discriminator)."""

    def __init__(self, gen, disc, weights: Dict[str, float], lr: float = LR):
        self.gen, self.disc, self.w = gen, disc, weights
        self.gan = GANLoss(disc) if disc is not None else None
        self.opt = _adamw(gen.parameters(), lr)
        self.opt_disc = _adamw(disc.parameters(), lr) if disc else None
        self.kept_grads: Optional[Dict[str, torch.Tensor]] = None

    def load_state(self, entries: Dict[str, tuple],
                   counts: Dict[str, int]) -> None:
        """Adam's state taken from elsewhere: ``entries`` maps a name to
        (parameter, first moment, second moment), ``counts`` the steps
        each optimizer has taken, under ``"gen"`` and ``"disc"``."""
        for key, opt in (("gen", self.opt), ("disc", self.opt_disc)):
            if opt is None:
                continue
            mine = {id(p) for g in opt.param_groups for p in g["params"]}
            for p, mu, nu in entries.values():
                if id(p) in mine:
                    opt.state[p] = {
                        "step": torch.tensor(float(counts[key])),
                        "exp_avg": mu.to(p.device, copy=True),
                        "exp_avg_sq": nu.to(p.device, copy=True)}

    def _gen_losses(self, x, ns):
        w = self.w
        out = self.gen(x, ns, False)
        mel = mel_spectrogram_loss(out["raw_audio"], out["recon_audio"])
        stft_l = complex_stft_loss(out["raw_feat"], out["recon_feat"])
        parts = {"cm_loss": out["cm_loss"], "cb_loss": out["cb_loss"],
                 "mel_loss": mel, "stft_loss": stft_l}
        total = (out["cm_loss"] * w["cm"] + out["cb_loss"] * w["cb"]
                 + mel * w["mel"] + stft_l * w["stft"])
        if self.disc is not None:
            self.disc.requires_grad_(False)
            try:
                gen, feat = self.gan.generator_loss(out["recon_audio"],
                                                    out["raw_audio"])
            finally:
                self.disc.requires_grad_(True)
            parts.update(gen_loss=gen, feat_loss=feat)
            total = total + gen * w["gen"] + feat * w["feat"]
        return total, parts, out["recon_audio"].detach()

    def step(self, x: torch.Tensor, ns: int, block: int = 0,
             keep: bool = False) -> Dict[str, float]:
        """One step on ``x`` (B, L) at ``ns`` streams; with ``block``,
        ``block`` rows at a time. Returns the batch means of the losses.
        With ``keep``, the clipped gradients, as the optimizer takes them,
        are kept in :attr:`kept_grads`."""
        B = rows = x.shape[0]
        block = block or B
        if keep:
            self.kept_grads = {}
        self.opt.zero_grad(set_to_none=True)
        sums: Dict[str, float] = {}
        recons = []
        for lo in range(0, B, block):
            xb = x[lo:lo + block]
            total, parts, recon = self._gen_losses(xb, ns)
            (total.sum() / rows).backward()
            recons.append(recon)
            sums["loss"] = sums.get("loss", 0.0) + float(total.detach().sum())
            for k, v in parts.items():
                sums[k] = sums.get(k, 0.0) + float(v.detach().sum())
        clip = GEN_CLIP if self.disc is not None else CLIP
        torch.nn.utils.clip_grad_norm_(list(self.gen.parameters()), clip)
        if keep:
            self._keep(self.gen, "")
        self.opt.step()
        out = {k: v / rows for k, v in sums.items()}
        if self.disc is not None:
            self.opt_disc.zero_grad(set_to_none=True)
            d_sum = 0.0
            for lo, recon in zip(range(0, B, block), recons):
                d = self.gan.discriminator_loss(recon, x[lo:lo + block])
                (d.sum() / rows).backward()
                d_sum += float(d.detach().sum())
            torch.nn.utils.clip_grad_norm_(list(self.disc.parameters()),
                                           DISC_CLIP)
            if keep:
                self._keep(self.disc, "disc.")
            self.opt_disc.step()
            out["disc_loss"] = d_sum / rows
        return out

    def _keep(self, module, prefix):
        for n, p in module.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.kept_grads[prefix + n] = g.detach().clone()
