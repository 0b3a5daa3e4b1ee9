"""The adversarial codec trainer: ESC generator and DAC discriminator.

Port of ``esc_tpu/train/trainer_adv.py`` (reference: scripts/
trainer_adv.py). A step keeps the JAX step's order of work (``:88-158``):

1. the generator's forward in training mode;
2. its weighted losses, the LS-GAN generator loss and feature matching
   against the current discriminator, whose parameters are held out of the
   backward pass (``requires_grad`` off while the loss is built);
3. the generator's AdamW step, clipped at 1e3;
4. the discriminator's LS-GAN loss on the reconstruction of step 1,
   detached, with the discriminator as it was before this step;
5. its AdamW step, clipped at 10, at the constant ``--lr``.

In the codebook-freeze (pretraining) steps the GAN terms are zero and the
discriminator and its optimizer are left as they are; the renewal at the
switch renews the generator's optimizer only. ``--pretrain_ckp`` is the
post-adversarial finetuning: the generator at lr/10 (its schedule divided
by 10), the discriminator at lr, the step count and best score restarted,
both optimizers' moments kept where the file has them, and one evaluation
before the first step. Checkpoints add ``model_disc_state_dict`` (a flax
parameter tree) and ``optimizer_disc_state_dict`` (optax's state), which
``esc_tpu`` loads.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..convert import from_jax_params, to_jax_params
from ..models.discriminator import Discriminator, init_discriminator
from ..modules.gan_loss import discriminator_loss, generator_loss
from ..utils.profiling import annotate
from .optim import AdamW
from .trainer import Trainer, print0, reproducible

__all__ = ["TrainerAdv"]

GEN_CLIP, DISC_CLIP = 1e3, 10.0    # trainer_adv.py:50,53,68


class TrainerAdv(Trainer):
    """Adversarial trainer: ESC generator + MPD/MSD/MRD discriminator."""

    renewed = "Pretraining done. Generator's Optimizer Renewed"

    def load(self):
        model, train_dl, val_dl = super().load()
        args, cfg = self.args, self.config
        args.lr_disc = args.lr
        if getattr(args, "pretrain_ckp", None):
            args.lr = args.lr / 10.0
            base = self.schedule
            self.schedule = lambda step: base(step) / 10.0
            print0(f"   Post-adversarial finetuning: generator LR "
                   f"{args.lr} (schedule / 10), discriminator LR "
                   f"{args.lr_disc}")
        self.opt = AdamW(model.module, self.schedule, clip_norm=GEN_CLIP)
        self.disc = Discriminator(**cfg.get("discriminator", {}))
        init_discriminator(self.disc, getattr(args, "seed", 53) + 1)
        self.disc.to(self.device)
        n_disc = sum(p.numel() for p in self.disc.parameters())
        print0(f"   Discriminator #Parameters: {n_disc / 1e6:.2f}M")
        # a constant rate, as esc_tpu's (esc_tpu/train/trainer_adv.py:68)
        self.opt_disc = AdamW(self.disc, args.lr_disc, clip_norm=DISC_CLIP)
        self.loss_weights.update(gen=float(cfg["loss"]["gen_weight"]),
                                 feat=float(cfg["loss"]["feat_weight"]))
        return model, train_dl, val_dl

    # ------------------------------------------------------------------
    def _loss_terms(self, out: Dict[str, torch.Tensor], freeze: bool
                    ) -> Dict[str, torch.Tensor]:
        """The codec's terms, then the LS-GAN generator loss and feature
        matching against the current discriminator, whose parameters are
        held out of the backward pass; zeros in pretraining."""
        terms = super()._loss_terms(out, freeze)
        if freeze:                      # GAN terms off in pretraining
            terms["gen"] = terms["feat"] = torch.zeros_like(terms["mel"])
            return terms
        self.disc.requires_grad_(False)
        try:
            terms["gen"], terms["feat"] = generator_loss(
                self.disc, out["recon_audio"], out["raw_audio"])
        finally:
            self.disc.requires_grad_(True)
        return terms

    @reproducible
    def generator_step(self, x: torch.Tensor, num_streams: int,
                       freeze: bool
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Steps 1-3: the generator's forward, losses and update. Returns
        the losses' batch means and the reconstruction, detached."""
        return self._generator_phases(x, num_streams, freeze)

    @reproducible
    def discriminator_step(self, recon: torch.Tensor, x: torch.Tensor,
                           freeze: bool) -> torch.Tensor:
        """Steps 4-5: the discriminator's loss on ``recon`` against ``x``
        and its update; nothing in a freeze step."""
        if freeze:
            return torch.zeros((), device=self.device)
        with annotate("disc.loss"):
            d_loss = discriminator_loss(self.disc, recon, x).mean()
            value = d_loss.detach()
        with annotate("disc.backward"):
            self.opt_disc.zero_grad()
            d_loss.backward()
            del d_loss                  # the graph's release, as the gen's
        self._update(self.opt_disc, "disc")
        return value

    def train_step(self, batch, num_streams: int, freeze: bool
                   ) -> Dict[str, torch.Tensor]:
        """One adversarial step on a batch ``(B, L)``; returns the batch
        means of the losses, on the device."""
        with annotate("train.step"):
            x = self._upload(batch)
            aux, recon = self.generator_step(x, num_streams, freeze)
            aux["disc_loss"] = self.discriminator_step(recon, x, freeze)
        return aux

    # ------------------------------------------------------------------
    def _restore(self) -> None:
        super()._restore()
        if getattr(self.args, "pretrain_ckp", None):
            # the finetuning counts its steps afresh (trainer_adv.py:118-128)
            self.start_step, self.best_perf = 0, -math.inf

    def _replicated(self):
        return super()._replicated() + list(self.disc.parameters())

    def _before_training(self) -> None:
        if getattr(self.args, "pretrain_ckp", None):
            self._on_main(self.evaluate, -1)   # trainer_adv.py:133-135

    def _checkpoint_extra(self) -> Dict:
        return {"model_disc_state_dict": to_jax_params(self.disc),
                "optimizer_disc_state_dict": self.opt_disc.state_dict()}

    def _restore_extra(self, payload: Dict) -> None:
        """The discriminator's weights and optimizer state from either
        package's checkpoint, where the file holds them."""
        tree = payload.get("model_disc_state_dict")
        if tree:
            self.disc.load_state_dict(from_jax_params(tree))
        if payload.get("optimizer_disc_state_dict"):
            self.opt_disc.load_state_dict(
                payload["optimizer_disc_state_dict"])
