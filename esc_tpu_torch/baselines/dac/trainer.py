"""The DNS-style DAC trainer, adversarial or not.

Port of ``esc_tpu/baselines/dac/trainer.py`` (reference:
baselines/descript/scripts/train_customize{,_no_adv}.py): an iteration-based
loop over a shuffled loader; AdamW with betas (0.8, 0.99), eps 1e-8 and
weight decay 0.01 under a global-norm clip of 1e3 (the discriminator's 10),
the learning rate decayed by ``gamma`` every step; per-sample quantizer
dropout drawn on the host from ``numpy.random.default_rng(seed)``; a
validation sweep every ``valid_freq`` iterations that keeps ``best`` by PESQ
(SI-SDR where PESQ is NaN), and ``latest``, ``best`` and ``<N>k`` checkpoints
(train_customize.py:346-460, conf/16khz_dns_9k.yml).

A step keeps the JAX step's order of work: the generator's forward in
training mode (the argmin's plain version), its weighted losses (the GAN
terms against the discriminator as it was before this step, whose
parameters take no gradient there), its update; then the discriminator's
loss on the reconstruction of that forward, detached, and its update. The
validation runs the eval forward, and so the argmin kernel on the card.
Several ranks (:class:`esc_tpu_torch.parallel.DataParallel`) split each
global batch by rows and average their gradients; rank 0 validates and
writes. Checkpoints hold the flax parameter trees of both networks and
optax's states of both optimizers, which the JAX package loads.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ...checkpoint import load_checkpoint, save_checkpoint
from ...convert import from_jax_params, to_jax_params
from ...device import resolve_device
from ...metrics import PESQ, SISDR
from ...models.discriminator import Discriminator, init_discriminator
from ...modules.gan_loss import discriminator_loss, generator_loss
from ...parallel import DataParallel, process_is_main
from ...train.data import make_dataloader
from ...train.optim import AdamW, make_schedule
from ...train.trainer import print0, reproducible
from ...utils.profiling import StepTimer
from .losses import l1_loss, mel_spectrogram_loss, multi_scale_stft_loss
from .model import DAC

__all__ = ["DACTrainer", "DEFAULT_LAMBDAS"]

DEFAULT_LAMBDAS = {"mel/loss": 15.0, "adv/feat_loss": 2.0,
                   "adv/gen_loss": 1.0, "vq/commitment_loss": 0.25,
                   "vq/codebook_loss": 1.0, "stft/loss": 1.0,
                   "waveform/loss": 0.0}
GEN_CLIP, DISC_CLIP = 1e3, 10.0


class DACTrainer:
    """Iteration-based DAC trainer. ``config`` is the YAML config as a dict
    (``configs/dac/*.yml`` plus ``data_path`` and ``save_path``);
    ``device`` this rank's (default ``cuda``)."""

    def __init__(self, config: Dict, adversarial: bool = True,
                 device=None):
        self.cfg = config
        self.adversarial = adversarial
        self.device = resolve_device(device)
        self.dp = DataParallel(self.device)
        self.lambdas = {**DEFAULT_LAMBDAS, **config.get("lambdas", {})}
        self.rng = np.random.default_rng(config.get("seed", 53))
        self.best_perf = float("-inf")
        self.timer = StepTimer(self.device)
        self._warned_pesq = False

    def load(self) -> None:
        cfg = self.cfg
        self.model = DAC(seed=cfg.get("seed", 0), device=self.device,
                         **cfg["DAC"])
        print0(f"DAC #params: {self.model.num_params() / 1e6:.2f}M")
        aw = cfg.get("AdamW", {})
        betas = tuple(aw.get("betas", [0.8, 0.99]))
        sched = make_schedule(
            "exponential_decay", aw.get("lr", 1e-4),
            gamma=cfg.get("ExponentialLR", {}).get("gamma", 0.999996))
        self.opt = AdamW(self.model.module, sched, clip_norm=GEN_CLIP,
                         betas=betas)
        if self.adversarial:
            disc_cfg = {k: ([tuple(b) for b in v] if k == "bands" else v)
                        for k, v in cfg.get("Discriminator", {}).items()}
            self.disc = init_discriminator(Discriminator(**disc_cfg),
                                           cfg.get("seed", 53) + 1)
            self.disc.to(self.device)
            self.opt_disc = AdamW(self.disc, sched, clip_norm=DISC_CLIP,
                                  betas=betas)
        n = self.dp.num_devices
        self.train_dl = make_dataloader(
            cfg["data_path"] + "/train", cfg.get("batch_size", 16) * n, True,
            cfg.get("num_workers", 4), shard=self.dp.shard if n > 1 else None)
        self.val_dl = make_dataloader(cfg["data_path"] + "/test",
                                      cfg.get("val_batch_size", 8), False)
        self.metrics = {"PESQ": PESQ(), "SISDR": SISDR()}

    # ------------------------------------------------------------------
    @reproducible
    def train_step(self, batch, n_q) -> Dict[str, torch.Tensor]:
        """One step on this rank's rows ``(B, L)`` with per-sample stage
        counts ``n_q (B,)``; returns the losses, on the device."""
        lam, module = self.lambdas, self.model.module
        module.train()
        x = torch.as_tensor(batch).to(self.device)
        out = module(x, torch.as_tensor(n_q).to(self.device))
        recon = out["audio"]
        aux = {"mel/loss": mel_spectrogram_loss(x, recon),
               "stft/loss": multi_scale_stft_loss(x, recon),
               "waveform/loss": l1_loss(x, recon),
               "vq/commitment_loss": out["vq/commitment_loss"],
               "vq/codebook_loss": out["vq/codebook_loss"]}
        total = sum(lam[k] * v for k, v in aux.items())
        n = min(x.shape[-1], recon.shape[-1])
        if self.adversarial:
            self.disc.requires_grad_(False)
            try:
                gen, feat = generator_loss(self.disc, recon[..., :n],
                                           x[..., :n])
            finally:
                self.disc.requires_grad_(True)
            aux["adv/gen_loss"] = gen.mean()
            aux["adv/feat_loss"] = feat.mean()
            total = total + lam["adv/gen_loss"] * aux["adv/gen_loss"] \
                + lam["adv/feat_loss"] * aux["adv/feat_loss"]
        self.opt.zero_grad()
        total.backward()
        self.dp.average_grads(self.opt.params)
        self.opt.step()
        aux["loss"] = total
        if self.adversarial:
            d_loss = discriminator_loss(self.disc, recon.detach()[..., :n],
                                        x[..., :n]).mean()
            self.opt_disc.zero_grad()
            d_loss.backward()
            self.dp.average_grads(self.opt_disc.params)
            self.opt_disc.step()
            aux["adv/disc_loss"] = d_loss
        return {k: v.detach() for k, v in aux.items()}

    def dropout(self, batch: int) -> np.ndarray:
        """Per-sample stage counts of a global batch (quantize.py:166-171):
        the first ``batch * quantizer_dropout`` uniform in 1..N, the rest
        N + 1, drawn from the trainer's generator."""
        dac = self.cfg["DAC"]
        n_codebooks = dac.get("n_codebooks", 9)
        n_q = np.full((batch,), n_codebooks + 1, np.int32)
        nd = int(batch * dac.get("quantizer_dropout", 0.0))
        n_q[:nd] = self.rng.integers(1, n_codebooks + 1, nd)
        return n_q

    def train(self, num_iters: Optional[int] = None) -> DAC:
        """Run to ``num_iters`` (the config's ``num_iters``); returns the
        model."""
        self.load()
        cfg = self.cfg
        num_iters = num_iters or cfg.get("num_iters", 400000)
        valid_freq = cfg.get("valid_freq", 4000)
        log_every = cfg.get("log_every", 5)
        self.save_iters = set(cfg.get("save_iters",
                                      [10000, 50000, 100000, 200000]))
        it = self._resume() if cfg.get("resume") else 0
        self.dp.replicate(list(self.model.module.parameters()) + (
            list(self.disc.parameters()) if self.adversarial else []))
        t0, stats = time.time(), []
        while it < num_iters:
            for batch in self.train_dl:
                n_q = self.dropout(len(batch) * self.dp.num_devices)
                self.timer.tic()
                stats.append(self.train_step(batch, self.dp.shard(n_q)))
                self.timer.toc()
                it += 1
                if it % log_every == 0:
                    self._log(it, num_iters, stats, time.time() - t0)
                    stats = []
                if it % valid_freq == 0:
                    if process_is_main():
                        self._save_tagged(it, self._validate(it))
                    self.dp.barrier()
                if it >= num_iters:
                    break
        if process_is_main():
            self._save_tagged(it, score=None)
        self.dp.barrier()
        self.model.module.eval()
        return self.model

    def _log(self, it: int, num_iters: int, stats, elapsed: float) -> None:
        keys = list(stats[-1])
        means = self.dp.mean(torch.stack([torch.stack(
            [s[k] for s in stats]).float().mean() for k in keys]))
        line = dict(zip(keys, means.cpu().tolist()))
        line.update(self.timer.summary())
        print0(f"[iter {it}/{num_iters} {elapsed:.0f}s] " + " | ".join(
            f"{k}: {v:.3f}" for k, v in line.items()), flush=True)

    def _validate(self, it: int) -> float:
        """The whole validation set (train_customize.py:324-345): mel, STFT
        and waveform losses, PESQ and SI-SDR, each the mean over batches.
        Returns the score ``best`` is kept by: PESQ, or SI-SDR where PESQ is
        NaN (the ``pesq`` library absent)."""
        self.model.module.eval()
        agg: Dict[str, list] = {}
        for x in self.val_dl:
            recon = self.model(x)["audio"]
            xt = torch.as_tensor(x[..., :recon.shape[-1]]).to(self.device)
            rt = recon[..., :xt.shape[-1]]
            vals = {"mel/loss": float(mel_spectrogram_loss(xt, rt)),
                    "stft/loss": float(multi_scale_stft_loss(xt, rt)),
                    "waveform/loss": float(l1_loss(xt, rt)),
                    "pesq": float(np.nanmean(self.metrics["PESQ"](xt, rt))),
                    "sisdr": float(np.mean(self.metrics["SISDR"](xt, rt)))}
            for k, v in vals.items():
                agg.setdefault(k, []).append(v)
        perf = {k: float(np.nanmean(v)) for k, v in agg.items()}
        print0(f"[iter {it}] " + " | ".join(
            f"test/{k}: {v:.3f}" for k, v in perf.items()), flush=True)
        score = perf["pesq"]
        if np.isnan(score):
            if not self._warned_pesq:
                print0("WARNING: PESQ unavailable (pesq lib missing) - "
                       "selecting best checkpoint by SISDR")
                self._warned_pesq = True
            score = perf["sisdr"]
        return score

    def _save_tagged(self, it: int, score: Optional[float]) -> None:
        """``latest`` always, ``best`` on a better score, ``<N>k`` at the
        config's ``save_iters`` (train_customize.py:347-377)."""
        tags = ["latest"]
        if score is not None and score > self.best_perf:
            self.best_perf = score
            tags.append("best")
        if it in self.save_iters:
            tags.append(f"{it // 1000}k")
        for tag in tags:
            self._checkpoint(it, tag)

    def _checkpoint(self, it: int, tag: str) -> None:
        extra = {}
        if self.adversarial:
            extra = {"model_disc_state_dict": to_jax_params(self.disc),
                     "optimizer_disc_state_dict": self.opt_disc.state_dict()}
        save_checkpoint(self.cfg.get("save_path", "./dac_output"),
                        f"{tag}.ckpt", step=it,
                        model_state=to_jax_params(self.model.module),
                        optimizer_state=self.opt.state_dict(),
                        best_perf=self.best_perf,
                        rng_state=json.dumps(self.rng.bit_generator.state),
                        extra=extra)

    def _resume(self) -> int:
        """The whole state from ``latest.ckpt``, either package's, both
        optimizers' moments and counts included; returns its iteration, 0
        without one."""
        path = os.path.join(self.cfg.get("save_path", "./dac_output"),
                            "latest.ckpt")
        if not os.path.exists(path):
            return 0
        payload = load_checkpoint(path)
        self.model.load_state_dict(from_jax_params(
            payload["model_state_dict"]))
        pairs = [(self.opt, payload.get("optimizer_state_dict"))]
        if self.adversarial:
            tree = payload.get("model_disc_state_dict")
            if tree:
                self.disc.load_state_dict(from_jax_params(tree))
            pairs.append((self.opt_disc,
                          payload.get("optimizer_disc_state_dict")))
        for opt, state in pairs:
            if state:
                opt.load_state_dict(state)
        self.best_perf = float(payload.get("best_perf", -1.0))
        if payload.get("rng_state"):
            self.rng.bit_generator.state = json.loads(payload["rng_state"])
        it = int(payload.get("step", 0))
        print0(f"Resumed DAC training from {path} at iter {it} "
               f"(best {self.best_perf:.3f})")
        return it
