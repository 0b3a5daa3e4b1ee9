"""The non-adversarial codec trainer, on one device or on several ranks.

Port of ``esc_tpu/train/trainer.py`` (reference: scripts/trainer_no_adv.py):

- quantization dropout drawn on the host for every step
  (scripts/utils.py:11-25), from the run's seed;
- the codebook-freeze pretraining stage, then the optimizer renewed at the
  switch (trainer_no_adv.py:75-78), which restarts the schedule;
- per-sample losses, weighted, then the batch mean (trainer_no_adv.py:
  108-115); a global-norm clip of 0.5 before each AdamW step;
- after every epoch past pretraining, an evaluation at the top bitrate that
  keeps ``best.ckpt`` by ``--val_metric``; ``pretrained.ckpt`` at the
  switch and a rolling ``checkpoint.ckpt``;
- epoch-aligned iteration, so that ``--resume`` replays the data order of
  an uninterrupted run from the step after the checkpoint's;
- on several ranks (:mod:`esc_tpu_torch.parallel`), the loader's batch is
  the global one, ``train_bs_per_device`` times the ranks, and each rank
  reads its block of rows; the weights are broadcast from rank 0 before the
  first step, the gradients averaged over the ranks before the clip, the
  logged losses averaged, and the evaluation, ``config.yaml`` and the
  checkpoints are rank 0's, the other ranks waiting at a barrier. Every
  rank seeds the dropout's generator alike and draws from it every step,
  so all ranks run the same number of streams.

Training runs the kernels' plain versions (the modules' training mode), as
the JAX package does; the per-epoch evaluation runs the kernels. The host
reads the losses once per log window. :func:`make_multi_step` runs K steps
from a stacked batch in one call, the counterpart of the JAX package's
``lax.scan`` of its step.
"""

from __future__ import annotations

import functools
import json
import math
import operator
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint import load_checkpoint, save_checkpoint
from ..convert import from_jax_params, to_jax_params
from ..device import resolve_device
from ..metrics import PESQ, SISDR, EntropyCounter, MelSpectrogramDistance
from ..models import make_model
from ..modules.convolution import refuse_training
from ..modules.losses import complex_stft_loss, mel_spectrogram_loss
from ..parallel import DataParallel, process_is_main
from ..utils.config import write_yaml
from ..utils.profiling import StepTimer, annotate
from .data import make_dataloader, quantization_dropout
from .evaluate import eval_epoch
from .optim import AdamW, make_schedule

__all__ = ["Trainer", "reproducible", "make_multi_step"]


def reproducible(step):
    """Run a training step (forward and backward) on cuDNN's deterministic
    convolution algorithms, TF32 still off, so that two runs from one seed
    give the same weights bit for bit, as ``esc_tpu``'s XLA programs do.
    The default algorithms may add partial sums by atomics in any order:
    on an H100, two otherwise identical runs of two adversarial steps gave
    different weights in most arrays. Scoped to the step, so that serving
    keeps cuDNN's default choice."""
    @functools.wraps(step)
    def wrapped(*args, **kwargs):
        with torch.backends.cudnn.flags(
                enabled=torch.backends.cudnn.enabled, benchmark=False,
                deterministic=True, allow_tf32=False):
            return step(*args, **kwargs)
    return wrapped


def print0(*args, **kwargs) -> None:
    """``print`` on rank 0 only."""
    if process_is_main():
        print(*args, **kwargs)


class Trainer:
    """Codec trainer, non-adversarial. ``config`` is the YAML config as a
    dict; ``args`` the flags of ``python -m esc_tpu_torch.cli.train``. On
    several ranks, the process group is joined first
    (:func:`esc_tpu_torch.parallel.init_distributed`) and ``device`` is this
    rank's."""

    renewed = "Optimizer Renewed"

    def __init__(self, config: dict, args, device=None):
        self.config, self.args = config, args
        self.device = resolve_device(
            device if device is not None else getattr(args, "device", None))
        self.rng = np.random.default_rng(getattr(args, "seed", 53))
        self.bps_per_stream = 1.5
        self.dp = DataParallel(self.device)
        self.timer = StepTimer(self.device)
        self.log_stats: Optional[Dict[str, list]] = None
        self.wandb = None
        self.best_perf, self.start_step = -math.inf, 0
        self._warned_val_metric = False

    # ------------------------------------------------------------------
    def load(self):
        cfg, args = self.config, self.args
        model = make_model(cfg["model"], cfg.get("model_name", "csvq+swinT"),
                           seed=getattr(args, "seed", 53), device=self.device)
        if model.module.backbone == "convolution":
            refuse_training()       # before any data is read or file written
        self.metrics = {"PESQ": PESQ(), "MelDistance": MelSpectrogramDistance(),
                        "SISDR": SISDR()}
        mcfg = model.config
        self.e_counter = EntropyCounter(mcfg["codebook_size"],
                                        mcfg["max_streams"],
                                        mcfg.get("group_size", 3))
        self.loss_weights = {k: float(cfg["loss"][f"{k}_weight"])
                             for k in ("cm", "cb", "mel", "stft")}
        data = cfg["data"]
        n = self.dp.num_devices
        train_dl = make_dataloader(data["train_data_path"],
                                   data["train_bs_per_device"] * n, True,
                                   data["num_workers"],
                                   shard=self.dp.shard if n > 1 else None)
        val_dl = make_dataloader(data["val_data_path"],
                                 data["val_bs_per_device"], False,
                                 data["num_workers"])
        args.train_steps = len(train_dl)
        args.max_train_steps = args.train_steps * args.num_epochs
        args.pretraining_steps = args.train_steps * args.num_pretraining_epochs
        self.schedule = make_schedule(args.scheduler_type, args.lr,
                                      total_steps=args.max_train_steps,
                                      warmup_steps=args.num_warmup_steps)
        self.opt = AdamW(model.module, self.schedule, clip_norm=0.5)
        print0(f"<<<<Experimental Setup: {args.exp_name}>>>>")
        print0(f"   Devices: {n} ({self.device.type})  GlobalBatch: Train "
               f"{data['train_bs_per_device'] * n} Val "
               f"{data['val_bs_per_device']}  LR: {args.lr}")
        print0(f"   Total_Training_Steps: {args.train_steps}*"
               f"{args.num_epochs}={args.max_train_steps}")
        print0(f"   Pre-Training_Steps: {args.train_steps}*"
               f"{args.num_pretraining_epochs}={args.pretraining_steps}")
        print0(f"   Optimizer: AdamW    Scheduler: {args.scheduler_type}")
        print0(f"   Quantization_Dropout: {args.dropout_rate}")
        print0(f"   Model #Parameters: {model.num_params() / 1e6:.2f}M")
        if getattr(args, "save_path", None) and process_is_main():
            d = os.path.join(args.save_path, args.exp_name)
            os.makedirs(d, exist_ok=True)
            write_yaml(os.path.join(d, "config.yaml"), cfg)
        return model, train_dl, val_dl

    # ------------------------------------------------------------------
    @reproducible
    def train_step(self, batch, num_streams: int, freeze: bool
                   ) -> Dict[str, torch.Tensor]:
        """One step on a batch ``(B, L)``: forward in training mode, the
        weighted per-sample losses' mean, backward, clip and AdamW. Returns
        the batch means of the losses, on the device."""
        with annotate("train.step"):
            aux, _ = self._generator_phases(self._upload(batch), num_streams,
                                            freeze)
        return aux

    def _upload(self, batch) -> torch.Tensor:
        """A host batch ``(B, L)`` on the trainer's device."""
        with annotate("train.upload"):
            return torch.as_tensor(batch).to(self.device)

    def _loss_terms(self, out: Dict[str, torch.Tensor], freeze: bool
                    ) -> Dict[str, torch.Tensor]:
        """The per-sample loss terms of a forward's output, by the names of
        ``loss_weights``."""
        return {"cm": out["cm_loss"], "cb": out["cb_loss"],
                "mel": mel_spectrogram_loss(out["raw_audio"],
                                            out["recon_audio"]),
                "stft": complex_stft_loss(out["raw_feat"], out["recon_feat"])}

    def _generator_phases(self, x: torch.Tensor, num_streams: int,
                          freeze: bool):
        """The codec's forward in training mode, the weighted loss terms'
        mean, backward and update (spans ``gen.*``). Returns the terms'
        batch means and the reconstruction, detached."""
        module, w = self.model.module, self.loss_weights
        module.train()
        with annotate("gen.forward"):
            out = module(x, num_streams, freeze)
        with annotate("gen.loss"):
            terms = self._loss_terms(out, freeze)
            total = functools.reduce(operator.add, (
                term * w[k] for k, term in terms.items()))
            loss = total.mean()
            aux = {f"{k}_loss": term.mean().detach()
                   for k, term in terms.items()}
            aux["loss"] = loss.detach()
            recon = out["recon_audio"].detach()
        with annotate("gen.backward"):
            self.opt.zero_grad()
            loss.backward()
            # the autograd graph's last references: its release takes ms of
            # host time at the adversarial step's size, and is the backward's
            del out, terms, total, loss
        self._update(self.opt, "gen")
        return aux, recon

    def _update(self, opt: AdamW, family: str) -> None:
        """The gradients averaged over the ranks, then ``opt``'s clipped
        AdamW step, in the span ``<family>.update``."""
        with annotate(f"{family}.update"):
            self.dp.average_grads(opt.params)
            opt.step()

    def train(self):
        """Run to ``args.max_train_steps``; returns the model."""
        args = self.args
        model, train_dl, val_dl = self.load()
        self.model, self.val_dl = model, val_dl
        self._restore()
        self.dp.replicate(self._replicated())
        self._before_training()

        step = self.start_step
        t0, window_steps = time.time(), 0
        while step < args.max_train_steps:
            epoch, offset = divmod(step, args.train_steps)
            train_dl.set_epoch(epoch)
            for i, batch in enumerate(train_dl):
                if i < offset:
                    continue
                if args.pretraining_steps > 0 \
                        and step == args.pretraining_steps + 1:
                    self.opt.renew()
                    print0(self.renewed)
                s = quantization_dropout(args.dropout_rate,
                                         model.max_streams, self.rng)
                freeze = step < args.pretraining_steps
                if window_steps == 0:
                    self.timer.tic()
                self._log_accumulate(self.train_step(batch, s, freeze))
                window_steps += 1
                if (step + 1) % args.log_steps == 0:
                    self.timer.toc_window(window_steps)
                    window_steps = 0
                if step > args.pretraining_steps \
                        and step % args.train_steps == 0 and step > 0:
                    self._on_main(self.evaluate, step)
                    window_steps = 0  # the evaluation is not a step's time
                if (step + 1) % args.log_steps == 0:
                    self.log_step(step, time.time() - t0)
                if step == args.pretraining_steps and step > 0:
                    self._on_main(self.save_ckp, step, tag="pretrained.ckpt")
                    window_steps = 0
                step += 1
                if step >= args.max_train_steps:
                    break
        # the last completed step, so that a longer run resumes at `step`
        self._on_main(self.save_ckp, step - 1, tag="checkpoint.ckpt")
        model.module.eval()
        return model

    def _restore(self) -> None:
        """``--resume`` (the rolling checkpoint, where there is one), then
        ``--pretrain_ckp``."""
        args = self.args
        if getattr(args, "resume", False) and getattr(args, "save_path",
                                                      None):
            rolling = os.path.join(args.save_path, args.exp_name,
                                   "checkpoint.ckpt")
            if os.path.exists(rolling):
                self._load_resume(rolling)
        if getattr(args, "pretrain_ckp", None):
            self._load_resume(args.pretrain_ckp)

    def _replicated(self):
        """The tensors every rank takes from rank 0 before the first
        step."""
        return list(self.model.module.parameters())

    def _before_training(self) -> None:
        """Work between the restore and the first step (none here)."""

    def _on_main(self, fn, *args, **kwargs) -> None:
        """``fn`` on rank 0, then every rank waits for it."""
        if process_is_main():
            fn(*args, **kwargs)
        self.dp.barrier()

    # ------------------------------------------------------------------
    def _log_accumulate(self, aux: Dict[str, torch.Tensor]) -> None:
        if self.log_stats is None:
            self.log_stats = {k: [] for k in aux}
        for k, v in aux.items():
            self.log_stats[k].append(v)

    def log_step(self, step: int, elapsed: float) -> None:
        """Print the log window's mean losses, averaged over the ranks
        (every rank calls this): one read of the device."""
        means = self.dp.mean(torch.stack([torch.stack(v).float().mean()
                                          for v in self.log_stats.values()]))
        stats = dict(zip(self.log_stats, means.cpu().tolist()))
        self.log_stats = None
        stats.update(self.timer.summary())
        msg = " | ".join(f"{k}: {v:.4f}" for k, v in stats.items())
        print0(f"[step {step + 1}/{self.args.max_train_steps} "
               f"{elapsed:.0f}s] {msg}", flush=True)
        if self.wandb is not None and process_is_main():
            self.wandb.log(stats, step=step)

    def evaluate(self, step: int) -> None:
        """Score the top bitrate on the validation set; keep ``best.ckpt``
        by ``--val_metric`` (SISDR, then MelDistance where it is NaN) and
        write ``checkpoint.ckpt``."""
        eval_streams = self.model.max_streams
        self.model.module.eval()
        perf = eval_epoch(self.model, self.val_dl, self.metrics,
                          self.e_counter, self.bps_per_stream,
                          num_streams=eval_streams, verbose=False)
        perf = {k: v[0] for k, v in perf.items()}
        print(f"[Step {step + 1}/{self.args.max_train_steps}] | "
              f"Performance at {eval_streams * self.bps_per_stream:.2f}kbps: ",
              " | ".join(f"{k}: {v:.4f}" for k, v in perf.items()),
              flush=True)
        if self.wandb is not None:
            self.wandb.log(perf, step=step)
        metric_name = self.args.val_metric
        metric = perf.get(metric_name)
        if metric is None or np.isnan(metric):
            for fallback in ("SISDR", "MelDistance"):
                v = perf.get(fallback)
                if v is not None and not np.isnan(v):
                    if not self._warned_val_metric:
                        print(f"WARNING: val_metric {metric_name} is "
                              f"unavailable (NaN) - selecting best.ckpt by "
                              f"{fallback} instead")
                        self._warned_val_metric = True
                    metric_name, metric = fallback, v
                    break
        if metric is not None and not np.isnan(metric):
            # MelDistance is lower-is-better: compare signed scores
            score = -metric if metric_name == "MelDistance" else metric
            if score > self.best_perf:
                self.best_perf = score
                self.save_ckp(step, tag="best.ckpt")
        self.save_ckp(step, tag="checkpoint.ckpt")

    def save_ckp(self, step: int, tag: str) -> None:
        """The full training state in ``esc_tpu``'s layout
        (scripts/trainer_no_adv.py:152-162): weights, optimizer moments
        and count, schedule, best score and the host RNG, and the
        :meth:`_checkpoint_extra` keys. Rank 0's (see :meth:`_on_main`)."""
        save_checkpoint(
            os.path.join(self.args.save_path, self.args.exp_name), tag,
            step=step, model_state=to_jax_params(self.model.module),
            optimizer_state=self.opt.state_dict(),
            scheduler_state={"type": self.args.scheduler_type, "step": step},
            best_perf=self.best_perf,
            rng_state=json.dumps(self.rng.bit_generator.state),
            extra=self._checkpoint_extra())
        print(f"[Step {step + 1}] | checkpoint saved as {tag}", flush=True)

    def _checkpoint_extra(self) -> Dict:
        """Keys a subclass adds to its checkpoints (none here)."""
        return {}

    def _restore_extra(self, payload: Dict) -> None:
        """What a subclass restores from a ``.ckpt`` payload (none here)."""

    def _load_resume(self, path: str) -> None:
        """Weights from a ``.pth`` state dict, or the whole state from a
        ``.ckpt`` of either package, the optimizer's moments and count
        included (:meth:`AdamW.load_state_dict`)."""
        if path.endswith(".pth"):
            ckp = torch.load(path, map_location="cpu", weights_only=True)
            self.model.load_state_dict(ckp.get("model_state_dict", ckp))
            print0(f"Loaded torch checkpoint {path}")
            return
        payload = load_checkpoint(path)
        self.model.load_state_dict(from_jax_params(
            payload["model_state_dict"]))
        restored = bool(payload.get("optimizer_state_dict"))
        if restored:
            self.opt.load_state_dict(payload["optimizer_state_dict"])
        if payload.get("rng_state"):
            self.rng.bit_generator.state = json.loads(payload["rng_state"])
        self.start_step = int(payload.get("step", 0)) + 1
        self.best_perf = float(payload.get("best_perf", -1.0))
        self._restore_extra(payload)
        print0(f"Loaded checkpoint {path}: step {self.start_step}, best "
               f"{self.best_perf}" + (" (optimizer state restored)"
                                      if restored else ""))


def make_multi_step(step, freeze: bool):
    """K training steps per call (``esc_tpu/train/trainer.py:399-420``).

    ``step`` is a trainer's bound ``train_step``, the counterpart of the
    JAX package's ``step_core``; ``freeze`` is fixed for the returned
    ``multi_step(batches, num_streams)``. ``batches`` is ``(K, B, L)``,
    moved to the trainer's device once before the first step;
    ``num_streams`` holds K stream counts (a tensor is read to the host
    once, before the loop). The K steps run in order, each exactly as
    ``step(batches[k], num_streams[k], freeze)``, and nothing in the loop
    waits for the device. Returns each loss of the step (``cm_loss``,
    ``cb_loss``, ``mel_loss``, ``stft_loss``, ``loss``) stacked to a
    ``(K,)`` tensor on the device.

    The state is the trainer's module and optimizer, updated in place as
    ``train_step`` updates them (the JAX function takes the state and
    returns a new one). On several ranks each step averages its gradients
    itself, as ``train_step`` does."""
    device = step.__self__.device

    def multi_step(batches, num_streams) -> Dict[str, torch.Tensor]:
        streams = torch.as_tensor(num_streams).reshape(-1).tolist()
        if len(batches) != len(streams):
            raise ValueError(f"{len(batches)} batches but {len(streams)} "
                             f"stream counts")
        batches = torch.as_tensor(batches).to(device)
        losses = [step(batch, int(s), freeze)
                  for batch, s in zip(batches, streams)]
        return {k: torch.stack([aux[k] for aux in losses])
                for k in losses[0]}

    return multi_step
