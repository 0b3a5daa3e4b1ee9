"""Training: the trainer's own step, on one card.

Traffic keys: ``batch`` clips of ``length`` samples a step, streams per
step by the quantization-dropout rule at ``dropout_rate`` from the seed,
``pool`` distinct batches made from the seed, ``trace_units`` steps under
the profiler in a traced run. The configuration's ``discriminator`` makes
it the adversarial trainer.

Entry: ``Trainer.train_step(batch, num_streams, freeze=False)`` (or
``TrainerAdv``'s), on the object ``load()`` builds, with the benchmark's
weights loaded. Set-up takes the first three steps on three different
batches; the window then runs the same call on. After the window the
program takes one more step of the window's traffic from the state the
window left, its state read before and after. The reference follows the
first three steps from the seed's weights, and takes that last step from
the program's state (see :func:`judge` and :func:`judge_window`). One unit
is one step.
"""

from __future__ import annotations

import argparse
import os
import re
import tempfile
import time
import wave
from typing import Dict

import numpy as np
import torch

from portbench.drivers.common import card_line, free_device, peak_memory, sync
from portbench.reference import disc as ref_disc_mod
from portbench.reference import esc as ref_esc
from portbench.reference.train import RefTrainer
from portbench.reference.weights import fill, seeded_generator
from portbench.reference.work import model_flops
from portbench.signals import dropout_streams, speech_like
from portbench.trace import span, traced, unit

CHECKED_STEPS = 3


def program_key(ref_key: str) -> str:
    """A reference discriminator key in the program's layout: the
    reference wraps each convolution in ``nn.Sequential`` with its
    activation (``convs.0.0.weight_v``), the program does not
    (``convs.0.weight_v``)."""
    return re.sub(r"\.0\.(weight_g|weight_v|bias)$", r".\1", ref_key)


def run(run) -> None:
    tr, cfg, dev = run.traffic, run.config, run.device
    if dev != "cpu":
        run.note(card_line())
    adv = "discriminator" in cfg

    gen = seeded_generator(run.seed, dev)
    with torch.device(dev):
        ref_gen = ref_esc.ESC(**cfg["model"])
        ref_d = ref_disc_mod.Discriminator(**cfg["discriminator"]) \
            if adv else None
    fill(ref_gen, gen)
    if adv:
        fill(ref_d, gen)
    batches = [speech_like(gen, tr["batch"], tr["length"], dev).cpu()
               for _ in range(tr["pool"])]
    mine = [x.numpy() for x in batches]
    streams = dropout_streams(tr["dropout_rate"],
                              cfg["model"]["max_streams"], 20000, run.seed)

    with tempfile.TemporaryDirectory(prefix="portbench_data_") as data:
        trainer = _trainer(run, cfg, tr, dev, data)
    trainer.model.load_state_dict(ref_gen.state_dict())
    if adv:
        trainer.disc.load_state_dict({program_key(k): v for k, v in
                                      ref_d.state_dict().items()})
    ref_gen.cpu()
    if adv:
        ref_d.cpu()
    free_device(dev)

    # the first steps, which the reference follows
    losses, first = [], None
    for k in range(CHECKED_STEPS):
        aux = trainer.train_step(mine[k], streams[k], False)
        losses.append({n: float(v) for n, v in aux.items()})
        if k == 0:
            first = _moments(trainer)
    after = _params(trainer)
    sync(dev)
    run.setup_done()

    step = CHECKED_STEPS
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        trainer.train_step(mine[step % len(mine)], streams[step], False)
        run.units.append({"step": step})
        step += 1
    sync(dev)
    run.window_s = time.perf_counter() - t0
    run.attempted = len(run.units)
    run.memory_peak_bytes = peak_memory(dev)

    # the window's next step, from the state the window left
    last = {"step": step, "before": _state(trainer)}
    aux = trainer.train_step(mine[step % len(mine)], streams[step], False)
    last["losses"] = {n: float(v) for n, v in aux.items()}
    last["grads"] = _step_grads(trainer, last["before"])
    last["after"] = _params(trainer)
    step += 1

    if run.trace:
        if adv:
            trainer.generator_step = span("trainer.generator_step",
                                          trainer.generator_step)
            trainer.discriminator_step = span(
                "trainer.discriminator_step", trainer.discriminator_step)
        n = tr["trace_units"]
        with traced(run.traces):
            for k in range(step, step + n):
                with unit():
                    trainer.train_step(mine[k % len(mine)], streams[k],
                                       False)
        run.traced_units = n
    del trainer
    free_device(dev)
    judge(run, ref_gen, ref_d, batches, streams, losses, first, after, dev)
    judge_window(run, ref_gen, ref_d, batches[last["step"] % len(batches)],
                 streams[last["step"]], last, dev)
    if run.trace:
        ref = RefTrainer(ref_gen, ref_d, _weights(cfg), tr["lr"])
        x = batches[0].to(dev)
        run.unit_flops = model_flops(lambda: ref.step(x, streams[0]))


def _weights(cfg) -> Dict[str, float]:
    return {k[:-len("_weight")]: float(v) for k, v in cfg["loss"].items()}


def _trainer(run, cfg, tr, dev, data):
    """The program's trainer as ``python -m esc_tpu_torch.cli.train``
    builds it (``load()``), its loaders over a placeholder folder: the
    benchmark feeds the steps itself."""
    from esc_tpu_torch.train import Trainer
    from esc_tpu_torch.train.trainer_adv import TrainerAdv

    for split in ("train", "val"):
        os.makedirs(os.path.join(data, split))
        with wave.open(os.path.join(data, split, "0.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(b"\0\0" * 1600)
    config = dict(cfg, data=dict(cfg["data"],
                                 train_data_path=os.path.join(data, "train"),
                                 val_data_path=os.path.join(data, "val"),
                                 train_bs_per_device=tr["batch"]))
    args = argparse.Namespace(
        seed=run.seed % (2 ** 31), exp_name="portbench", lr=tr["lr"],
        scheduler_type="constant", num_warmup_steps=0, num_epochs=1,
        num_pretraining_epochs=0, dropout_rate=tr["dropout_rate"],
        save_path=None, pretrain_ckp=None, resume=False, log_steps=100,
        val_metric="SISDR", device=dev)
    cls = TrainerAdv if "discriminator" in cfg else Trainer
    trainer = cls(config, args, torch.device(dev))
    trainer.model, _, _ = trainer.load()
    return trainer


def _optimizers(trainer):
    """(prefix of the parameter names, optimizer) of the trainer."""
    opts = [("", trainer.opt)]
    if hasattr(trainer, "opt_disc"):
        opts.append(("disc.", trainer.opt_disc))
    return opts


def _moments(trainer) -> Dict[str, torch.Tensor]:
    """The gradient each optimizer took in its first step, read back from
    its first moment: ``mu / (1 - b1)``."""
    return {prefix + name: (m / (1 - opt.b1)).to("cpu", copy=True)
            for prefix, opt in _optimizers(trainer)
            for name, m in zip(opt.names, opt.mu)}


def _state(trainer) -> dict:
    """The program's parameters and each optimizer's count and moments,
    copied to the host, by the names of :func:`_params`."""
    params = _params(trainer)
    out = {"params": params, "count": {}, "mu": {}, "nu": {}}
    for prefix, opt in _optimizers(trainer):
        out["count"][prefix] = int(opt.count)
        for name, m, v in zip(opt.names, opt.mu, opt.nu):
            out["mu"][prefix + name] = m.to("cpu", copy=True)
            out["nu"][prefix + name] = v.to("cpu", copy=True)
    return out


def _step_grads(trainer, before) -> Dict[str, torch.Tensor]:
    """The gradient each optimizer took in its last step, read back from
    the change of its first moment: ``(mu - b1 mu_before) / (1 - b1)``."""
    return {prefix + name: (m.cpu() - opt.b1 * before["mu"][prefix + name])
            / (1 - opt.b1)
            for prefix, opt in _optimizers(trainer)
            for name, m in zip(opt.names, opt.mu)}


def _params(trainer) -> Dict[str, torch.Tensor]:
    out = {n: p.detach().to("cpu", copy=True)
           for n, p in trainer.model.module.named_parameters()}
    if hasattr(trainer, "disc"):
        out.update({"disc." + n: p.detach().to("cpu", copy=True)
                    for n, p in trainer.disc.named_parameters()})
    return out


def _named(gen, disc) -> Dict[str, torch.Tensor]:
    out = dict(gen.named_parameters())
    if disc is not None:
        out.update({"disc." + program_key(n): p
                    for n, p in disc.named_parameters()})
    return out


def _program_names(grads) -> Dict[str, torch.Tensor]:
    """The reference's kept gradients by the program's names."""
    return {("disc." + program_key(n[5:]) if n.startswith("disc.") else n):
            g.cpu() for n, g in grads.items()}


def _leaf_gaps(ref_grads, got_grads, start, got_after, ref_after):
    """Per leaf, the gap between the program's and the reference's norms
    of the gradient as the optimizer took it, and of the change from
    ``start``, each over the reference's norm of that leaf or of the
    median leaf of its module (generator or discriminator), whichever is
    larger. Values whose reference gradient is under a thousandth of the
    median leaf's root mean square are left out of the change.

    Returns (grad gaps, change gaps, values left out, values kept), the
    gaps as (gap, leaf name) pairs."""
    grad_gaps, changes, dropped, total = [], [], 0, 0
    for group in ("gen", "disc"):
        names = [n for n in ref_grads
                 if n.startswith("disc.") == (group == "disc")]
        if not names:
            continue
        g_norm = {n: float(ref_grads[n].norm()) for n in names}
        g_med = float(np.median(list(g_norm.values())))
        rms_med = float(np.median([g_norm[n] / ref_grads[n].numel() ** 0.5
                                   for n in names]))
        keep = {n: ref_grads[n].abs() >= 1e-3 * rms_med for n in names}
        d_ref = {n: float((ref_after[n] - start[n])[keep[n]].norm())
                 for n in names}
        d_med = float(np.median(list(d_ref.values())))
        for n in names:
            grad_gaps.append((abs(float(got_grads[n].norm()) - g_norm[n])
                              / max(g_norm[n], g_med), n))
            change = float((got_after[n] - start[n])[keep[n]].norm())
            changes.append((abs(change - d_ref[n]) / max(d_ref[n], d_med),
                            n))
            dropped += int((~keep[n]).sum())
            total += keep[n].numel()
    return grad_gaps, changes, dropped, total


def _loss_gap(got: Dict[str, float], ref: Dict[str, float]):
    """(widest relative gap of the losses, which loss and its values)."""
    return max((abs(got[name] - v) / max(abs(v), 1e-12),
                f"{name} {got[name]!r} against {v!r}")
               for name, v in ref.items())


def _median(gaps) -> float:
    return float(np.median([g for g, _ in gaps]))


def judge(run, ref_gen, ref_d, batches, streams, losses, first, after,
          dev) -> None:
    """The reference takes the first steps from the same weights on the
    same batches, and the program's readings are held to it (the limits
    in ``portbench/limits/<workload>.json``):

    - ``loss_gap``: the widest relative gap of the first step's losses
      (each term);
    - ``grad_gap``: the worst leaf's gap between the norms of the first
      step's gradient as each optimizer took it (the program's read back
      from its first moment) (:func:`_leaf_gaps`);
    - ``grad_gap_median``: the median leaf's gap of the same;
    - ``step_gap``: the median leaf's gap between the norms of its change
      over the checked steps, measured the same way;
    - ``step_gap_worst``: the worst leaf's gap of the same.

    The workload's limits file names those compared; the others are
    printed. The losses of the later steps are printed beside them: Adam's
    first update moves every value by about the learning rate whatever
    the size of its gradient, so round-off in a tiny gradient becomes a
    difference of the learning rate, which flips codes in the next forward
    (PERF.md). The reference's modules are left on ``dev`` with the
    weights of its last step."""
    p0 = {n: p.detach().to("cpu", copy=True)
          for n, p in _named(ref_gen, ref_d).items()}
    ref_gen.to(dev)
    if ref_d is not None:
        ref_d.to(dev)
    ref = RefTrainer(ref_gen, ref_d, _weights(run.config), run.traffic["lr"])
    gaps = []
    for k in range(CHECKED_STEPS):
        got = ref.step(batches[k].to(dev), streams[k], keep=k == 0)
        gaps.append(_loss_gap(losses[k], got))
    for k, (gap, what) in enumerate(gaps):
        run.note(f"widest loss gap of step {k + 1}: {gap!r} ({what})")
    ref_after = {n: p.detach().cpu() for n, p in
                 _named(ref_gen, ref_d).items()}
    grad_gaps, changes, dropped, total = _leaf_gaps(
        _program_names(ref.kept_grads), first, p0, after, ref_after)
    run.note(f"values left out of the change (reference gradient under "
             f"1e-3 of the median leaf's root mean square): {dropped} of "
             f"{total}; worst leaf's gradient: {max(grad_gaps)[1]}; worst "
             f"leaf's change: {max(changes)[1]}")
    run.check("loss_gap", gaps[0][0])
    run.check("grad_gap", max(grad_gaps)[0])
    run.check("grad_gap_median", _median(grad_gaps))
    run.check("step_gap", _median(changes))
    run.check("step_gap_worst", max(changes)[0])


def judge_window(run, ref_gen, ref_d, x, ns, last, dev) -> None:
    """The reference takes the window's next step from the program's
    state (parameters, each optimizer's count and moments) on the same
    batch and streams, and that step is held to it as :func:`judge` holds
    the first: ``window_loss_gap`` (every loss), ``window_grad_gap`` and
    ``window_grad_gap_median`` (the gradient as each optimizer took it,
    the program's read back from the change of its first moment),
    ``window_step_gap`` and ``window_step_gap_worst`` (the change of that
    step). It catches a step that goes wrong only after set-up: a state
    no longer updated, a stale input, a step skipped."""
    before = last["before"]
    named = _named(ref_gen, ref_d)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(before["params"][n])
    ref_gen.to(dev)
    if ref_d is not None:
        ref_d.to(dev)
    ref = RefTrainer(ref_gen, ref_d, _weights(run.config), run.traffic["lr"])
    ref.load_state(
        {n: (named[n], before["mu"][n], before["nu"][n]) for n in named},
        {"gen": before["count"][""], "disc": before["count"].get("disc.")})
    got = ref.step(x.to(dev), ns, keep=True)
    gap, what = _loss_gap(last["losses"], got)
    run.note(f"widest loss gap of step {last['step'] + 1} (after the "
             f"window): {gap!r} ({what})")
    ref_after = {n: p.detach().cpu() for n, p in named.items()}
    grad_gaps, changes, _, _ = _leaf_gaps(
        _program_names(ref.kept_grads), last["grads"], before["params"],
        last["after"], ref_after)
    run.note(f"after the window: worst leaf's gradient: {max(grad_gaps)[1]}"
             f"; worst leaf's change: {max(changes)[1]}")
    run.check("window_loss_gap", gap)
    run.check("window_grad_gap", max(grad_gaps)[0])
    run.check("window_grad_gap_median", _median(grad_gaps))
    run.check("window_step_gap", _median(changes))
    run.check("window_step_gap_worst", max(changes)[0])
