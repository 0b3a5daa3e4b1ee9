"""Optimizer state in ``.ckpt`` files, both ways between the packages.

The port's AdamW writes the state of the optax chain that ``esc_tpu``
builds for the same optimizer (``esc_tpu/train/optim.py:91-94``), laid out
as ``flax.serialization.to_state_dict`` lays it out, the moments as flax
parameter trees; and it reads that layout back. For the ESC trainer and
the DAC trainer with its discriminator:

- a state ``esc_tpu`` wrote after a few optax updates resumes in the port
  with the count and the moments equal bit for bit;
- a state the port wrote after a few of its steps restores through
  ``esc_tpu.checkpoint.restore_into`` against the optimizer's ``init``, and
  through ``esc_tpu``'s own resume, equal bit for bit;
- a file in the port's earlier layout, ``{"count", "mu", "nu"}`` by torch
  name, still loads, and a state that lacks a parameter raises.

No JAX model is built: the JAX side's parameter trees are the port's
weights carried over (``esc_tpu_torch.convert.to_jax_params``).
"""

import argparse
import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esc_tpu.checkpoint import restore_into
from esc_tpu.checkpoint import save_checkpoint as jax_save_checkpoint
from esc_tpu.train.optim import make_optimizer
from esc_tpu.train.optim import make_schedule as jax_make_schedule
from esc_tpu_torch.baselines.dac.trainer import DACTrainer
from esc_tpu_torch.checkpoint import save_checkpoint
from esc_tpu_torch.convert import from_jax_params, to_jax_params
from esc_tpu_torch.train import trainer as port_trainer
from tests.test_torch_parity_dac import CFG as DAC_CFG
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401
from tests.test_torch_port_dac import _folder
from tests.test_torch_port_trainer import _config, wav_folder  # noqa: F401

LR = 4e-4
STEPS = 3
DAC_DISC = {"sample_rate": 16000, "rates": [], "periods": [2],
            "fft_sizes": [256], "bands": [[0.0, 0.5], [0.5, 1.0]]}


def _args(save_path):
    return argparse.Namespace(
        exp_name="optstate", lr=LR, num_epochs=2, num_pretraining_epochs=0,
        num_warmup_steps=0, val_metric="SISDR", scheduler_type="constant",
        dropout_rate=0.5, pretrain_ckp=None, log_steps=1,
        save_path=str(save_path), seed=11, resume=False, device="cpu")


def _esc(wav_folder, tmp_path):
    t = port_trainer.Trainer(copy.deepcopy(_config(wav_folder)),
                             _args(tmp_path))
    t.model, _, t.val_dl = t.load()
    return t


def _dac(tmp_path):
    _folder(tmp_path)
    cfg = {"DAC": dict(DAC_CFG, sample_rate=16000), "batch_size": 2,
           "val_batch_size": 4, "num_workers": 0, "seed": 0,
           "data_path": str(tmp_path), "save_path": str(tmp_path / "out"),
           "Discriminator": copy.deepcopy(DAC_DISC)}
    t = DACTrainer(cfg, adversarial=True, device="cpu")
    t.load()
    return t


def _jax_tx(trainer, which):
    """The optax chain ``esc_tpu``'s trainer builds for that optimizer
    (``esc_tpu/train/trainer.py:101``, ``esc_tpu/baselines/dac/
    trainer.py:69-86``)."""
    if isinstance(trainer, DACTrainer):
        sched = lambda step: 1e-4 * 0.999996 ** step  # noqa: E731
        return optax.chain(
            optax.clip_by_global_norm(1e3 if which == "opt" else 10.0),
            optax.adamw(sched, b1=0.8, b2=0.99, eps=1e-8, weight_decay=0.01))
    return make_optimizer(jax_make_schedule("constant", LR), clip_norm=0.5)


def _pairs(trainer):
    """(port optimizer, its module, the optax chain) of each optimizer."""
    out = [(trainer.opt, trainer.model.module, _jax_tx(trainer, "opt"))]
    if isinstance(trainer, DACTrainer):
        out.append((trainer.opt_disc, trainer.disc,
                    _jax_tx(trainer, "disc")))
    return out


def _port_steps(opt, rng, n=STEPS):
    for _ in range(n):
        for p in opt.params:
            p.grad = torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32))
        opt.step()
    opt.zero_grad()


def _jax_state(tx, params, rng, n=STEPS):
    """``tx``'s state after ``n`` updates on random gradients."""
    params = jax.tree.map(jnp.asarray, params)
    state, update = tx.init(params), jax.jit(tx.update)
    for _ in range(n):
        grads = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32)), params)
        _, state = update(grads, state, params)
    return state


def _adam(state):
    """optax's ScaleByAdamState within ``chain(clip, adamw)``'s state."""
    return state[1][0]


def _assert_moments(opt, adam_state):
    """The port optimizer's moments equal the optax state's, by name."""
    assert opt.count == int(adam_state.count)
    for ours, tree in ((opt.mu, adam_state.mu), (opt.nu, adam_state.nu)):
        theirs = from_jax_params(jax.tree.map(np.asarray, tree))
        assert set(theirs) == set(opt.names)
        for name, m in zip(opt.names, ours):
            np.testing.assert_array_equal(m.numpy(), theirs[name].numpy(),
                                          err_msg=name)


@pytest.mark.parametrize("kind", ["esc", "dac"])
def test_a_port_state_restores_into_esc_tpu(kind, wav_folder, tmp_path):
    from esc_tpu.baselines.dac.trainer import DACTrainer as JaxDACTrainer
    from esc_tpu.train.trainer import Trainer as JaxTrainer
    from esc_tpu.utils import dict2namespace

    rng = np.random.default_rng(1)
    trainer = _esc(wav_folder, tmp_path) if kind == "esc" \
        else _dac(tmp_path)
    pairs = _pairs(trainer)
    for opt, _, _ in pairs:
        _port_steps(opt, rng)
    if kind == "esc":
        trainer.save_ckp(STEPS - 1, tag="checkpoint.ckpt")
        path = str(tmp_path / "optstate" / "checkpoint.ckpt")
    else:
        trainer._checkpoint(STEPS, "latest")
        path = str(tmp_path / "out" / "latest.ckpt")
    trees = [to_jax_params(module) for _, module, _ in pairs]
    targets = [tx.init(tree) for (_, _, tx), tree in zip(pairs, trees)]
    extra = {} if kind == "esc" else {
        "model_disc_state_dict": trees[1],
        "optimizer_disc_state_dict": targets[1]}
    restored = restore_into(path, trees[0], optimizer_state_target=targets[0],
                            extra_targets=extra)
    states = [restored["optimizer_state_dict"]]
    if kind == "dac":
        states.append(restored["optimizer_disc_state_dict"])
    for (opt, _, _), state in zip(pairs, states):
        _assert_moments(opt, _adam(state))
        assert int(state[1][2].count) == STEPS      # the schedule's count

    # esc_tpu's own resume takes the file
    if kind == "esc":
        jt = JaxTrainer(dict2namespace(_config(wav_folder)),
                        _args(tmp_path), devices=jax.devices()[:1])
        jt.tx = pairs[0][2]
        jt._load_resume(path, types.SimpleNamespace(
            variables={"params": trees[0]}))
        resumed = [jt._resumed_opt_state]
        assert jt.start_step == STEPS
    else:
        jt = JaxDACTrainer(trainer.cfg, adversarial=True,
                           devices=jax.devices()[:1])
        jt.model = types.SimpleNamespace()
        pieces, it = jt._resume([trees[0], targets[0], trees[1],
                                 targets[1]])
        resumed = [pieces[1], pieces[3]]
        assert it == STEPS
    for (opt, _, _), state in zip(pairs, resumed):
        _assert_moments(opt, _adam(state))


@pytest.mark.parametrize("kind", ["esc", "dac"])
def test_an_esc_tpu_state_resumes_in_the_port(kind, wav_folder, tmp_path):
    from esc_tpu.baselines.dac.trainer import DACTrainer as JaxDACTrainer

    rng = np.random.default_rng(2)
    trainer = _esc(wav_folder, tmp_path) if kind == "esc" \
        else _dac(tmp_path)
    pairs = _pairs(trainer)
    trees = [to_jax_params(module) for _, module, _ in pairs]
    states = [_jax_state(tx, tree, rng)
              for (_, _, tx), tree in zip(pairs, trees)]
    if kind == "esc":
        path = str(tmp_path / "jax")
        jax_save_checkpoint(path, "checkpoint.ckpt", step=STEPS - 1,
                            model_state=trees[0], optimizer_state=states[0])
        trainer._load_resume(os.path.join(path, "checkpoint.ckpt"))
        assert trainer.start_step == STEPS
    else:
        jt = JaxDACTrainer(trainer.cfg, adversarial=True,
                           devices=jax.devices()[:1])
        jt._checkpoint((trees[0], states[0], trees[1], states[1]), STEPS,
                       "latest")
        assert trainer._resume() == STEPS
    for (opt, _, _), state in zip(pairs, states):
        _assert_moments(opt, _adam(state))
        assert opt.mu[0].device == opt.params[0].device


@pytest.mark.parametrize("kind", ["esc", "dac"])
def test_the_ports_earlier_layout_still_loads(kind, wav_folder, tmp_path):
    trainer = _esc(wav_folder, tmp_path) if kind == "esc" \
        else _dac(tmp_path)
    rng = np.random.default_rng(3)
    for opt, _, _ in _pairs(trainer):
        old = {"count": 5,
               "mu": {n: rng.standard_normal(p.shape).astype(np.float32)
                      for n, p in zip(opt.names, opt.params)},
               "nu": {n: rng.random(p.shape).astype(np.float32)
                      for n, p in zip(opt.names, opt.params)}}
        opt.load_state_dict(old)
        assert opt.count == 5
        for i, n in enumerate(opt.names):
            np.testing.assert_array_equal(opt.mu[i].numpy(), old["mu"][n])
            np.testing.assert_array_equal(opt.nu[i].numpy(), old["nu"][n])
        # a moment missing in either layout names what is missing
        missing = opt.names[-1]
        del old["mu"][missing]
        with pytest.raises(KeyError, match=missing.replace(".", r"\.")):
            opt.load_state_dict(old)
        new = opt.state_dict()
        del new["1"]["0"]["nu"][next(iter(new["1"]["0"]["nu"]))]
        with pytest.raises(KeyError):
            opt.load_state_dict(new)
    if kind == "esc":                   # the whole file, through --resume
        opt = trainer.opt
        old = {"count": 7, "mu": {n: np.full(p.shape, 0.5, np.float32)
                                  for n, p in zip(opt.names, opt.params)},
               "nu": {n: np.full(p.shape, 0.25, np.float32)
                      for n, p in zip(opt.names, opt.params)}}
        save_checkpoint(str(tmp_path / "old"), "checkpoint.ckpt", step=9,
                        model_state=to_jax_params(trainer.model.module),
                        optimizer_state=old)
        trainer._load_resume(str(tmp_path / "old" / "checkpoint.ckpt"))
        assert opt.count == 7 and trainer.start_step == 10
        assert all(bool((m == 0.5).all()) for m in opt.mu)
