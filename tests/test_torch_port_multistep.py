"""``make_multi_step``: K training steps per call, from a stacked batch.

- Against ``esc_tpu``: the port's ``make_multi_step`` at
  ``tests/test_model_shapes.py::TINY_CONFIG``, K = 3 with ``num_streams``
  [6, 3, 6], from the same weights and batch as ``esc_tpu``'s
  ``make_multi_step(step_fn.core, False)`` (a ``lax.scan`` of its step).
  The bars are ``tests/test_training.py``'s for its scan against single
  steps: the first loss within the train step's rtol 5e-4, the last within
  rtol 5e-3, the weights within atol 3 K lr (Adam's normaliser turns
  float reassociation noise into lr-sized flips).
- Within the port: ``make_multi_step`` equals K single ``train_step``s of
  the port bit for bit (losses, weights, both moments, the count), with and
  without the freeze, and for rvq+swinT.

The JAX weights are drawn into ``jax.eval_shape``'s tree (no jitted init)
and carried into the port by ``from_jax_params``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.models import make_model as jax_make_model
from esc_tpu.train.optim import make_optimizer as jax_make_optimizer
from esc_tpu.train.optim import make_schedule as jax_make_schedule
from esc_tpu.train.trainer import Trainer as JaxTrainer
from esc_tpu.train.trainer import make_multi_step as jax_make_multi_step
from esc_tpu_torch.convert import from_jax_params, to_jax_params
from esc_tpu_torch.models import make_model
from esc_tpu_torch.train.optim import AdamW, make_schedule
from esc_tpu_torch.train.trainer import Trainer, make_multi_step
from tests.test_model_shapes import TINY_CONFIG
from tests.test_torch_port_conv import draw_variables
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

LR = 4e-4
W = {"cm": 0.25, "cb": 1.0, "mel": 0.25, "stft": 1.0}
B, L = 2, 4720                 # T = 60 frames, an even number as loaded
STREAMS = [6, 3, 6]
RVQ_SWINT = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[8, 8, 8, 12, 12, 16], max_streams=6, win_len=20, hop_len=5,
    sr=16000, patch_size=[3, 2], overlap=2, group_size=3, codebook_size=32,
    l2norm=True, swin_heads=[2, 2, 2, 2, 2], swin_depth=1, window_size=4,
    mlp_ratio=1.0, codebook_dim=8, num_rvqs=6)


def port_trainer(cfg, name="csvq+swinT", state_dict=None):
    """A port trainer on the CPU with its model and optimizer, as
    ``Trainer.load`` builds them (constant lr, clip 0.5), without data."""
    trainer = Trainer({"model": cfg, "model_name": name},
                      argparse.Namespace(seed=5), device="cpu")
    trainer.model = make_model(cfg, name, seed=5, device="cpu")
    if state_dict is not None:
        trainer.model.load_state_dict(state_dict)
    trainer.loss_weights = dict(W)
    trainer.opt = AdamW(trainer.model.module, make_schedule("constant", LR),
                        clip_norm=0.5)
    return trainer


def batches(k, seed=3):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((k, B, L))).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """``esc_tpu``'s multi-step over K = 3 from drawn weights: (initial
    weights, final weights, the (K,) losses)."""
    model = jax_make_model(TINY_CONFIG, "csvq+swinT")
    shapes = jax.eval_shape(
        lambda r, x: model.module.init(r, x, None, 6, False, False),
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, L), jnp.float32))
    params = draw_variables(shapes, np.random.default_rng(13))["params"]
    trainer = JaxTrainer.__new__(JaxTrainer)
    trainer.loss_weights = dict(W)
    trainer.tx = jax_make_optimizer(jax_make_schedule("constant", LR),
                                    clip_norm=0.5)
    step_fn = trainer._make_step_fn(model.module)
    multi = jax_make_multi_step(step_fn.core, False)
    p = jax.tree.map(jnp.asarray, params)
    (final, _), aux = multi((p, trainer.tx.init(p)),
                            jnp.asarray(batches(3)),
                            jnp.asarray(STREAMS, jnp.int32))
    return (params, jax.tree.map(np.asarray, final),
            {k: np.asarray(v) for k, v in aux.items()})


def test_multi_step_matches_esc_tpu(jax_run):
    params, final, theirs = jax_run
    trainer = port_trainer(TINY_CONFIG,
                           state_dict=from_jax_params({"params": params}))
    ours = make_multi_step(trainer.train_step, False)(batches(3), STREAMS)
    assert set(ours) == set(theirs) == {"cm_loss", "cb_loss", "mel_loss",
                                        "stft_loss", "loss"}
    for k, v in ours.items():
        assert v.shape == theirs[k].shape == (3,), k
    np.testing.assert_allclose(ours["loss"][0].item(), theirs["loss"][0],
                               rtol=5e-4)
    np.testing.assert_allclose(ours["loss"][-1].item(), theirs["loss"][-1],
                               rtol=5e-3)
    mine = _flat(to_jax_params(trainer.model.module))
    final = _flat(final)
    assert set(mine) == set(final)
    for name, v in final.items():
        np.testing.assert_allclose(mine[name], v, rtol=0,
                                   atol=3 * len(STREAMS) * LR, err_msg=name)
    assert trainer.opt.count == len(STREAMS)


def _state(trainer):
    return [*trainer.model.module.parameters(), *trainer.opt.mu,
            *trainer.opt.nu]


@pytest.mark.parametrize("name,cfg,streams,freeze", [
    ("csvq+swinT", TINY_CONFIG, STREAMS, False),
    ("csvq+swinT", TINY_CONFIG, torch.tensor(STREAMS), True),
    ("rvq+swinT", RVQ_SWINT, [2, 6], False),
], ids=["main", "freeze", "rvq+swinT"])
def test_multi_step_equals_single_steps_bit_for_bit(name, cfg, streams,
                                                    freeze):
    xs = batches(len(streams), seed=7)
    single, multi = port_trainer(cfg, name), port_trainer(cfg, name)
    for a, b in zip(_state(single), _state(multi)):
        assert torch.equal(a, b)
    losses = [single.train_step(x, int(s), freeze)
              for x, s in zip(xs, streams)]
    got = make_multi_step(multi.train_step, freeze)(xs, streams)
    for k, v in got.items():
        assert v.shape == (len(streams),)
        assert torch.equal(v, torch.stack([aux[k] for aux in losses])), k
    for a, b in zip(_state(single), _state(multi)):
        assert torch.equal(a, b)
    assert single.opt.count == multi.opt.count == len(streams)


def test_mismatched_k_raises():
    multi = make_multi_step(port_trainer(TINY_CONFIG).train_step, False)
    with pytest.raises(ValueError, match="3 batches but 2 stream counts"):
        multi(batches(3), [6, 6])
