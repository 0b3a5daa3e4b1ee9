"""The port's training step, loss and optimizer against the JAX package's,
downsized: one step's per-sample losses and gradients from the same weights
and batch, the power law's floored derivative, clipped AdamW steps across
an optimizer renewal and the four learning-rate schedules.

Weights are made by the JAX model and carried into the port
(``from_jax_params``); inputs come from numpy seeds. The step's bars are
those of ``tests/test_torch_parity_trainstep.py`` (which holds the JAX
package to the torch reference): losses within rtol 5e-4, each gradient
leaf's cosine above 0.995 and the whole gradient within a relative L2 of
5e-2. Optimizer steps within 1e-6 of the parameters' scale, schedules
within rtol 1e-5 (both compute in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from esc_tpu.convert import flax_to_torch
from esc_tpu.models import ESC as JaxESC
from esc_tpu.modules.losses import GRAD_FLOOR as JAX_GRAD_FLOOR
from esc_tpu.modules.losses import complex_stft_loss as jax_stft_loss
from esc_tpu.modules.losses import mel_spectrogram_loss as jax_mel_loss
from esc_tpu.modules.losses import power_law as jax_power_law
from esc_tpu.train.optim import make_optimizer as jax_make_optimizer
from esc_tpu.train.optim import make_schedule as jax_make_schedule
from esc_tpu_torch.convert import from_jax_params
from esc_tpu_torch.models import ESC
from esc_tpu_torch.modules.losses import (GRAD_FLOOR, complex_stft_loss,
                                          mel_spectrogram_loss, power_law)
from esc_tpu_torch.train.optim import SCHEDULES, AdamW, make_schedule
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

CONFIG = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[16, 16, 24, 24, 32, 64], max_streams=6,
    win_len=20, hop_len=5, sr=16000, patch_size=[3, 2],
    swin_heads=[2, 2, 4, 4, 4], swin_depth=2, window_size=4,
    mlp_ratio=2.0, overlap=2, group_size=3, codebook_size=128,
    codebook_dims=[8, 8, 8, 8, 8, 8], l2norm=True,
)
L = 4720  # T=60 frames, tests/test_torch_parity_trainstep.py's batch
W = {"cm": 0.25, "cb": 1.0, "mel": 0.25, "stft": 1.0}


@pytest.fixture(scope="module")
def pair():
    ref = JaxESC(**CONFIG)
    ref.init_params(seed=3, example_len=L)
    port = ESC(device="cpu", **CONFIG)
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      ref.variables)))
    return ref, port


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(21)
    return (0.1 * rng.standard_normal((2, L))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_steps(pair, batch):
    """One jitted loss-and-gradient function per freeze flag, the stream
    count traced (as the JAX trainer's step takes it)."""
    module = pair[0].module
    fns = {}
    for freeze in (False, True):
        def loss_fn(params, num_streams, freeze=freeze):
            out = module.apply({"params": params}, jnp.asarray(batch), None,
                               num_streams, freeze, True)
            mel = jax_mel_loss(out["raw_audio"], out["recon_audio"])
            stft_l = jax_stft_loss(out["raw_feat"], out["recon_feat"])
            grad_total = (out["cm_loss"] * W["cm"] + out["cb_loss"] * W["cb"]
                          + mel * W["mel"]).mean()
            return grad_total, (out["cm_loss"], out["cb_loss"], mel, stft_l)
        fns[freeze] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return fns


def _port_step(port, x, num_streams, freeze):
    """The trainer's forward in training mode. The gradient leaves out the
    complex-STFT term, as tests/test_torch_parity_trainstep.py does: the
    power law's curvature near zero makes a cross-framework float32
    gradient through it ill-posed; its backward is held alone below."""
    module = port.module
    module.train()
    try:
        module.zero_grad()
        out = module(torch.from_numpy(x), num_streams, freeze)
        mel = mel_spectrogram_loss(out["raw_audio"], out["recon_audio"])
        stft_l = complex_stft_loss(out["raw_feat"], out["recon_feat"])
        (out["cm_loss"] * W["cm"] + out["cb_loss"] * W["cb"]
         + mel * W["mel"]).mean().backward()
        grads = {n: p.grad.numpy().copy()
                 for n, p in module.named_parameters()}
    finally:
        module.eval()
    return ((out["cm_loss"].detach().numpy(), out["cb_loss"].detach().numpy(),
             mel.detach().numpy(), stft_l.detach().numpy()), grads,
            out["codes"].numpy())


@pytest.mark.parametrize("freeze", [True, False], ids=["freeze", "main"])
@pytest.mark.parametrize("num_streams", [1, 6])
def test_train_step_losses_and_grads(pair, batch, jax_steps, num_streams,
                                     freeze):
    ref, port = pair
    (_, theirs), jgrads = jax_steps[freeze](ref.variables["params"],
                                            jnp.int32(num_streams))
    ours, grads, codes = _port_step(port, batch, num_streams, freeze)
    assert codes.shape == (2, 6, 3, 15)   # training codes hold every scale
    for name, a, b in zip(("cm", "cb", "mel", "stft"), ours, theirs):
        b = np.asarray(b)
        assert a.shape == b.shape == (2,), name
        if freeze and name in ("cm", "cb"):
            assert np.all(a == 0.0) and np.all(b == 0.0), name
        else:
            np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-6,
                                       err_msg=name)
    jgrads = flax_to_torch({"params": jgrads})
    assert set(grads) == set(jgrads)
    checked, sq_num, sq_den = 0, 0.0, 0.0
    for k, jg in jgrads.items():
        g = grads[k]
        assert g.shape == jg.shape, k
        sq_num += float(np.sum((g - jg) ** 2))
        sq_den += float(np.sum(jg ** 2))
        gn, jn = np.linalg.norm(g), np.linalg.norm(jg)
        if gn > 1e-8 and jn > 1e-8:
            cos = float(np.dot(g.ravel(), jg.ravel()) / (gn * jn))
            assert cos > 0.995, (k, cos)
            checked += 1
        else:  # a leaf off the loss's path: zero on both sides
            assert gn <= 1e-8 and jn <= 1e-8, (k, gn, jn)
    assert checked > 50
    assert (sq_num / (sq_den + 1e-30)) ** 0.5 < 5e-2


def test_power_law_gradient_is_floored_at_zero(rng):
    assert GRAD_FLOOR == JAX_GRAD_FLOOR == 1e-4
    x = rng.standard_normal((2, 2, 12, 9)).astype(np.float32)
    x[0, 0, :4] = 0.0          # exact zeros: digital silence
    x[1, 1, 2:5] = 3e-6        # below the floor
    t = torch.from_numpy(x).requires_grad_(True)
    power_law(t).sum().backward()
    theirs = np.asarray(jax.grad(lambda a: jnp.sum(jax_power_law(a)))(
        jnp.asarray(x)))
    np.testing.assert_allclose(t.grad.numpy(), theirs, rtol=1e-6)
    assert np.all(np.isfinite(t.grad.numpy()))
    np.testing.assert_allclose(power_law(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_power_law(jnp.asarray(x))),
                               rtol=1e-6)


def test_complex_stft_loss_gradient_matches(rng):
    raw = rng.standard_normal((2, 2, 24, 30)).astype(np.float32)
    rec = (raw + 0.1 * rng.standard_normal(raw.shape)).astype(np.float32)
    raw[0, :, :3] = 0.0
    t = torch.from_numpy(rec).requires_grad_(True)
    loss = complex_stft_loss(torch.from_numpy(raw), t)
    loss.sum().backward()
    jl, jg = jax.value_and_grad(
        lambda r: jnp.sum(jax_stft_loss(jnp.asarray(raw), r)))(
            jnp.asarray(rec))
    np.testing.assert_allclose(float(loss.detach().sum()), float(jl),
                               rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(jg)).max())


def _params(rng):
    return {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal((11,)).astype(np.float32),
            "c": rng.standard_normal((3, 2, 2)).astype(np.float32)}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["under_the_clip", "clipped"])
def test_adamw_steps_match_optax_across_a_renewal(rng, grad_scale):
    params = _params(rng)
    sched = jax_make_schedule("constant_warmup", 1e-3, warmup_steps=3)
    tx = jax_make_optimizer(sched, clip_norm=0.5)
    jp, state = jax.tree.map(jnp.asarray, params), None
    ours = {k: torch.tensor(v) for k, v in params.items()}
    opt = AdamW(ours.items(), make_schedule("constant_warmup", 1e-3,
                                            warmup_steps=3), clip_norm=0.5)
    state = tx.init(jp)
    for step in range(6):
        if step == 4:      # the trainer's renewal: tx.init / renew
            state = tx.init(jp)
            opt.renew()
        g = {k: (grad_scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in params.items()}
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in params:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6, err_msg=(step, k))
    assert opt.count == 2
    mu = state[1][0].mu
    for k in params:
        np.testing.assert_allclose(opt.mu[list(params).index(k)].numpy(),
                                   np.asarray(mu[k]), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("kind", SCHEDULES)
def test_schedules_match_step_by_step(kind):
    kw = dict(total_steps=40, warmup_steps=6)
    ours = make_schedule(kind, 2e-4, **kw)
    theirs = jax_make_schedule(kind, 2e-4, **kw)
    for step in range(45):
        np.testing.assert_allclose(ours(step),
                                   float(theirs(jnp.int32(step))),
                                   rtol=1e-5, atol=1e-12, err_msg=step)
    with pytest.raises(ValueError):
        make_schedule("linear", 1e-4)
