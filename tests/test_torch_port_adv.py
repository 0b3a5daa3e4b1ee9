"""The port's discriminator, resampling and GAN losses against the JAX
package's: feature maps, per-sample losses and their gradients, the
discriminator's init and its weights carried to flax and back.
(``tests/test_torch_port_adv_train.py`` holds the adversarial trainer.)

Weights are made by the JAX package and carried into the port
(``esc_tpu_torch.convert.from_jax_params``); inputs come from numpy seeds.
Tolerances, each stated where it is used: feature maps rtol 2e-3 / atol
2e-4 (``tests/test_torch_parity_disc.py``'s bars); resampling rtol 1e-5,
atol 1e-6 on unit-scale signals; GAN losses and their gradients rtol 1e-4;
init norms and carried weights to float rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.models.discriminator import Discriminator as JaxDisc
from esc_tpu.modules.gan_loss import discriminator_loss as jax_disc_loss
from esc_tpu.modules.gan_loss import generator_loss as jax_gen_loss
from esc_tpu.ops import resample as jax_resample
from esc_tpu_torch.convert import from_jax_params, to_jax_params
from esc_tpu_torch.models.discriminator import (Discriminator, WNConv,
                                                init_discriminator)
from esc_tpu_torch.modules.gan_loss import discriminator_loss, generator_loss
from esc_tpu_torch.ops import resample as port_resample
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

B, L = 2, 4000
SMALL = dict(periods=(2, 3), fft_sizes=(512, 256), sample_rate=16000)
ADV_DISC = dict(rates=(), periods=(2, 3, 5, 7, 11),
                fft_sizes=(2048, 1024, 512), sample_rate=16000)


def _pair(cfg, length, seed=0):
    """A JAX discriminator (its ``apply`` jitted, the parameters an
    argument: XLA would fold closed-over weights for minutes), its
    parameters, and the port's discriminator with its weights."""
    jd = JaxDisc(**cfg)
    params = jax.jit(jd.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, length), jnp.float32))["params"]
    params = jax.tree.map(np.asarray, params)
    port = Discriminator(**cfg)
    port.load_state_dict(from_jax_params(params))
    return jax.jit(lambda p, x: jd.apply({"params": p}, x)), params, port


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("cfg,length,batch", [
    (dict(SMALL, rates=(1,)), L, B), (dict(SMALL, rates=(2,)), L, B),
    (ADV_DISC, 7920, 1)], ids=["rate1", "rate2", "adv_config"])
def test_feature_maps_match_jax(cfg, length, batch, rng):
    """rtol 2e-3, atol 2e-4 (tests/test_torch_parity_disc.py's bars)."""
    apply, params, port = _pair(cfg, length)
    x = (0.5 * rng.standard_normal((batch, length))).astype(np.float32)
    theirs = apply(params, jnp.asarray(x))
    with torch.no_grad():
        ours = port(torch.from_numpy(x))
    assert len(ours) == len(theirs) == len(cfg["periods"]) + len(
        cfg["rates"]) + len(cfg["fft_sizes"])
    for di, (o, t) in enumerate(zip(ours, theirs)):
        assert len(o) == len(t), di
        for li, (f, g) in enumerate(zip(o, t)):
            np.testing.assert_allclose(_nhwc(f), np.asarray(g), rtol=2e-3,
                                       atol=2e-4, err_msg=f"{di}/{li}")


@pytest.mark.parametrize("orig,new", [(16000, 8000), (16000, 4000),
                                      (8000, 16000)])
@pytest.mark.parametrize("fn", ["resample_julius", "resample"])
def test_resampling_matches_jax(fn, orig, new, rng):
    """rtol 1e-5, atol 1e-6 on a unit-scale signal; the same output
    lengths."""
    x = rng.standard_normal((2, 3001)).astype(np.float32)
    theirs = np.asarray(getattr(jax_resample, fn)(jnp.asarray(x), orig, new))
    ours = getattr(port_resample, fn)(torch.from_numpy(x), orig, new)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-6)
    one = getattr(port_resample, fn)(torch.from_numpy(x[0]), orig, new)
    np.testing.assert_allclose(one.numpy(), theirs[0], rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def small_pair():
    return _pair(dict(SMALL, rates=(1,)), L)


def test_gan_losses_and_their_gradients_match_jax(small_pair, rng):
    """Per-sample losses and d(gen + feat)/d(fake), d(disc)/d(fake) = 0:
    rtol 1e-4 (atol 1e-4 of the gradient's largest entry)."""
    apply, params, port = small_pair
    fake = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
    real = (0.3 * rng.standard_normal((B, L))).astype(np.float32)
    j_d = np.asarray(jax.jit(jax_disc_loss, static_argnums=0)(
        apply, params, jnp.asarray(fake), jnp.asarray(real)))

    def j_total(fk, p, re):
        g, f = jax_gen_loss(apply, p, fk, re)
        return jnp.sum(g) + jnp.sum(f), (g, f)

    (_, (j_g, j_f)), j_grad = jax.jit(jax.value_and_grad(
        j_total, has_aux=True))(jnp.asarray(fake), params,
                                jnp.asarray(real))
    tf = torch.from_numpy(fake).requires_grad_(True)
    d = discriminator_loss(port, tf, torch.from_numpy(real))
    g, f = generator_loss(port, tf, torch.from_numpy(real))
    assert d.shape == g.shape == f.shape == (B,)
    (g.sum() + f.sum()).backward()
    for ours, theirs in ((d, j_d), (g, j_g), (f, j_f)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-6)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(tf.grad.numpy(), j_grad, rtol=1e-4,
                               atol=1e-4 * np.abs(j_grad).max())
    # the fake is detached in the discriminator's loss
    tf.grad = None
    discriminator_loss(port, tf, torch.from_numpy(real)).sum().backward()
    assert tf.grad is None


def test_init_gives_unit_norm_per_output_channel():
    """As flax's WeightNorm(Conv): scale ones, so each output channel's
    kernel has norm 1 (to 1e-5), biases zero; directions LeCun-normal
    truncated at two standard deviations, the same seed the same weights."""
    a = init_discriminator(Discriminator(rates=(2,), **SMALL), 7)
    b = init_discriminator(Discriminator(rates=(2,), **SMALL), 7)
    convs = [m for m in a.modules() if isinstance(m, WNConv)]
    assert len(convs) == 2 * 6 + 7 + 2 * (5 * 5 + 1)
    for m in convs:
        with torch.no_grad():
            w = m.weight()
        norms = w.flatten(1).norm(dim=1)
        np.testing.assert_allclose(norms.numpy(), 1.0, rtol=0, atol=1e-5)
        assert torch.all(m.weight_g == 1.0) and torch.all(m.bias == 0.0)
        v = m.weight_v.detach()
        fan_in = v[0].numel()
        scaled = v * fan_in ** 0.5 * 0.87962566103423978
        assert float(scaled.abs().max()) <= 2.0 + 1e-5
        if v.numel() > 20000:
            assert abs(float(scaled.std()) - 0.87962566) < 0.02
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    # the JAX package's init is unit-norm the same way
    _, _, port = _pair(dict(SMALL, rates=(2,)), L, seed=1)
    for m in port.modules():
        if isinstance(m, WNConv):
            with torch.no_grad():
                norms = m.weight().flatten(1).norm(dim=1)
            np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_weights_round_trip_through_flax(small_pair):
    """flax -> port -> flax and port -> flax -> port are exact."""
    _, params, port = small_pair
    theirs = _flat(jax.tree.map(np.asarray, params))
    ours = _flat(to_jax_params(port))
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    again = from_jax_params(to_jax_params(port))
    for k, v in port.state_dict().items():
        assert torch.equal(again[k], v), k


