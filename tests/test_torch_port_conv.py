"""The port's convolution backbone against the JAX package's, module by
module: PReLU, Convolution2D (conv and transposed, scaling or not),
ResidualUnit and ConvolutionLayer with BatchNorm on running statistics,
the patch layers' conv branch, and the weights carried both ways.

Weights and inputs are drawn from numpy seeds into the JAX modules' own
parameter trees and carried to the port by ``from_jax_params``; the
BatchNorm statistics and PReLU slopes are drawn too, so that a mapping that
mixed them up would show. The port is NCHW, the JAX package NHWC. Odd
shapes are the trouble spot of the crops: H in 2, 3, 5 and W in 1, 2, 7.
Tolerance: outputs within 1e-5 of the output's scale (float32 sums in two
frameworks), shapes equal.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.modules import convolution as jconv
from esc_tpu.modules.scale import PatchDeEmbed as JPatchDeEmbed
from esc_tpu.modules.scale import PatchEmbed as JPatchEmbed
from esc_tpu_torch.convert import (from_jax_params, to_jax_params,
                                   to_jax_variables)
from esc_tpu_torch.modules import convolution as pconv
from esc_tpu_torch.modules.scale import PatchDeEmbed, PatchEmbed

SHAPES = list(itertools.product((2, 3, 5), (1, 2, 7)))
FEW_SHAPES = [(2, 7), (3, 1), (5, 2)]    # each H and each W once


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a test module, restored after it. The suite
    runs a worker per core, and torch's intra-op threads of one worker then
    wait on each other at every small op, which slows a tiny codec's
    training step by two orders of magnitude. Other port test files import
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw_variables(shapes, rng):
    """Values for a flax variable tree of ``jax.ShapeDtypeStruct`` leaves,
    by leaf name: LeCun-normal kernels, small biases, scales near 1,
    PReLU slopes in (0.1, 0.4), BatchNorm means near 0 and variances in
    (0.5, 1.5), Kaiming-normal codebooks, small position biases."""
    def draw(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "weight":
            v = rng.uniform(0.1, 0.4, shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "embedding":
            v = rng.standard_normal(shape) * np.sqrt(2.0 / shape[1])
        else:                     # bias, mean, relative position tables
            v = 0.05 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pair(jmod, pmod, x_nhwc, rng, **kw):
    """Weights drawn for ``jmod``, loaded into ``pmod``; both outputs as
    NCHW numpy."""
    shapes = jax.eval_shape(lambda r, x: jmod.init(r, x, **kw),
                            jax.random.PRNGKey(0), x_nhwc)
    variables = draw_variables(shapes, rng)
    missing = pmod.load_state_dict(from_jax_params(variables), strict=False)
    assert not missing.unexpected_keys
    assert all(k.endswith("num_batches_tracked")
               for k in missing.missing_keys)
    pmod.eval()
    theirs = np.asarray(jmod.apply(variables, x_nhwc, **kw))
    with torch.no_grad():
        ours = pmod(torch.from_numpy(np.ascontiguousarray(
            np.transpose(x_nhwc, (0, 3, 1, 2)))))
    return ours, np.transpose(theirs, (0, 3, 1, 2)), variables


def _close(ours, theirs):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-5,
                               atol=1e-5 * np.abs(theirs).max())


@pytest.mark.parametrize("scale,transpose", [(False, False), (True, False),
                                             (True, True)],
                         ids=["keep", "halve", "double"])
def test_convolution2d_matches_at_odd_shapes(scale, transpose):
    rng = np.random.default_rng(5)
    for H, W in SHAPES:
        x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
        ours, theirs, _ = _pair(
            jconv.Convolution2D(3, 4, (5, 2), scale=scale,
                                transpose=transpose),
            pconv.Convolution2D(3, 4, (5, 2), scale=scale,
                                transpose=transpose), x, rng)
        _close(ours, theirs)
        Ho = (H * 2 if transpose else H // 2) if scale else H
        assert theirs.shape == (2, 4, Ho, W)


@pytest.mark.parametrize("transpose", [False, True], ids=["down", "up"])
def test_convolution_layer_matches_with_batch_norm(transpose):
    """ResidualUnits + scaling conv + BatchNorm + PReLU on the running
    statistics, depth 2, and the layer's (x, H, W) protocol."""
    rng = np.random.default_rng(6)
    for H, W in FEW_SHAPES:
        x = rng.standard_normal((2, H, W, 4)).astype(np.float32)
        jmod = jconv.ConvolutionLayer(4, 6, depth=2, transpose=transpose)
        pmod = pconv.ConvolutionLayer(4, 6, depth=2, transpose=transpose)
        shapes = jax.eval_shape(lambda r, x: jmod.init(r, x),
                                jax.random.PRNGKey(0), x)
        variables = draw_variables(shapes, rng)
        pmod.load_state_dict(from_jax_params(variables), strict=False)
        pmod.eval()
        theirs = np.transpose(np.asarray(jmod.apply(variables, x)),
                              (0, 3, 1, 2))
        with torch.no_grad():
            ours, Ho, Wo = pmod(torch.from_numpy(np.ascontiguousarray(
                np.transpose(x, (0, 3, 1, 2)))), H, W)
        _close(ours, theirs)
        assert (Ho, Wo) == theirs.shape[2:]


def test_residual_unit_and_prelu_match():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 7, 4)).astype(np.float32)
    ours, theirs, _ = _pair(jconv.ResidualUnit(4), pconv.ResidualUnit(4), x,
                            rng)
    _close(ours, theirs)
    ours, theirs, _ = _pair(jconv.PReLU(), pconv.PReLU(), x, rng)
    _close(ours, theirs)
    assert pconv.PReLU().weight.tolist() == [0.25]


def test_patch_layers_convolution_branch_match():
    rng = np.random.default_rng(8)
    feat = rng.standard_normal((2, 24, 10, 2)).astype(np.float32)
    ours, theirs, _ = _pair(
        JPatchEmbed(24, 2, (3, 2), 6, backbone="convolution"),
        PatchEmbed(2, (3, 2), 6, backbone="convolution"), feat, rng)
    _close(ours, theirs)
    assert theirs.shape == (2, 6, 8, 5)
    x = rng.standard_normal((2, 8, 5, 6)).astype(np.float32)
    ours, theirs, _ = _pair(
        JPatchDeEmbed(24, 2, (3, 2), 6, backbone="convolution"),
        PatchDeEmbed(24, 2, (3, 2), 6), x, rng)
    _close(ours, theirs)


def test_weights_and_statistics_go_back_to_flax():
    """to_jax_variables inverts from_jax_params for the conv layers:
    kernels (transposed convs' HWOI too), BatchNorm scale / bias and its
    batch_stats, PReLU slopes, key for key and bit for bit."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((1, 4, 3, 4)).astype(np.float32)
    for transpose in (False, True):
        jmod = jconv.ConvolutionLayer(4, 5, transpose=transpose)
        variables = draw_variables(
            jax.eval_shape(lambda r, x: jmod.init(r, x),
                           jax.random.PRNGKey(0), x), rng)
        pmod = pconv.ConvolutionLayer(4, 5, transpose=transpose)
        pmod.load_state_dict(from_jax_params(variables), strict=False)
        back = to_jax_variables(pmod)
        assert set(back) == {"params", "batch_stats"}
        assert to_jax_params(pmod).keys() == back["params"].keys()
        flat = dict(jax.tree_util.tree_leaves_with_path(variables))
        flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
        assert flat.keys() == flat_back.keys()
        for k, v in flat.items():
            np.testing.assert_array_equal(flat_back[k], v)


def test_bf16_convolution_widens_to_float32():
    """The bf16 serving mode runs the convolution in bf16 and returns
    float32, as flax's ``nn.Conv(dtype=bf16)`` ahead of BatchNorm."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    conv = pconv.Convolution2D(3, 4, scale=True, transpose=True)
    with torch.no_grad():
        ref = conv(torch.from_numpy(x))
        conv.compute_dtype = torch.bfloat16
        y = conv(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert torch.equal(y, y.bfloat16().float())
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=0,
                               atol=3e-2 * float(ref.abs().max()))
    jy = jconv.Convolution2D(3, 4, scale=True, transpose=True,
                             dtype=jnp.bfloat16)
    assert jy.dtype == jnp.bfloat16          # the JAX package's bf16 conv
