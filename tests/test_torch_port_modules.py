"""The port's signal front end and Swin layers against the JAX package.

Inputs are made with numpy from a seed; weights made by the flax modules
are carried into the port with ``esc_tpu_torch.convert.from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.modules import scale as jscale
from esc_tpu.modules import transformer as jtr
from esc_tpu.ops import stft as jstft
from esc_tpu_torch.convert import from_jax_params
from esc_tpu_torch.modules import scale as pscale
from esc_tpu_torch.modules import transformer as ptr
from esc_tpu_torch.ops import stft as pstft


def _carry(module, params):
    """Load flax params (one module's subtree) into a torch module."""
    sd = from_jax_params(jax.tree.map(np.asarray, params))
    module.load_state_dict(sd)
    return module.eval()


# ------------------------------------------------------- (c) STFT / ISTFT
@pytest.mark.parametrize("L", [15920, 47920, 16000])
def test_stft_matches_jax(rng, L):
    x = rng.standard_normal((2, L)).astype(np.float32)
    ref = np.asarray(jstft.spec_transform(jnp.asarray(x)))
    ours = pstft.spec_transform(torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, 2, 192, L // 80 + 1)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("T", [200, 600])
def test_istft_matches_jax(rng, T):
    spec = rng.standard_normal((2, 2, 192, T)).astype(np.float32)
    ref = np.asarray(jstft.audio_reconstruct(jnp.asarray(spec)))
    ours = pstft.audio_reconstruct(torch.from_numpy(spec)).numpy()
    assert ours.shape == ref.shape == (2, (T - 1) * 80)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-4)


def test_stft_istft_roundtrip(rng):
    x = rng.standard_normal((1, 15920)).astype(np.float32)
    y = pstft.audio_reconstruct(pstft.spec_transform(torch.from_numpy(x)))
    np.testing.assert_allclose(y.numpy(), x, atol=1e-4)


# ------------------------------------------------------ (d) Swin + scale
@pytest.mark.parametrize("H,W,C,nh,shift", [(8, 12, 24, 2, 2),
                                            (5, 10, 45, 3, 2),
                                            (4, 8, 32, 4, 0)])
def test_swin_block_matches_jax(rng, H, W, C, nh, shift):
    x = rng.standard_normal((2, H * W, C)).astype(np.float32)
    jblk = jtr.SwinBlock(d_model=C, num_heads=nh, window_size=4,
                         shift_size=shift, mlp_ratio=2.0)
    params = jblk.init(jax.random.PRNGKey(3), jnp.asarray(x), H, W)
    # a non-zero relative position table, so the bias path is exercised
    table = params["params"]["attn"]["relative_position_bias_table"]
    params = jax.tree.map(lambda a: a, params)
    params["params"]["attn"]["relative_position_bias_table"] = jnp.asarray(
        rng.standard_normal(table.shape).astype(np.float32))
    ref = np.asarray(jblk.apply(params, jnp.asarray(x), H, W))
    blk = _carry(ptr.SwinBlock(C, nh, 4, shift, 2.0), params)
    with torch.no_grad():
        ours = blk(torch.from_numpy(x), H, W).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("scale,H", [("down", 8), ("down", 5), ("up", 4)])
def test_transformer_layer_matches_jax(rng, scale, H):
    W, C, out = 8, 24, 32
    x = rng.standard_normal((2, H * W, C)).astype(np.float32)
    jl = jtr.TransformerLayer(C, out, 2, depth=2, window_size=4,
                              mlp_ratio=2.0, scale=scale)
    params = jl.init(jax.random.PRNGKey(4), jnp.asarray(x), H, W)
    ref, rH, rW = jl.apply(params, jnp.asarray(x), H, W)
    layer = _carry(ptr.TransformerLayer(C, out, 2, 2, 4, 2.0, scale), params)
    with torch.no_grad():
        ours, oH, oW = layer(torch.from_numpy(x), H, W)
    assert (oH, oW) == (rH, rW)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


def test_patch_embed_and_deembed_match_jax(rng):
    feat = rng.standard_normal((2, 2, 192, 20)).astype(np.float32)
    je = jscale.PatchEmbed(192, 2, (3, 2), 16)
    nhwc = jnp.asarray(feat.transpose(0, 2, 3, 1))
    pe = je.init(jax.random.PRNGKey(5), nhwc)
    tokens = je.apply(pe, nhwc)
    ours = _carry(pscale.PatchEmbed(2, (3, 2), 16), pe)
    with torch.no_grad():
        ot = ours(torch.from_numpy(feat))
    np.testing.assert_allclose(ot.numpy(), np.asarray(tokens), atol=2e-5,
                               rtol=1e-5)

    jd = jscale.PatchDeEmbed(192, 2, (3, 2), 16)
    pd = jd.init(jax.random.PRNGKey(6), tokens)
    ref = np.asarray(jd.apply(pd, tokens)).transpose(0, 3, 1, 2)
    de = _carry(pscale.PatchDeEmbed(192, 2, (3, 2), 16), pd)
    with torch.no_grad():
        back = de(torch.from_numpy(np.array(tokens))).numpy()
    assert back.shape == feat.shape
    np.testing.assert_allclose(back, ref, atol=2e-5, rtol=1e-5)


def test_swin_mask_and_index_match_jax():
    for H, W in [(64, 300), (2, 300), (5, 7)]:
        np.testing.assert_array_equal(ptr.swin_attention_mask(H, W, 4, 2),
                                      jtr.swin_attention_mask(H, W, 4, 2))
    np.testing.assert_array_equal(ptr.relative_position_index(4, 4),
                                  jtr.relative_position_index(4, 4))
