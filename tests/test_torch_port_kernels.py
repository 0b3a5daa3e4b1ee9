"""The port's two kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_pallas_vq.py
and tests/test_pallas_attention.py do. The CUDA kernels themselves are held
to the plain versions in tests/test_torch_port_cuda.py, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.ops.pallas.attention_kernels import fused_window_attention
from esc_tpu.ops.pallas.vq_kernels import _jnp_argmin, codebook_argmin as jax_argmin
from esc_tpu_torch.ops.kernels import (codebook_argmin, codebook_argmin_plain,
                                       window_attention,
                                       window_attention_plain)
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401


def _normed(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


# ------------------------------------------------------------- (a) argmin
@pytest.mark.parametrize("N,d,K", [(600, 8, 1024), (300, 32, 1024),
                                   (200, 6, 1024), (7, 12, 128),
                                   (1000, 24, 64)])
def test_argmin_matches_pallas_and_jnp(rng, N, d, K):
    z = _normed(rng.standard_normal((N, d))).astype(np.float32)
    cb = _normed(rng.standard_normal((K, d))).astype(np.float32)
    pallas = np.asarray(jax_argmin(jnp.asarray(z), jnp.asarray(cb),
                                   interpret=True))
    ref = np.asarray(_jnp_argmin(jnp.asarray(z), jnp.asarray(cb)))
    ours = codebook_argmin(torch.from_numpy(z), torch.from_numpy(cb))
    assert ours.dtype == torch.int32 and ours.shape == (N,)
    np.testing.assert_array_equal(ours.numpy(), pallas)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_argmin_duplicate_rows_take_first_index(rng):
    cb = rng.standard_normal((64, 8)).astype(np.float32)
    cb[11] = cb[3]
    cb[40] = cb[3]
    z = cb[np.array([3, 11, 40, 5])] + 0.0
    pallas = np.asarray(jax_argmin(jnp.asarray(z), jnp.asarray(cb),
                                   interpret=True))
    ours = codebook_argmin_plain(torch.from_numpy(z), torch.from_numpy(cb))
    assert ours.tolist() == [3, 3, 3, 5] == pallas.tolist()


def test_argmin_all_nan_rows_give_code_zero(rng):
    cb = rng.standard_normal((32, 8)).astype(np.float32)
    z = rng.standard_normal((5, 8)).astype(np.float32)
    z[[1, 3]] = np.nan
    pallas = np.asarray(jax_argmin(jnp.asarray(z), jnp.asarray(cb),
                                   interpret=True))
    ref = np.asarray(_jnp_argmin(jnp.asarray(z), jnp.asarray(cb)))
    ours = codebook_argmin(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    assert ours[1] == ours[3] == 0
    np.testing.assert_array_equal(ours, pallas)
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------- (b) attention
def _attention_inputs(rng, G, nh, hd, masked, nW=5):
    N, C = 16, nh * hd
    q, k, v = (rng.standard_normal((G, N, C)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((nh, N, N)).astype(np.float32)
    mask = None
    if masked:
        mask = np.where(rng.random((nW, N, N)) > 0.5, 0.0,
                        -100.0).astype(np.float32)
    return q, k, v, bias, mask


# (3, 15): all heads in one tile; (24, 16): lane-aligned head groups;
# (24, 8): the (G, nh, N, hd) layout — the TPU kernel's three layouts
@pytest.mark.parametrize("nh,hd", [(3, 15), (24, 16), (24, 8), (6, 12)])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_matches_pallas(rng, nh, hd, masked):
    G = 40
    q, k, v, bias, mask = _attention_inputs(rng, G, nh, hd, masked)
    scale = hd ** -0.5
    jmask = None if mask is None else jnp.tile(jnp.asarray(mask),
                                               (G // mask.shape[0], 1, 1))
    ref = fused_window_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(bias), jmask,
                                 num_heads=nh, scale=scale, interpret=True)
    qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1))
    ours = window_attention(qkv, torch.from_numpy(bias),
                            None if mask is None else torch.from_numpy(mask),
                            nh, scale)
    assert ours.dtype == torch.float32 and ours.shape == (G, 16, nh * hd)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


def test_attention_bf16_tracks_fp32(rng):
    nh, hd, G = 12, 8, 33
    q, k, v, bias, _ = _attention_inputs(rng, G, nh, hd, False)
    ref = fused_window_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(bias), None,
                                 num_heads=nh, scale=hd ** -0.5,
                                 interpret=True)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).to(torch.bfloat16)
    ours = window_attention_plain(qkv, torch.from_numpy(bias), None, nh,
                                  hd ** -0.5)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=5e-2,
                               rtol=5e-2)


def test_cpu_tensors_run_plain_and_count_no_launch(rng):
    before = (codebook_argmin.launches, window_attention.launches)
    z = torch.from_numpy(rng.standard_normal((9, 8)).astype(np.float32))
    cb = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    assert torch.equal(codebook_argmin(z, cb), codebook_argmin_plain(z, cb))
    q, k, v, bias, mask = _attention_inputs(rng, 10, 2, 4, True)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1))
    args = (qkv, torch.from_numpy(bias), torch.from_numpy(mask), 2, 0.5)
    assert torch.equal(window_attention(*args), window_attention_plain(*args))
    assert (codebook_argmin.launches, window_attention.launches) == before
