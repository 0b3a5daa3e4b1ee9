"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from esc_tpu_torch.models import ESC
from esc_tpu_torch.ops.kernels import (codebook_argmin, codebook_argmin_plain,
                                       window_attention,
                                       window_attention_plain)

pytestmark = pytest.mark.cuda

SMALL = dict(in_dim=2, in_freq=192, h_dims=[16, 16, 24, 24, 32, 64],
             max_streams=6, patch_size=[3, 2], swin_heads=[2, 2, 4, 4, 4],
             swin_depth=2, window_size=4, mlp_ratio=2.0, overlap=2,
             group_size=3, codebook_size=128, codebook_dims=[8] * 6,
             l2norm=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(53)


def _normed(rng, shape, dev):
    a = rng.standard_normal(shape)
    return torch.tensor(a / np.linalg.norm(a, axis=-1, keepdims=True),
                        dtype=torch.float32, device=dev)


@pytest.mark.parametrize("d", [6, 8, 12, 16, 32])
def test_argmin_kernel_matches_plain(rng, cuda, d):
    z, cb = _normed(rng, (600, d), cuda), _normed(rng, (1024, d), cuda)
    n = codebook_argmin.launches
    ours = codebook_argmin(z, cb)
    torch.cuda.synchronize()
    assert codebook_argmin.launches == n + 1
    plain = codebook_argmin_plain(z, cb)
    # rows whose two nearest codewords lie within 1e-5 may flip with the
    # order of the fp32 sums; every other row must agree
    two = (torch.cdist(z.double(), cb.double()) ** 2).topk(
        2, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) <= 1e-5
    assert bool(((ours == plain) | near_tie).all())


def test_argmin_kernel_ties_and_nan(rng, cuda):
    cb = torch.tensor(rng.standard_normal((1024, 8)), dtype=torch.float32,
                      device=cuda)
    cb[11] = cb[3]
    z = torch.cat([cb[[3, 11, 5]], torch.full((2, 8), float("nan"),
                                              device=cuda)])
    assert codebook_argmin(z, cb).tolist() == [3, 3, 5, 0, 0]
    assert codebook_argmin_plain(z, cb).tolist() == [3, 3, 5, 0, 0]


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    z = torch.zeros(4, 8, device=cuda)
    with pytest.raises(TypeError):
        codebook_argmin(z.double(), z.double())
    with pytest.raises(ValueError):
        codebook_argmin(z, torch.zeros(16, 8))          # codebook on the CPU
    with pytest.raises(ValueError):
        window_attention(torch.zeros(2, 16, 3 * 99, device=cuda),
                         torch.zeros(3, 16, 16, device=cuda), None, 3, 1.0)


@pytest.mark.parametrize("nh,hd", [(3, 15), (24, 16), (24, 8), (3, 24)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain(rng, cuda, nh, hd, masked, dtype):
    G, C = 300, nh * hd
    qkv = torch.tensor(rng.standard_normal((G, 16, 3 * C)),
                       dtype=torch.float32, device=cuda).to(dtype)
    bias = torch.tensor(rng.standard_normal((nh, 16, 16)),
                        dtype=torch.float32, device=cuda)
    mask = None
    if masked:
        mask = torch.tensor(np.where(rng.random((75, 16, 16)) > 0.5, 0.0,
                                     -100.0), dtype=torch.float32,
                            device=cuda)
    n = window_attention.launches
    ours = window_attention(qkv, bias, mask, nh, hd ** -0.5)
    torch.cuda.synchronize()
    assert window_attention.launches == n + 1
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(
        ours, window_attention_plain(qkv, bias, mask, nh, hd ** -0.5),
        atol=tol, rtol=1e-5 if dtype == torch.float32 else 5e-2)


def test_model_on_kernels_matches_plain_model(rng, cuda):
    x = (0.1 * rng.standard_normal((2, 15920))).astype(np.float32)
    model = ESC(seed=2, device=cuda, **SMALL)
    plain = ESC(seed=2, device=cuda, plain_ops=True, **SMALL)
    before = (codebook_argmin.launches, window_attention.launches)
    codes, fs, recon = model.roundtrip(x, num_streams=6)
    torch.cuda.synchronize()
    assert codebook_argmin.launches > before[0]
    assert window_attention.launches > before[1]
    pcodes, _ = plain.encode(x, num_streams=6)
    assert float((pcodes != codes).float().mean()) <= 2e-3
    torch.testing.assert_close(plain.decode(codes, fs), recon, atol=5e-4,
                               rtol=0)
