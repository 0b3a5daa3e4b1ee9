"""The whole port (ESC, csvq+swinT) against the JAX package, downsized.

Weights are made by the JAX model and carried into the port by
``esc_tpu_torch.convert.from_jax_params``; at this size codes must be
bit-exact and the decoded waveform within 5e-4 (tests/test_torch_parity.py
holds the JAX model to the torch reference with the same bars).
"""

import jax
import numpy as np
import pytest
import torch

from esc_tpu.convert import flax_to_torch
from esc_tpu.models import ESC as JaxESC
from esc_tpu_torch.convert import from_jax_params
from esc_tpu_torch.models import ESC, make_model
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

CONFIG = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[16, 16, 24, 24, 32, 64], max_streams=6,
    win_len=20, hop_len=5, sr=16000, patch_size=[3, 2],
    swin_heads=[2, 2, 4, 4, 4], swin_depth=2, window_size=4,
    mlp_ratio=2.0, overlap=2, group_size=3, codebook_size=128,
    codebook_dims=[8, 8, 8, 8, 8, 8], l2norm=True,
)
L = 15920  # ~1 s -> T=200 frames, tokens (64, 100)


@pytest.fixture(scope="module")
def pair():
    ref = JaxESC(**CONFIG)
    ref.init_params(seed=7, example_len=L)
    port = ESC(device="cpu", **CONFIG)
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      ref.variables)))
    return ref, port


def test_carried_state_dict_is_the_reference_layout(pair):
    ref, port = pair
    ours = port.state_dict()
    theirs = flax_to_torch(ref.variables)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert port.num_params() == ref.num_params()


@pytest.mark.parametrize("num_streams", [1, 3, 6])
def test_codes_bit_exact(pair, rng, num_streams):
    ref, port = pair
    x = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    rc, rfs = ref.encode(x, num_streams=num_streams)
    oc, ofs = port.encode(x, num_streams=num_streams)
    assert tuple(ofs) == tuple(rfs)
    assert oc.dtype == torch.int32
    assert tuple(oc.shape) == np.asarray(rc).shape == (2, num_streams, 3, 50)
    mismatch = (oc.numpy() != np.asarray(rc)).mean()
    assert mismatch == 0.0, f"code mismatch rate {mismatch:.2%}"


def test_waveform_matches(pair, rng):
    ref, port = pair
    x = (0.1 * rng.standard_normal((1, L))).astype(np.float32)
    codes, fs, recon = ref.roundtrip(x, num_streams=6)
    ours = port.decode(np.asarray(codes), fs).numpy()
    assert ours.shape == np.asarray(recon).shape == (1, L)
    np.testing.assert_allclose(ours, np.asarray(recon), atol=5e-4)
    # the port's own roundtrip gives the same codes and waveform
    oc, ofs, orec = port.roundtrip(x, num_streams=6)
    np.testing.assert_array_equal(oc.numpy(), np.asarray(codes))
    np.testing.assert_allclose(orec.numpy(), np.asarray(recon), atol=5e-4)


def test_geometry_helpers_match(pair):
    ref, port = pair
    for n in (15920, 47920, 16000, 1234):
        assert port.feat_shape(n) == ref.feat_shape(n)
        assert port.pad_length(n) == ref.pad_length(n)
    assert port.max_bps == ref.max_bps
    assert port.max_streams == ref.max_streams
    with pytest.raises(ValueError):
        port.encode(np.zeros((1, L), np.float32), num_streams=7)


def test_make_model_normalizes_and_seeds():
    cfg = dict(CONFIG)
    cfg["codebook_dim"] = cfg.pop("codebook_dims")[0]
    cfg["num_rvqs"] = 6
    a = make_model(cfg, seed=3, device="cpu")
    b = make_model(cfg, seed=3, device="cpu")
    c = make_model(cfg, seed=4, device="cpu")
    assert a.config["codebook_dims"] == [8] * 6
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    with pytest.raises(ValueError, match="not valid"):
        make_model(cfg, model_name="rvq+mlp", device="cpu")
