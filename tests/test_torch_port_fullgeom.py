"""The port at the full ESC-Base geometry against the JAX package.

configs/9kbps_esc_base.yaml as published (codebook_dims 32/32/16/12/8/6),
weights carried from the JAX model. At 12-24 Swin blocks the fp32 sums of
PyTorch-CPU and XLA-CPU run in different orders and may flip near-tie
codebook choices, so codes are held to the repo's full-geometry allowance
of 0.2% (tests/test_torch_parity_fullgeom.py); decoding the same codes
both ways must agree to 5e-4.
"""

import jax
import numpy as np
import pytest
import yaml

from esc_tpu.models import ESC as JaxESC
from esc_tpu_torch.convert import from_jax_params
from esc_tpu_torch.models import make_model
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

L = 15920  # ~1 s -> T=200 frames, token grid (64, 100)


@pytest.fixture(scope="module")
def pair():
    with open("configs/9kbps_esc_base.yaml") as f:
        cfg = yaml.safe_load(f)["model"]
    ref = JaxESC(**cfg)
    ref.init_params(seed=11, example_len=L)
    port = make_model(cfg, device="cpu")
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      ref.variables)))
    return ref, port


def test_full_geometry_roundtrip(pair, rng):
    ref, port = pair
    assert port.num_params() == ref.num_params()
    x = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    codes, fs, recon = ref.roundtrip(x, num_streams=6)
    codes = np.asarray(codes)
    ours, ofs = port.encode(x, num_streams=6)
    assert tuple(ofs) == tuple(fs) and tuple(ours.shape) == codes.shape
    mismatch = (ours.numpy() != codes).mean()
    assert mismatch <= 2e-3, f"code mismatch rate {mismatch:.2%}"
    wave = port.decode(codes, fs).numpy()
    np.testing.assert_allclose(wave, np.asarray(recon), atol=5e-4)
