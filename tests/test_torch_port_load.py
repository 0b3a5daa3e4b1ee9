"""A reference ``.pth`` loads into the port as it loads into the JAX package.

The reference codec holds torchaudio's ``Spectrogram`` and
``InverseSpectrogram`` as ``ft`` and ``ift``, so every state dict it saves
carries their ``window`` buffers; the JAX package's converter ignores them
(``esc_tpu/convert.py:170-174``). Here the reference-layout state dict of
``tests/torch_mirror.py`` (``tests/test_torch_parity.py``'s config) with
both windows, saved as ``model.pth`` beside a ``config.yaml``, loads through
both packages' ``load_model``, and the codes at ``num_streams`` 6 are
bit-exact with each other and with the mirror's. A key that no module holds
still raises, and a BatchNorm's ``num_batches_tracked`` still loads.
"""

import numpy as np
import pytest
import torch

from esc_tpu.cli.compress import load_model as jax_load_model
from esc_tpu_torch.cli.compress import load_model
from esc_tpu_torch.models import make_model
from tests.test_torch_parity import CONFIG, L
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

CONV = dict(in_dim=2, in_freq=192, h_dims=[8, 8, 8, 12, 12, 16],
            max_streams=6, patch_size=[3, 2], overlap=2, group_size=3,
            codebook_size=32, codebook_dims=[8] * 6, l2norm=True,
            backbone="convolution", kernel_size=[5, 2], conv_depth=1)
STFT_WINDOWS = {"ft.window": torch.hann_window(320),
                "ift.window": torch.hann_window(320)}


def write_model_dir(d, name, config, state_dict):
    lines = [f"model_name: {name}", "model:"]
    for k, v in config.items():
        lines.append(f"  {k}: {str(v).lower() if isinstance(v, bool) else v}")
    (d / "config.yaml").write_text("\n".join(lines) + "\n")
    torch.save(state_dict, d / "model.pth")
    return d


@pytest.fixture(scope="module")
def mirror():
    from tests.torch_mirror import ESCMirror
    torch.manual_seed(5)
    return ESCMirror(**CONFIG).eval()


@pytest.fixture(scope="module")
def reference_dir(mirror, tmp_path_factory):
    sd = {**mirror.state_dict(), **STFT_WINDOWS}
    return write_model_dir(tmp_path_factory.mktemp("ref_pth"), "csvq+swinT",
                           CONFIG, sd)


def test_reference_pth_with_stft_windows_loads_in_both(mirror,
                                                       reference_dir):
    x = (0.1 * np.random.default_rng(31).standard_normal((2, L))
         ).astype(np.float32)
    port = load_model(str(reference_dir), device="cpu")
    ours, fs = port.encode(x, num_streams=6)
    theirs, jfs = jax_load_model(str(reference_dir)).encode(x, num_streams=6)
    ref, rfs = mirror.encode(torch.from_numpy(x), 6)
    assert tuple(fs) == tuple(jfs) == tuple(rfs)
    assert ours.shape == (2, 6, 3, 50)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(ours.numpy(), ref.numpy())


def test_a_truly_unknown_key_still_raises(mirror, tmp_path):
    sd = {**mirror.state_dict(), **STFT_WINDOWS,
          "encoder.bogus.weight": torch.zeros(3)}
    d = write_model_dir(tmp_path, "csvq+swinT", CONFIG, sd)
    with pytest.raises(RuntimeError, match="encoder.bogus.weight"):
        load_model(str(d), device="cpu")
    # a key the reference never held under its STFT transforms' names
    sd = {**mirror.state_dict(), "decoder.ft.window": torch.zeros(3)}
    torch.save(sd, d / "model.pth")
    with pytest.raises(RuntimeError, match="decoder.ft.window"):
        load_model(str(d), device="cpu")


def test_batchnorm_counts_still_load(tmp_path):
    """The conv backbone's BatchNorm layers hold ``num_batches_tracked``:
    it loads into them, beside the ignored STFT windows."""
    src = make_model(CONV, "csvq+conv", seed=3, device="cpu")
    sd = src.state_dict()
    counts = [k for k in sd if k.endswith("num_batches_tracked")]
    assert counts
    for i, k in enumerate(counts):
        sd[k] = torch.tensor(7 + i)
    d = write_model_dir(tmp_path, "csvq+conv", CONV, {**sd, **STFT_WINDOWS})
    model = load_model(str(d), device="cpu")
    got = model.state_dict()
    for i, k in enumerate(counts):
        assert int(got[k]) == 7 + i, k
    for k, v in src.state_dict().items():
        if k not in counts:
            assert torch.equal(got[k], v), k
