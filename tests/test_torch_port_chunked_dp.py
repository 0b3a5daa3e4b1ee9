"""Long files and eval batches over several devices: the port's
``encode_chunked_dp`` / ``decode_chunked_dp``, ``eval_epoch(dp=...)`` and
the test CLI's ``--data_parallel``, against the JAX package's
(``tests/test_chunked_dp.py``'s pattern) at its tiny config.

Weights are drawn from a numpy seed into the JAX model's own tree
(``jax.eval_shape`` of its init) and carried into the port. The replicas
here are CPU devices: ``Replicas(["cpu"] * 3)`` gives three pieces of each
wave to one codec, and ``"cpu:0"`` beside ``"cpu"`` is a second device name,
so the codec is copied onto it. Bars: codes bit-exact with the JAX package
(``dp=None``, the serial uniform-window pass); the waveform decoded from the
same codes within 5e-4; every replica set bit-identical to ``dp=None``;
``all_perf`` equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.models import make_model as jax_make_model
from esc_tpu.parallel import decode_chunked_dp as jax_decode_chunked_dp
from esc_tpu.parallel import encode_chunked_dp as jax_encode_chunked_dp
from esc_tpu_torch import metrics as pm
from esc_tpu_torch.cli import test as port_test_cli
from esc_tpu_torch.convert import from_jax_params
from esc_tpu_torch.io import save_wav
from esc_tpu_torch.models import make_model
from esc_tpu_torch.parallel import (Replicas, decode_chunked_dp,
                                    encode_chunked_dp)
from esc_tpu_torch.parallel.chunked import _grid, _starts
from esc_tpu_torch.train.data import make_dataloader
from esc_tpu_torch.train.evaluate import eval_epoch
from tests.test_model_shapes import TINY_CONFIG
from tests.test_torch_port_conv import draw_variables
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

L = 2 * 47920 + 80            # 300 code frames: 13 chunks of 24
KW = dict(chunk_seconds=0.5, margin_seconds=0.25)
CLIPS = (8000, 6400, 9600, 5120, 7040, 4800)


@pytest.fixture(scope="module")
def pair():
    """(JAX codec, port codec) with the same drawn weights."""
    ref = jax_make_model(TINY_CONFIG, "csvq+swinT")
    shapes = jax.eval_shape(
        lambda r, x: ref.module.init(r, x, None, 6, False, False),
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 15360), jnp.float32))
    ref.variables = draw_variables(shapes, np.random.default_rng(29))
    port = make_model(TINY_CONFIG, "csvq+swinT", device="cpu")
    port.load_state_dict(from_jax_params(ref.variables))
    return ref, port


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(41)
    return (0.2 * rng.standard_normal((2, L))).astype(np.float32)


def test_uniform_windows_cover_the_file(pair):
    _, port = pair
    chunk, margin = _grid(port.module, KW["chunk_seconds"],
                          KW["margin_seconds"], 320)
    assert (chunk, margin) == (24, 12)
    metas = _starts(300, chunk, chunk + 2 * margin, 2)
    assert len(metas) == 13 and len(metas) % 3
    assert sum(keep for _, _, keep in metas) == 300
    assert all(s % 2 == 0 and 0 <= s <= 300 - 48 for s, _, _ in metas)


def test_serial_pass_matches_the_jax_package(pair, audio):
    ref, port = pair
    x = audio[:1]
    theirs, fs = jax_encode_chunked_dp(ref, x, num_streams=3, dp=None, **KW)
    ours, ours_fs = encode_chunked_dp(port, x, num_streams=3, dp=None, **KW)
    assert tuple(ours_fs) == tuple(fs)
    assert ours.shape == (1, 3, 3, 300) and ours.device == port.device
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    codes = np.asarray(theirs)
    np.testing.assert_allclose(
        decode_chunked_dp(port, codes, fs, dp=None, **KW).numpy(),
        np.asarray(jax_decode_chunked_dp(ref, codes, fs, dp=None, **KW)),
        rtol=0, atol=5e-4)


@pytest.mark.parametrize("devices", [["cpu"] * 3, ["cpu", "cpu:0"]])
def test_replicas_are_bit_identical_to_the_serial_pass(pair, audio,
                                                       devices):
    """13 segments over 3 replicas (a tail wave filled with copies), or
    over the codec and its copy on a second device name."""
    _, port = pair
    x = audio[:1]
    dp = Replicas(devices)
    serial, fs = encode_chunked_dp(port, x, num_streams=3, **KW)
    spread, fs_dp = encode_chunked_dp(port, x, num_streams=3, dp=dp, **KW)
    assert tuple(fs_dp) == tuple(fs)
    assert torch.equal(spread, serial)
    assert torch.equal(decode_chunked_dp(port, spread, fs, dp=dp, **KW),
                       decode_chunked_dp(port, serial, fs, **KW))


def test_replicate_copies_onto_other_devices(pair):
    _, port = pair
    dp = Replicas(["cpu", "cpu:0", "cpu"])
    assert dp.num_devices == 3
    first, copy, again = dp.replicate(port)
    assert first is port and again is port
    assert copy is not port and copy.module is not port.module
    assert copy.device == torch.device("cpu:0") and copy.dtype == port.dtype
    for k, v in port.state_dict().items():
        assert torch.equal(copy.state_dict()[k], v), k
    with pytest.raises(ValueError, match="pieces"):
        dp.map([port], lambda r, x: x, [np.zeros(1)] * 2)


def test_batch_rows_stay_separate(pair, audio):
    _, port = pair
    dp = Replicas(["cpu", "cpu:0"])
    both, _ = encode_chunked_dp(port, audio, num_streams=2, dp=dp, **KW)
    for b in range(2):
        one, _ = encode_chunked_dp(port, audio[b:b + 1], num_streams=2,
                                   dp=dp, **KW)
        assert torch.equal(both[b], one[0])


@pytest.fixture(scope="module")
def eval_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_eval_wavs")
    rng = np.random.default_rng(3)
    for i, n in enumerate(CLIPS):
        t = np.arange(n) / 16000.0
        x = 0.2 * np.sin(2 * np.pi * (140 + 35 * i) * t) \
            + 0.02 * rng.standard_normal(n)
        save_wav(str(d / f"clip_{i}.wav"), x.astype(np.float32))
    return str(d)


def _sweep(port, folder, batch, dp):
    loader = make_dataloader(folder, batch, False, pad_eval=True,
                             pad_fn=port.pad_length)
    metrics = {"MelDistance": pm.MelSpectrogramDistance(),
               "SISDR": pm.SISDR(), "STOI": pm.STOI()}
    return eval_epoch(port, loader, metrics, pm.EntropyCounter(64, 6, 3),
                      num_streams=3, verbose=False, dp=dp)


@pytest.mark.parametrize("batch", [2, 3])
def test_eval_epoch_with_replicas_equals_one_device(pair, eval_folder,
                                                    batch):
    """Batches of 2 split over the two replicas; batches of 3 do not
    divide and run on the model's device alone."""
    _, port = pair
    dp = Replicas(["cpu", "cpu:0"])
    assert _sweep(port, eval_folder, batch, dp) == \
        _sweep(port, eval_folder, batch, None)


def test_test_cli_data_parallel_on_the_cpu(pair, eval_folder, tmp_path,
                                           capsys):
    _, port = pair
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    lines = ["model_name: csvq+swinT", "model:"] + [
        f"  {k}: {str(v).lower() if isinstance(v, bool) else v}"
        for k, v in TINY_CONFIG.items()]
    (model_dir / "config.yaml").write_text("\n".join(lines) + "\n")
    torch.save(port.state_dict(), model_dir / "model.pth")
    out = {}
    for name, extra in (("one", []), ("dp", ["--data_parallel"])):
        save = tmp_path / name
        port_test_cli.run(port_test_cli.parse_args(
            ["--eval_folder_path", eval_folder, "--model_path",
             str(model_dir), "--batch_size", "2", "--num_streams", "2",
             "--device", "cpu", "--save_path", str(save), *extra]))
        out[name] = json.loads((save / "perf_stats.json").read_text())
    said = capsys.readouterr().out
    assert "Evaluating on 1 device(s): cpu" in said
    assert out["dp"] == out["one"]
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in out["dp"].values())


def test_chip_smoke_predicts_the_chunked_dp_calls(pair, audio, monkeypatch):
    """chip_smoke.py phase 10's launch counts: every segment a roundtrip of
    W code frames, the tail wave filled."""
    import chip_smoke
    from esc_tpu_torch.modules import transformer, vq
    from esc_tpu_torch.ops.kernels import (codebook_argmin_plain,
                                           window_attention_plain)

    _, port = pair
    seen = {"argmin": [], "attn": []}

    def argmin(z, cb):
        seen["argmin"].append((z.shape[0], cb.shape[0], z.shape[1]))
        return codebook_argmin_plain(z, cb)

    def attention(qkv, bias, mask, nh, scale):
        seen["attn"].append((qkv.shape[0], nh, qkv.shape[2] // 3 // nh,
                             mask is not None))
        return window_attention_plain(qkv, bias, mask, nh, scale)

    monkeypatch.setattr(vq, "codebook_argmin", argmin)
    monkeypatch.setattr(transformer, "window_attention", attention)
    dp = Replicas(["cpu"] * 3)
    codes, fs = encode_chunked_dp(port, audio[:1], num_streams=6, dp=dp,
                                  **KW)
    decode_chunked_dp(port, codes, fs, dp=dp, **KW)
    argmin_calls, attn_calls, segments = chip_smoke.chunked_dp_calls(
        TINY_CONFIG, L, 3, **KW)
    assert segments == 13
    assert sorted(seen["argmin"]) == sorted(argmin_calls)
    assert sorted(seen["attn"]) == sorted(attn_calls)
