"""The port's DAC baseline against the JAX package's and the reference mirror,
at ``tests/test_torch_parity_dac.py``'s config.

The reference-layout state dict of ``tests/torch_mirror_dac.py`` loads into
the port as it is and into the JAX package through its converter (against
the tree of ``jax.eval_shape`` of its init, so nothing is compiled for the
weights). Bars: codes bit-exact with the JAX package and with the mirror;
waveforms decoded from the same codes within 1e-4; ``.dac`` files read
across both packages; the analytic geometry equal; the training forward
with a per-sample dropout mask and ``from_latents`` equal in codes, their
values within 1e-4; the four losses within rtol 5e-4 and each gradient's
cosine above 0.995 (``tests/test_torch_parity_trainstep.py``'s bars); the
weights carried to the flax tree and back bit for bit; a 2-step trainer
with validation, tags and resume, adversarial or not; the CLI with no
PyYAML importable.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from esc_tpu.baselines.dac import DAC as JaxDAC
from esc_tpu.baselines.dac import DACFile as JaxDACFile
from esc_tpu.baselines.dac import losses as jax_losses
from esc_tpu.convert import torch_to_flax
from esc_tpu_torch.baselines.dac import DAC, DACFile
from esc_tpu_torch.baselines.dac import __main__ as dac_cli
from esc_tpu_torch.baselines.dac import losses
from esc_tpu_torch.baselines.dac.quantize import ResidualVectorQuantize
from esc_tpu_torch.baselines.dac.trainer import DACTrainer
from esc_tpu_torch.checkpoint import load_checkpoint
from esc_tpu_torch.convert import from_jax_params, to_jax_params
from esc_tpu_torch.io import load_wav, save_wav
from esc_tpu_torch.utils.config import read_yaml
from tests.test_torch_parity_dac import CFG, L
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def models():
    """(mirror, JAX DAC, port DAC) with the mirror's weights."""
    from tests.torch_mirror_dac import DACMirror
    torch.manual_seed(4)
    mirror = DACMirror(**CFG).eval()
    ref = JaxDAC(sample_rate=SR, quantizer_dropout=0.0, **CFG)
    shapes = jax.eval_shape(lambda: ref.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, L)), None, False))
    ref.variables = torch_to_flax(mirror.state_dict(), jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    port = DAC(device="cpu", sample_rate=SR, quantizer_dropout=0.0, **CFG)
    port.load_state_dict(mirror.state_dict())
    return mirror, ref, port


@pytest.fixture(scope="module")
def speech():
    t = np.arange(2 * SR) / SR
    rng = np.random.default_rng(7)
    x = 0.4 * np.sin(2 * np.pi * 330 * t) * (0.6 + 0.4 * np.sin(
        2 * np.pi * 3 * t)) + 0.05 * rng.standard_normal(t.shape)
    return x.astype(np.float32)


def test_weights_carry_both_ways(models):
    _, ref, port = models
    ours = dict(_flat(to_jax_params(port.module)))
    theirs = dict(_flat(jax.tree.map(np.asarray, ref.variables["params"])))
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], v, err_msg="/".join(k))
    back = from_jax_params(ref.variables)
    sd = port.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_codes_bit_exact_and_waveforms(models, rng):
    mirror, ref, port = models
    x = (0.2 * rng.standard_normal((2, L))).astype(np.float32)
    out = port(x)
    theirs = jax.tree.map(np.asarray, ref(x))
    codes = out["codes"].numpy()
    assert codes.shape == (2, 4, L // 320)
    np.testing.assert_array_equal(codes, theirs["codes"])
    np.testing.assert_array_equal(codes, mirror.encode(
        torch.from_numpy(x), 4).numpy())
    np.testing.assert_allclose(out["audio"].numpy(), theirs["audio"],
                               atol=1e-4)
    np.testing.assert_allclose(out["z"].numpy().transpose(0, 2, 1),
                               theirs["z"], atol=1e-4)
    for k in ("vq/commitment_loss", "vq/codebook_loss"):
        np.testing.assert_allclose(float(out[k]), theirs[k], rtol=1e-4)
    # the same codes decoded by the three
    ours = port.decode_codes(codes).numpy()
    np.testing.assert_allclose(ours, mirror.decode_codes(
        torch.from_numpy(codes).long()).numpy(), atol=1e-4)
    np.testing.assert_allclose(ours, np.asarray(ref._decode_codes(
        ref.variables, codes, True)), atol=1e-4)
    # the eval early exit: two stages, the first two codes
    two = port(x, n_quantizers=2)["codes"].numpy()
    np.testing.assert_array_equal(two, codes[:, :2])


@pytest.mark.parametrize("rates", [([2, 4, 5, 8], [8, 5, 4, 2]),
                                   ([2, 4, 8, 8], [8, 8, 4, 2])])
def test_geometry_equals_the_jax_package(rates):
    cfg = dict(CFG, encoder_rates=rates[0], decoder_rates=rates[1])
    ref = JaxDAC(sample_rate=SR, **cfg)
    port = DAC(device="cpu", sample_rate=SR, **cfg)
    assert port.hop_length == ref.hop_length
    assert port.delay == ref.get_delay() == port.get_delay() > 0
    for n in (0, 320, 16000, 16321, 48000):
        assert port.get_output_length(n) == ref.get_output_length(n)


@pytest.mark.parametrize("win_duration", [1.0, 10.0])
def test_compress_decompress_across_packages(models, speech, tmp_path,
                                             win_duration):
    _, ref, port = models
    ours = port.compress(speech, win_duration=win_duration)
    theirs = ref.compress(speech, win_duration=win_duration)
    assert ours.padding is (win_duration > 2.0)
    np.testing.assert_array_equal(ours.codes, theirs.codes)
    for k in ("chunk_length", "original_length", "channels", "sample_rate",
              "padding"):
        assert getattr(ours, k) == getattr(theirs, k), k
    assert ours.input_db == pytest.approx(theirs.input_db, abs=1e-9)
    # each package reads the other's file
    mine = DACFile.load(ours.save(str(tmp_path / "port")))
    other = JaxDACFile.load(ours.save(str(tmp_path / "port")))
    from_jax = DACFile.load(theirs.save(str(tmp_path / "jax")))
    for f in (mine, other, from_jax):
        np.testing.assert_array_equal(f.codes, ours.codes)
    y = port.decompress(str(tmp_path / "jax.dac"))
    assert y.shape == (1, len(speech))
    np.testing.assert_allclose(y, ref.decompress(str(tmp_path / "port.dac")),
                               atol=1e-4)


def test_dropout_mask_and_training_forward(models, rng):
    _, ref, port = models
    rvq = ResidualVectorQuantize(n_codebooks=4, quantizer_dropout=0.5)
    n_q = rvq.sample_dropout(torch.Generator().manual_seed(0), 8)
    assert n_q.shape == (8,) and n_q.dtype == torch.int32
    assert bool(((n_q[:4] >= 1) & (n_q[:4] <= 4)).all())
    assert bool((n_q[4:] == 5).all())
    # stages past 1 and past 3 masked out of the first two samples, none of
    # the last
    x = (0.2 * rng.standard_normal((3, 4800))).astype(np.float32)
    n_q = np.array([1, 3, 5], np.int32)
    port.module.train()
    try:
        out = port.module(torch.from_numpy(x), torch.from_numpy(n_q))
    finally:
        port.module.eval()
    theirs = jax.tree.map(np.asarray, ref.module.apply(
        ref.variables, x, jnp.asarray(n_q), True))
    np.testing.assert_array_equal(out["codes"].numpy(), theirs["codes"])
    np.testing.assert_allclose(out["audio"].detach().numpy(),
                               theirs["audio"], atol=1e-4)
    for k in ("vq/commitment_loss", "vq/codebook_loss"):
        np.testing.assert_allclose(float(out[k].detach()), theirs[k],
                                   rtol=1e-4)


@pytest.mark.parametrize("stages", [4, 2])
def test_from_latents(models, rng, stages):
    _, ref, port = models
    x = (0.2 * rng.standard_normal((2, 3200))).astype(np.float32)
    latents = port(x)["latents"][:, :4 * stages]
    with torch.no_grad():
        z_q, z_p, codes = port.module.quantizer.from_latents(latents)
    theirs = jax.tree.map(np.asarray, ref.module.apply(
        ref.variables, jnp.asarray(latents.numpy().transpose(0, 2, 1)),
        method=lambda m, lat: m.quantizer.from_latents(lat)))
    assert codes.shape == (2, stages, 10)
    np.testing.assert_array_equal(codes.numpy(), theirs[2])
    np.testing.assert_array_equal(codes.numpy(),
                                  port(x)["codes"][:, :stages].numpy())
    np.testing.assert_allclose(z_q.numpy().transpose(0, 2, 1), theirs[0],
                               atol=1e-4)
    np.testing.assert_allclose(z_p.numpy().transpose(0, 2, 1), theirs[1],
                               atol=1e-6)


@pytest.mark.parametrize("name", ["l1_loss", "multi_scale_stft_loss",
                                  "mel_spectrogram_loss", "sisdr_loss"])
def test_losses_and_gradients(name, rng):
    x = (0.3 * rng.standard_normal((2, 4000))).astype(np.float32)
    y = np.concatenate([x, np.zeros((2, 10), np.float32)], 1)
    y = (y + 0.1 * rng.standard_normal(y.shape)).astype(np.float32)
    want, want_grad = jax.value_and_grad(
        lambda b: getattr(jax_losses, name)(jnp.asarray(x), b))(
        jnp.asarray(y))
    yt = torch.from_numpy(y).requires_grad_(True)
    got = getattr(losses, name)(torch.from_numpy(x), yt)
    got.backward()
    assert got.dim() == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=5e-4)
    a, b = yt.grad.numpy().ravel(), np.asarray(want_grad).ravel()
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.995


def _folder(tmp_path):
    for sub in ("train", "test"):
        os.makedirs(tmp_path / sub, exist_ok=True)
        for i in range(4):
            t = np.arange(8000) / SR
            save_wav(str(tmp_path / sub / f"c{i}.wav"), (0.3 * np.sin(
                2 * np.pi * (150 + 50 * i) * t)).astype(np.float32))


@pytest.mark.parametrize("adversarial", [False, True])
def test_trainer_validates_tags_and_resumes(tmp_path, adversarial):
    _folder(tmp_path)
    cfg = {"DAC": dict(CFG, sample_rate=SR, quantizer_dropout=0.5),
           "batch_size": 2, "val_batch_size": 4, "num_iters": 2,
           "valid_freq": 2, "save_iters": [2], "log_every": 1,
           "num_workers": 1, "data_path": str(tmp_path),
           "save_path": str(tmp_path / "out"), "seed": 0,
           "Discriminator": {"sample_rate": SR, "rates": [], "periods": [2],
                             "fft_sizes": [256],
                             "bands": [[0.0, 0.5], [0.5, 1.0]]}}
    tr = DACTrainer(cfg, adversarial=adversarial, device="cpu")
    model = tr.train(num_iters=2)
    out = tmp_path / "out"
    for tag in ("latest", "best", "0k"):
        assert (out / f"{tag}.ckpt").exists(), tag
    payload = load_checkpoint(str(out / "latest.ckpt"))
    assert payload["step"] == 2
    assert payload["optimizer_state_dict"]["count"] == 2
    assert isinstance(payload["rng_state"], str)
    assert np.isfinite(tr.best_perf)            # the SI-SDR fallback
    assert ("model_disc_state_dict" in payload) is adversarial
    for k, v in model.state_dict().items():
        assert bool(torch.isfinite(v).all()), k
    # the checkpoint's weights are the trained model's
    loaded = DAC(device="cpu", sample_rate=SR, **CFG)
    loaded.load_state_dict(from_jax_params(payload["model_state_dict"]))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k

    tr2 = DACTrainer({**cfg, "resume": True}, adversarial=adversarial,
                     device="cpu")
    tr2.train(num_iters=4)
    assert tr2.opt.count == 4
    assert json.loads(payload["rng_state"]) != tr2.rng.bit_generator.state
    assert load_checkpoint(str(out / "latest.ckpt"))["step"] == 4
    assert np.isfinite(tr2.best_perf)


@pytest.mark.parametrize("name", ["16khz_dns_9k.yml",
                                  "16khz_dns_9k_tiny.yml"])
def test_dac_configs_read_without_pyyaml(name):
    path = os.path.join(ROOT, "configs", "dac", name)
    with open(path) as f:
        assert read_yaml(path) == yaml.safe_load(f)


def test_cli_encodes_and_decodes_without_pyyaml(models, speech, tmp_path,
                                                monkeypatch, capsys):
    _, ref, port = models
    monkeypatch.setitem(sys.modules, "yaml", None)   # import yaml fails
    (tmp_path / "dac.yml").write_text("DAC:\n" + "".join(
        f"  {k}: {v}\n" for k, v in dict(CFG, sample_rate=SR).items()))
    model_dir = tmp_path / "weights"
    model_dir.mkdir()
    torch.save(port.state_dict(), model_dir / "model.pth")
    wav = tmp_path / "in.wav"
    save_wav(str(wav), speech)
    common = ["--model_path", str(model_dir), "--config",
              str(tmp_path / "dac.yml"), "--device", "cpu"]
    dac_cli.main(["encode", str(wav), "--output", str(tmp_path / "out"),
                  *common])
    dac_cli.main(["decode", str(tmp_path / "out.dac"), "--output",
                  str(tmp_path / "out.wav"), *common])
    said = capsys.readouterr().out
    assert "loaded" in said and "model.pth" in said and "kbps" in said
    f = JaxDACFile.load(str(tmp_path / "out.dac"))
    np.testing.assert_array_equal(f.codes, port.compress(
        load_wav(str(wav))).codes)
    y = load_wav(str(tmp_path / "out.wav"))
    assert y.shape == speech.shape and np.isfinite(y).all()


def test_chip_smoke_predicts_the_dac_calls(models, speech, monkeypatch):
    """chip_smoke.py phase 11's launch counts: one search per stage of the
    forward, and per stage of every unpadded 1 s window of compress."""
    import chip_smoke
    from esc_tpu_torch.baselines.dac import quantize
    from esc_tpu_torch.ops.kernels import codebook_argmin_plain

    _, _, port = models
    seen = []

    def argmin(z, cb):
        seen.append((z.shape[0], cb.shape[0], z.shape[1]))
        return codebook_argmin_plain(z, cb)

    monkeypatch.setattr(quantize, "codebook_argmin", argmin)
    cfg = dict(CFG, sample_rate=SR)
    port(np.zeros((3, 4000), np.float32))
    assert seen == chip_smoke.dac_forward_calls(cfg, 3, 4000)
    for n in (len(speech), SR // 2):
        seen.clear()
        f = port.compress(speech[:n], win_duration=chip_smoke.DAC_WIN)
        assert seen == chip_smoke.dac_compress_calls(cfg, n)
        assert len(seen) == 4 * (f.codes.shape[-1] // f.chunk_length)
