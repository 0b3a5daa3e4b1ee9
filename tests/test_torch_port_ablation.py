"""The ablation codecs (rvq+swinT, csvq+conv, rvq+conv) of the port against
the JAX package's, at a tiny geometry (``tests/test_ablation_models.py``'s
widths): codes, waveforms and the eval forward's losses, whole-file and
chunked; ``.escb`` bytes; ``.ckpt`` files across the packages, BatchNorm
statistics included; ``_normalize_config`` on every config; one training
step of rvq+swinT; the conv backbone's training refusal; k-means.

Weights are drawn from a numpy seed into the JAX model's own variable tree
(``jax.eval_shape`` of its init; BatchNorm statistics and PReLU slopes
drawn too) and carried into the port by ``from_jax_params``. Tolerances:
codes bit-exact at ``num_streams`` 1, 3 and 6; decoded waveforms from the
same codes within atol 5e-4; the eval forward's losses within rtol 5e-4;
the training step at ``tests/test_torch_parity_trainstep.py``'s bars
(losses rtol 5e-4, each gradient leaf's cosine above 0.995); ``.escb``
bytes and configs equal; k-means centroids from the same first indices
within 1e-5.

The JAX programs are compiled once per codec and shape, so the whole-file
length is one chunk with its margin, and the chunked file is two such
chunks: every chunk reuses the whole file's compiled encode and decode.
"""

import argparse
import glob
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu import checkpoint as jax_checkpoint
from esc_tpu.cli.bitstream import pack_codes as jax_pack_codes
from esc_tpu.convert import flax_to_torch
from esc_tpu.models import make_model as jax_make_model
from esc_tpu.models.codecs import _normalize_config as jax_normalize
from esc_tpu.modules.losses import mel_spectrogram_loss as jax_mel_loss
from esc_tpu.modules.vq_init import kmeans as jax_kmeans
from esc_tpu_torch.checkpoint import save_checkpoint
from esc_tpu_torch.cli import compress as port_compress
from esc_tpu_torch.cli import test as port_test_cli
from esc_tpu_torch.cli import train as port_train_cli
from esc_tpu_torch.cli.bitstream import pack_codes, unpack_codes
from esc_tpu_torch.convert import from_jax_params, to_jax_variables
from esc_tpu_torch.io import save_wav
from esc_tpu_torch.models import RVQCodecs, make_model, model_dict
from esc_tpu_torch.models.codecs import _normalize_config
from esc_tpu_torch.modules.losses import mel_spectrogram_loss
from esc_tpu_torch.modules.vq_init import kmeans, kmeans_init_codebooks
from esc_tpu_torch.train.trainer import Trainer
from esc_tpu_torch.utils.config import read_yaml, write_yaml
from tests.test_torch_port_conv import draw_variables
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401
from tests.test_torch_port_io import jax_native  # noqa: F401  (fixture)

TINY = dict(
    in_dim=2, in_freq=192, h_dims=[8, 8, 8, 12, 12, 16], max_streams=6,
    win_len=20, hop_len=5, sr=16000, patch_size=[3, 2], overlap=2,
    group_size=3, codebook_size=32, l2norm=True)
SWIN = dict(backbone="transformer", swin_heads=[2, 2, 2, 2, 2],
            swin_depth=1, window_size=4, mlp_ratio=1.0)
CONV = dict(backbone="convolution", kernel_size=[5, 2], conv_depth=1)
CONFIGS = {
    "rvq+swinT": dict(TINY, **SWIN, codebook_dim=8, num_rvqs=6),
    "csvq+conv": dict(TINY, **CONV, codebook_dims=[8] * 6),
    "rvq+conv": dict(TINY, **CONV, codebook_dim=8, num_rvqs=6),
}
SPC = 320                       # samples per code frame
L = 14 * SPC                    # a chunk of 12 codes and a margin of 2
L_LONG = 24 * SPC               # two chunks, each encoded as L samples
CHUNK = dict(chunk_seconds=12 * SPC / 16000, margin_seconds=2 * SPC / 16000)
L_TRAIN = 4720                  # an even number of STFT frames, as loaded
W = {"cm": 0.25, "cb": 1.0, "mel": 0.25}


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(name, JAX codec, port codec) with the same drawn weights."""
    name = request.param
    ref = jax_make_model(CONFIGS[name], name)
    shapes = jax.eval_shape(
        lambda r, x: ref.module.init(r, x, None, 6, False, False),
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, L), jnp.float32))
    ref.variables = draw_variables(shapes, np.random.default_rng(17))
    port = make_model(CONFIGS[name], name, device="cpu")
    port.load_state_dict(from_jax_params(ref.variables))
    return name, ref, port


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(23)
    t = np.arange(L_LONG) / 16000.0
    x = np.stack([0.3 * np.sin(2 * np.pi * f * t) for f in (150.0, 230.0)])
    return (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)


@pytest.mark.parametrize("num_streams", [1, 3, 6])
def test_codes_match_whole_and_chunked(pair, audio, num_streams):
    name, ref, port = pair
    x = audio[:, :L]
    theirs, fs = ref.encode(x, num_streams)
    ours, ours_fs = port.encode(x, num_streams)
    assert ours_fs == fs
    assert theirs.shape == (2, num_streams, 3, 14)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    theirs, fs = ref.encode_chunked(audio, num_streams, **CHUNK)
    ours, ours_fs = port.encode_chunked(audio, num_streams, **CHUNK)
    assert ours_fs == fs and theirs.shape[-1] == 24
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_waveforms_match_whole_and_chunked(pair, audio):
    """The same codes (9 kbps) decoded by both packages, whole-file and in
    chunks joined by their crossfade."""
    name, ref, port = pair
    codes, fs = ref.encode(audio[:, :L], 6)
    codes = np.asarray(codes)
    np.testing.assert_allclose(port.decode(codes, fs).numpy(),
                               np.asarray(ref.decode(codes, fs)),
                               rtol=0, atol=5e-4)
    codes, fs = ref.encode_chunked(audio, 6, **CHUNK)
    codes = np.asarray(codes)
    np.testing.assert_allclose(
        port.decode_chunked(codes, fs, **CHUNK).numpy(),
        np.asarray(ref.decode_chunked(codes, fs, **CHUNK)), rtol=0,
        atol=5e-4)


def test_eval_forward_matches(pair, audio):
    """The eval forward at 4.5 kbps; an RVQ codec's holds every residual
    stage whatever ``num_streams`` is, in both packages."""
    name, ref, port = pair
    x = audio[:, :L]
    theirs = ref(x, None, 3)
    ours = port(x, 3)
    np.testing.assert_array_equal(ours["codes"].numpy(),
                                  np.asarray(theirs["codes"]))
    assert ours["codes"].shape[1] == (6 if name.startswith("rvq") else 3)
    for k in ("cm_loss", "cb_loss"):
        assert ours[k].shape == (2,)
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=5e-4)
    np.testing.assert_allclose(ours["recon_audio"].numpy(),
                               np.asarray(theirs["recon_audio"]), rtol=0,
                               atol=5e-4)


@pytest.mark.parametrize("entropy", [False, True], ids=["v1", "v2"])
def test_escb_bytes_match(jax_native, pair, audio, entropy):
    """Streams are axis 1 of the codes in both packages: the residual
    stages of an RVQ codec, the scales of a csvq one. Random weights use
    their codebooks evenly, so version 2 is given skewed codes (modulo 4),
    which its range coder shrinks."""
    name, ref, port = pair
    codes, fs = port.encode(audio[:, :L], 6)
    codes = codes.numpy() % (4 if entropy else 32)
    blob = pack_codes(codes, 32, fs, entropy=entropy)
    assert blob == jax_pack_codes(codes, 32, fs, entropy=entropy)
    assert blob[4] == (2 if entropy else 1)
    back, back_fs = unpack_codes(blob)
    np.testing.assert_array_equal(back, codes)
    assert back_fs == fs


def test_checkpoints_serve_in_both_packages(pair, audio, tmp_path):
    """A ``.ckpt`` that the JAX package writes (flax variables, with
    ``batch_stats`` for a conv codec) serves in the port's compress CLI
    (in process), whose ``.npy`` and ``.escb`` hold the codes; one that the
    port writes restores in the JAX package; the codes are the same."""
    name, ref, port = pair
    x = audio[:, :L]
    codes = np.asarray(ref.encode(x, 6)[0])
    jax_checkpoint.save_checkpoint(str(tmp_path), "model.ckpt", step=1,
                                   model_state=ref.variables)
    write_yaml(str(tmp_path / "config.yaml"),
               {"model_name": name, "model": CONFIGS[name]})
    served = port_compress.load_model(str(tmp_path), device="cpu")
    np.testing.assert_array_equal(served.encode(x, 6)[0].numpy(), codes)
    wav = tmp_path / "clip.wav"
    save_wav(str(wav), audio[0, :L])
    port_compress.main(port_compress.parse_args(
        ["--input", str(wav), "--model_path", str(tmp_path), "--save_path",
         str(tmp_path / "out"), "--num_streams", "3", "--device", "cpu"]))
    npy = np.load(tmp_path / "out" / "encoded_4.5kbps_clip.npy")
    blob = (tmp_path / "out" / "encoded_4.5kbps_clip.escb").read_bytes()
    np.testing.assert_array_equal(unpack_codes(blob)[0], npy)
    np.testing.assert_array_equal(
        npy, served.encode(port_compress.load_wav(str(wav))[None],
                           3)[0].numpy())

    save_checkpoint(str(tmp_path), "port.ckpt", step=1,
                    model_state=to_jax_variables(port.module))
    payload = jax_checkpoint.load_checkpoint(str(tmp_path / "port.ckpt"))
    variables = flax.serialization.from_state_dict(
        ref.variables, payload["model_state_dict"])
    assert set(variables) == set(ref.variables)
    other = jax_make_model(CONFIGS[name], name)
    other.variables = variables
    np.testing.assert_array_equal(np.asarray(other.encode(x, 6)[0]), codes)


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs",
                           "**", "*.yaml"), recursive=True)),
    ids=lambda p: os.path.relpath(p, os.path.join(os.path.dirname(
        __file__), "..", "configs")))
def test_normalize_config_matches_jax_on_every_config(path):
    cfg = read_yaml(path)
    name = cfg.get("model_name", "csvq+swinT")
    ours = _normalize_config(dict(cfg["model"]), name)
    assert ours == jax_normalize(dict(cfg["model"]), name)
    if name in model_dict:
        assert ("codebook_dims" in ours) == name.startswith("csvq")
        assert "num_rvqs" not in ours or name.startswith("rvq")


def test_make_model_builds_every_name_of_every_config():
    """The four model names of the configs build at full width (their
    structure against the JAX package's is the strict load of the tiny
    codecs above); an unknown name raises."""
    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    built = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*.yaml"),
                                 recursive=True)):
        cfg = read_yaml(path)
        name = cfg.get("model_name", "csvq+swinT")
        if name in model_dict and name not in built:
            built[name] = make_model(cfg["model"], name, device="cpu")
    assert set(built) == set(model_dict)
    assert isinstance(built["rvq+conv"], RVQCodecs)
    assert built["rvq+conv"].module.backbone == "convolution"
    assert 8e6 < built["rvq+swinT"].num_params() < 1e7
    with pytest.raises(ValueError, match="not valid"):
        make_model(CONFIGS["rvq+conv"], "rvq+mlp", device="cpu")


def test_rvq_swint_training_step_matches():
    """One training step of rvq+swinT at 4.5 kbps: per-sample losses and
    every gradient leaf against the JAX step's (the complex-STFT term left
    out of the gradient, as in ``tests/test_torch_port_train.py``)."""
    name, num_streams = "rvq+swinT", 3
    ref = jax_make_model(CONFIGS[name], name)
    shapes = jax.eval_shape(
        lambda r, x: ref.module.init(r, x, None, 6, False, False),
        jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, L_TRAIN), jnp.float32))
    params = draw_variables(shapes, np.random.default_rng(29))["params"]
    port = make_model(CONFIGS[name], name, device="cpu")
    port.load_state_dict(from_jax_params(params))
    x = (0.1 * np.random.default_rng(31).standard_normal((2, L_TRAIN))
         ).astype(np.float32)

    def loss_fn(p):
        out = ref.module.apply({"params": p}, jnp.asarray(x), None,
                               num_streams, False, True)
        mel = jax_mel_loss(out["raw_audio"], out["recon_audio"])
        total = (out["cm_loss"] * W["cm"] + out["cb_loss"] * W["cb"]
                 + mel * W["mel"]).mean()
        return total, (out["cm_loss"], out["cb_loss"], mel)

    (_, theirs), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    module = port.module.train()
    out = module(torch.from_numpy(x), num_streams)
    mel = mel_spectrogram_loss(out["raw_audio"], out["recon_audio"])
    (out["cm_loss"] * W["cm"] + out["cb_loss"] * W["cb"]
     + mel * W["mel"]).mean().backward()
    module.eval()
    assert out["codes"].shape == (2, 6, 3, 15)      # every stage in training
    for a, b in zip((out["cm_loss"], out["cb_loss"], mel), theirs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=5e-4, atol=1e-6)
    jgrads = flax_to_torch({"params": jgrads})
    grads = {n: p.grad.numpy() for n, p in module.named_parameters()}
    assert set(grads) == set(jgrads)
    checked = 0
    for k, jg in jgrads.items():
        g = grads[k]
        gn, jn = np.linalg.norm(g), np.linalg.norm(jg)
        if gn > 1e-8 and jn > 1e-8:
            cos = float(np.dot(g.ravel(), jg.ravel()) / (gn * jn))
            assert cos > 0.995, (k, cos)
            checked += 1
        else:        # off the loss's path (a masked stage): zero on both
            assert gn <= 1e-8 and jn <= 1e-8, (k, gn, jn)
    assert checked > 40


@pytest.mark.parametrize("name", ["csvq+conv", "rvq+conv"])
def test_conv_training_is_refused_in_both_packages(name, tmp_path):
    """The JAX trainer applies the ``params`` collection alone, which the
    conv backbone's BatchNorm cannot train on; the port refuses with an
    error that names the cause, in the module and in the trainer before
    any data is read."""
    ref = jax_make_model(CONFIGS[name], name)
    shapes = jax.eval_shape(
        lambda r, x: ref.module.init(r, x, None, 6, False, False),
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, L), jnp.float32))
    params = draw_variables(shapes, np.random.default_rng(3))["params"]
    with pytest.raises(flax.errors.ScopeCollectionNotFound,
                       match="batch_stats"):
        ref.module.apply({"params": params}, jnp.zeros((1, L)), None, 6,
                         False, True)
    port = make_model(CONFIGS[name], name, device="cpu")
    port.module.train()
    with pytest.raises(NotImplementedError, match="BatchNorm"):
        port.module(torch.zeros(1, L), 6)
    config = {"model_name": name, "model": CONFIGS[name],
              "loss": {k: 1.0 for k in ("stft_weight", "cm_weight",
                                        "cb_weight", "mel_weight")},
              "data": {"train_data_path": str(tmp_path / "absent")}}
    args = argparse.Namespace(seed=1, device="cpu", exp_name="x",
                              save_path=str(tmp_path))
    with pytest.raises(NotImplementedError, match="esc_tpu"):
        Trainer(config, args).load()
    assert not any(tmp_path.iterdir())


@pytest.fixture(scope="module")
def wav_folder(tmp_path_factory):
    """Two clips of 0.5 s, harmonics and noise."""
    d = tmp_path_factory.mktemp("ablation_wavs")
    rng = np.random.default_rng(37)
    t = np.arange(8000) / 16000.0
    for i in range(2):
        x = 0.3 * np.sin(2 * np.pi * (120 + 50 * i) * t) \
            + 0.05 * rng.standard_normal(t.shape)
        save_wav(str(d / f"clip_{i}.wav"), x.astype(np.float32))
    return str(d)


def test_train_and_test_clis_run_rvq_swint(wav_folder, tmp_path):
    """``python -m esc_tpu_torch.cli.train`` on rvq+swinT across the freeze
    switch (in process, on the CPU), then ``python -m
    esc_tpu_torch.cli.test`` on what it wrote, at 9 kbps: finite scores.
    An RVQ codec's eval forward holds every residual stage whatever the
    bitrate, in both packages, so the sweep over bitrates refuses its codes
    at 1.5 kbps, as ``esc_tpu``'s ``EntropyCounter`` asserts."""
    config = {"data": {"train_data_path": wav_folder,
                       "val_data_path": wav_folder, "num_workers": 0,
                       "train_bs_per_device": 2, "val_bs_per_device": 2},
              "model_name": "rvq+swinT", "model": CONFIGS["rvq+swinT"],
              "loss": {"stft_weight": 1.0, "cm_weight": 0.25,
                       "cb_weight": 1.0, "mel_weight": 0.25}}
    write_yaml(str(tmp_path / "cfg.yaml"), config)
    model = port_train_cli.main([
        "--config_path", str(tmp_path / "cfg.yaml"), "--exp_name", "rvq",
        "--num_epochs", "2", "--num_pretraining_epochs", "1",
        "--log_steps", "2", "--save_path", str(tmp_path), "--seed", "5",
        "--val_metric", "SISDR", "--device", "cpu"])
    assert isinstance(model, RVQCodecs)
    run = tmp_path / "rvq"
    assert {"config.yaml", "pretrained.ckpt", "checkpoint.ckpt"} <= set(
        os.listdir(run))
    flags = ["--eval_folder_path", wav_folder, "--model_path", str(run),
             "--batch_size", "2", "--device", "cpu"]
    perf = port_test_cli.run(port_test_cli.parse_args(
        flags + ["--num_streams", "6"]))
    assert len(perf["SISDR"]) == 1
    assert np.isfinite(perf["MelDistance"][0] + perf["SISDR"][0])
    assert os.path.exists(run / "perf_stats.json")
    with pytest.raises(ValueError, match="1 streams"):
        port_test_cli.run(port_test_cli.parse_args(flags))


@pytest.mark.parametrize("n", [200, 12], ids=["sampled", "with_repeats"])
def test_kmeans_matches_jax_from_the_same_start(n):
    """The same first centroids (the indices ``jax.random.choice`` draws in
    the JAX package's k-means) give the same centroids after 6 rounds."""
    rng = np.random.default_rng(41)
    points = np.concatenate([rng.standard_normal((n // 2, 8)) + 3.0,
                             rng.standard_normal((n - n // 2, 8)) - 1.0]
                            ).astype(np.float32)
    k, seed = 16, 7
    idx = jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                            replace=n < k)
    theirs = np.asarray(jax_kmeans(jnp.asarray(points), jnp.int32(seed), k,
                                   6))
    ours = kmeans(torch.from_numpy(points), k, 6,
                  init_indices=np.asarray(idx))
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-5)


def test_kmeans_init_codebooks_refits_every_codebook(audio):
    cfg = dict(TINY, **SWIN, codebook_dims=[8] * 6)
    model = make_model(cfg, "csvq+swinT", device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "embedding" in k}
    kmeans_init_codebooks(model, audio[:1, :L], iters=2, seed=2)
    after = model.state_dict()
    assert len(before) == 18
    for k, v in before.items():
        assert not torch.equal(after[k], v), k
        assert torch.isfinite(after[k]).all(), k
    codes, fs = model.encode(audio[:1, :L], 6)
    assert codes.shape == (1, 6, 3, 14) and int(codes.max()) < 32


@pytest.mark.parametrize("name", ["csvq+conv", "rvq+conv"])
def test_bf16_serving_of_the_conv_codecs(audio, name):
    """The bf16 serving mode runs the conv backbone's convolutions in bf16
    (the JAX package's ``Convolution2D(dtype=bf16)``), parameters fp32:
    codes agree with fp32's at ``tests/test_bf16_mode.py``'s bar of 80 %."""
    x = audio[:1, :L]
    m32 = make_model(CONFIGS[name], name, seed=4, device="cpu")
    m16 = make_model(CONFIGS[name], name, seed=4, device="cpu",
                     dtype="bfloat16")
    assert {p.dtype for p in m16.module.parameters()} == {torch.float32}
    c16, fs, r16 = m16.roundtrip(x, 6)
    c32, _ = m32.encode(x, 6)
    assert r16.dtype == torch.float32 and bool(torch.isfinite(r16).all())
    assert float((c16 == c32).float().mean()) >= 0.8
    assert not torch.equal(r16, m32.decode(c16, fs))   # bf16 did compute
