"""The port's evaluation path against the JAX package's, downsized: the
eval-mode forward ``ESC.__call__``, ``print_codec``, ``eval_epoch`` over a
WAV folder of unequal lengths and both evaluation CLIs.

Weights are made by the JAX model and carried into the port
(``from_jax_params``). Bars: codes bit-exact; waveforms within 5e-4 (the
repo's waveform bar); spectra within 1e-4 and per-sample VQ losses within
rtol 1e-4 (float32 sums of two frameworks); the sweep's scores, which
``eval_epoch`` rounds to 4 decimals, within 2e-4 and rtol 1e-4, SI-SDR
within 1 % (see ``SISDR_RTOL``); utilisation exact.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from esc_tpu.checkpoint import save_checkpoint
from esc_tpu.metrics import (PESQ, SISDR, STOI, EntropyCounter,
                             MelSpectrogramDistance)
from esc_tpu.models import ESC as JaxESC
from esc_tpu.train.data import make_dataloader as jax_make_dataloader
from esc_tpu.train.evaluate import eval_epoch as jax_eval_epoch
from esc_tpu_torch import metrics as pm
from esc_tpu_torch.cli import test as port_test_cli
from esc_tpu_torch.convert import from_jax_params
from esc_tpu_torch.io import save_wav
from esc_tpu_torch.models import ESC
from esc_tpu_torch.train.data import make_dataloader
from esc_tpu_torch.train.evaluate import eval_epoch
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CONFIG = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[8, 8, 8, 8, 16, 16], max_streams=6, win_len=20, hop_len=5,
    sr=16000, patch_size=[3, 2], swin_heads=[2, 2, 2, 2, 2], swin_depth=1,
    window_size=4, mlp_ratio=2.0, overlap=2, group_size=3,
    codebook_size=64, codebook_dims=[4] * 6, l2norm=True)
# one Swin block a layer keeps the JAX package's compiles short; the shifted
# windows are held to it at depth 2 by tests/test_torch_port_model.py
CLIPS = (8000, 6400, 9600, 5120, 7040)
L = 9520  # the eval batches' padded length, so that the forward's compiles
          # serve the sweep too
SCORE_ATOL, SCORE_RTOL = 2e-4, 1e-4
# The zero padding of a short utterance gives residuals of almost nothing,
# whose normalised direction is float noise: the padding's codes may differ
# between the two frameworks (the utterances' own may not, see
# test_eval_epoch_matches_on_unequal_lengths), and the decoder's windows
# carry that a few frames into the utterance. The untrained model's output
# is nearly orthogonal to its input (SI-SDR near -40 dB), which magnifies
# it in SI-SDR alone; Mel distance, PESQ and STOI stay within SCORE_RTOL.
SISDR_RTOL = 1e-2


@pytest.fixture(scope="module")
def pair():
    ref = JaxESC(**CONFIG)
    ref.init_params(seed=5, example_len=4720)
    port = ESC(device="cpu", **CONFIG)
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      ref.variables)))
    return ref, port


@pytest.mark.parametrize("num_streams,freeze", [(1, False), (6, False),
                                                (6, True)])
def test_eval_forward_matches(pair, rng, num_streams, freeze):
    ref, port = pair
    x = (0.1 * rng.standard_normal((3, L))).astype(np.float32)
    want = jax.tree.map(np.asarray, ref(x, num_streams=num_streams,
                                        freeze_codebook=freeze))
    got = port(x, num_streams=num_streams, freeze_codebook=freeze)
    assert set(got) == set(want) == {"raw_audio", "recon_audio", "raw_feat",
                                     "recon_feat", "codes", "cm_loss",
                                     "cb_loss"}
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
    assert got["codes"].dtype == torch.int32
    np.testing.assert_array_equal(got["codes"].numpy(), want["codes"])
    np.testing.assert_array_equal(got["raw_audio"].numpy(), x)
    np.testing.assert_allclose(got["raw_feat"].numpy(), want["raw_feat"],
                               atol=1e-4)
    np.testing.assert_allclose(got["recon_feat"].numpy(), want["recon_feat"],
                               atol=1e-4)
    np.testing.assert_allclose(got["recon_audio"].numpy(),
                               want["recon_audio"], atol=5e-4)
    for k in ("cm_loss", "cb_loss"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-7)
    # at inference the codebook loss is the commitment loss
    assert torch.equal(got["cm_loss"], got["cb_loss"])
    if not freeze:  # the serving path's codes
        codes, _ = port.encode(x, num_streams=num_streams)
        assert torch.equal(codes, got["codes"])


def test_print_codec_matches(pair, capsys):
    ref, port = pair
    ref.print_codec()
    theirs = capsys.readouterr().out
    port.print_codec()
    assert capsys.readouterr().out == theirs


@pytest.fixture(scope="module")
def eval_folder(tmp_path_factory):
    """Five clips of unequal length (the last batch of two is short)."""
    d = tmp_path_factory.mktemp("eval_wavs")
    rng = np.random.default_rng(17)
    for i, n in enumerate(CLIPS):
        t = np.arange(n) / 16000.0
        x = sum(np.sin(2 * np.pi * (120 + 30 * i) * k * t) / k
                for k in range(1, 6))
        x = 0.15 * x * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) \
            + 0.01 * rng.standard_normal(n)
        save_wav(str(d / f"clip_{i}.wav"), x.astype(np.float32))
    return str(d)


def _metric_funcs(pkg):
    return {"PESQ": pkg.PESQ(), "MelDistance": pkg.MelSpectrogramDistance(),
            "SISDR": pkg.SISDR(), "STOI": pkg.STOI()}


def _assert_perf_close(ours, theirs):
    assert list(ours) == list(theirs)
    assert ours["utilization"] == theirs["utilization"]
    for k, v in theirs.items():
        np.testing.assert_allclose(
            ours[k], v, atol=SCORE_ATOL,
            rtol=SISDR_RTOL if k == "SISDR" else SCORE_RTOL, err_msg=k)


def test_eval_epoch_matches_on_unequal_lengths(pair, eval_folder):
    ref, port = pair
    jax_dl = jax_make_dataloader(eval_folder, 3, False, pad_eval=True,
                                 pad_fn=ref.pad_length)
    dl = make_dataloader(eval_folder, 3, False, pad_eval=True,
                         pad_fn=port.pad_length)
    assert dl.pad_to_length == jax_dl.pad_to_length == L
    jax_metrics = {"PESQ": PESQ(), "MelDistance": MelSpectrogramDistance(),
                   "SISDR": SISDR(), "STOI": STOI()}
    theirs = jax_eval_epoch(ref, jax_dl, jax_metrics,
                            EntropyCounter(64, 6, 3), verbose=False)
    ours = eval_epoch(port, dl, _metric_funcs(pm), pm.EntropyCounter(64, 6, 3),
                      verbose=False)
    assert list(ours) == ["PESQ", "MelDistance", "SISDR", "STOI",
                          "utilization"]
    assert all(len(v) == 6 for v in ours.values())
    _assert_perf_close(ours, theirs)
    # the codes of the utterances' own frames are bit-exact, padded or not
    x, lengths = next(iter(dl))
    assert lengths.min() < L      # a padded batch
    for ns in (1, 6):
        theirs = np.asarray(ref(x, num_streams=ns)["codes"])
        ours = port(x, num_streams=ns)["codes"].numpy()
        assert ours.shape == theirs.shape == (3, ns, 3, 30)
        own = np.arange(30)[None, :] < -(-lengths // 320)[:, None]
        own = np.broadcast_to(own[:, None, None, :], ours.shape)
        np.testing.assert_array_equal(ours[own], theirs[own])


@pytest.fixture(scope="module")
def model_dir(pair, tmp_path_factory):
    ref, _ = pair
    d = tmp_path_factory.mktemp("esc_eval_model")
    lines = ["model_name: csvq+swinT", "model:"]
    for k, v in CONFIG.items():
        lines.append(f"  {k}: {str(v).lower() if isinstance(v, bool) else v}")
    (d / "config.yaml").write_text("\n".join(lines) + "\n")
    save_checkpoint(str(d), "model.ckpt", step=1,
                    model_state=ref.variables["params"])
    return d


def test_both_test_clis_write_the_same_perf_stats(model_dir, eval_folder,
                                                  tmp_path):
    args = ["--eval_folder_path", eval_folder, "--batch_size", "2",
            "--model_path", str(model_dir), "--num_streams", "4"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ESC_TPU_PLATFORM"] = "cpu"
    out = {}
    for name, module, extra in (("jax", "esc_tpu.cli.test", []),
                                ("port", "esc_tpu_torch.cli.test",
                                 ["--device", "cpu"])):
        save = tmp_path / name
        save.mkdir()
        proc = subprocess.run(
            [sys.executable, "-m", module, *args, "--save_path", str(save),
             *extra], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        out[name] = json.loads((save / "perf_stats.json").read_text())
    assert list(out["port"]) == ["PESQ", "MelDistance", "SISDR", "STOI",
                                 "utilization"]
    assert all(len(v) == 1 and np.isfinite(v[0])
               for v in out["port"].values())
    _assert_perf_close(out["port"], out["jax"])


def test_test_cli_defaults_to_the_card_and_refuses_data_parallel(
        monkeypatch, model_dir, eval_folder):
    args = port_test_cli.parse_args(["--eval_folder_path", eval_folder,
                                     "--model_path", str(model_dir)])
    assert args.device == "cuda" and args.batch_size == 1
    assert args.dtype == "float32" and args.num_streams is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_test_cli.run(args)
    with pytest.raises(NotImplementedError, match="data_parallel"):
        port_test_cli.run(port_test_cli.parse_args(
            ["--eval_folder_path", eval_folder, "--model_path",
             str(model_dir), "--data_parallel", "--device", "cpu"]))
