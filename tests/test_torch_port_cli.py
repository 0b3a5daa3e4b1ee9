"""The port's bitstream, compress CLI, import hygiene and device policy."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from esc_tpu.cli.bitstream import pack_codes as jax_pack_codes
from esc_tpu_torch.cli.bitstream import pack_codes, unpack_codes
from esc_tpu_torch.cli.compress import compress_file, load_model, parse_args
from esc_tpu_torch.io import load_wav, save_wav
from esc_tpu_torch.models import ESC

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(in_dim=2, in_freq=192, h_dims=[8, 8, 8, 8, 16, 16],
            max_streams=6, patch_size=[3, 2], swin_heads=[2, 2, 2, 2, 2],
            swin_depth=1, window_size=4, mlp_ratio=2.0, overlap=2,
            group_size=3, codebook_size=64, codebook_dims=[4] * 6,
            l2norm=True)


# ----------------------------------------------------------- (g) .escb v1
@pytest.mark.parametrize("shape,K", [((2, 6, 3, 150), 1024),
                                     ((1, 1, 3, 7), 128), ((1, 3, 2, 5), 3)])
def test_escb_v1_bytes_match_jax_package(rng, shape, K):
    codes = rng.integers(0, K, size=shape).astype(np.int32)
    blob = pack_codes(codes, K, (2, 300), entropy=False)
    assert blob == jax_pack_codes(codes, K, (2, 300), entropy=False)
    back, fs = unpack_codes(blob)
    np.testing.assert_array_equal(back, codes)
    assert fs == (2, 300)


def test_escb_v2_is_refused(rng, monkeypatch):
    # version 2 is read with the range coder; where the coder cannot be
    # built, reading it raises, and an unknown version always does
    codes = np.zeros((1, 1, 3, 400), np.int32)
    blob = pack_codes(codes, 1024, (2, 2))
    assert blob[4] == 2
    np.testing.assert_array_equal(unpack_codes(blob)[0], codes)
    bad = bytearray(blob)
    bad[4] = 3
    with pytest.raises(ValueError):
        unpack_codes(bytes(bad))
    from esc_tpu_torch import rangecoder

    def unavailable():
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(rangecoder, "library", unavailable)
    with pytest.raises(RuntimeError):
        unpack_codes(blob)


# ------------------------------------------------------------ compress CLI
def test_compress_file_writes_consistent_outputs(rng, tmp_path):
    wav = tmp_path / "clip.wav"
    save_wav(str(wav), 0.1 * rng.standard_normal(7920).astype(np.float32))
    model = ESC(seed=1, device="cpu", **TINY)
    out = compress_file(model, str(wav), str(tmp_path / "out"),
                        num_streams=3)
    codes, fs = unpack_codes(Path(out["escb"]).read_bytes())
    np.testing.assert_array_equal(codes, np.load(out["npy"]))
    np.testing.assert_array_equal(codes, out["codes"])
    assert fs == out["feat_shape"] == model.feat_shape(7920)
    assert codes.shape == (1, 3, 3, 25)
    assert load_wav(out["wav"]).shape == (7920,)
    ref, _ = model.encode(load_wav(str(wav))[None], num_streams=3)
    np.testing.assert_array_equal(codes, ref.numpy())


def test_load_model_reads_config_and_state_dict(tmp_path):
    import yaml
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(
        {"model_name": "csvq+swinT", "model": TINY}))
    src = ESC(seed=5, device="cpu", **TINY)
    torch.save({"model_state_dict": src.state_dict()}, tmp_path / "model.pth")
    model = load_model(str(tmp_path), seed=0, device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    args = parse_args(["--input", "a.wav", "--model_path", str(tmp_path)])
    assert args.device == "cuda" and args.num_streams == 6
    assert args.dtype == "float32" and args.chunk_seconds is None


def test_load_model_takes_the_candidates_in_order(tmp_path):
    from esc_tpu_torch.cli.compress import CANDIDATES

    assert CANDIDATES == ("model.pth", "best.pth", "model.ckpt", "best.ckpt",
                          "checkpoint.ckpt", "pretrained.ckpt")
    (tmp_path / "config.yaml").write_text("model:\n" + "".join(
        f"  {k}: {'true' if v is True else v}\n" for k, v in TINY.items()))
    weights = {seed: ESC(seed=seed, device="cpu", **TINY).state_dict()
               for seed in (1, 2)}
    torch.save(weights[1], tmp_path / "best.pth")
    torch.save(weights[2], tmp_path / "model.pth")
    model = load_model(str(tmp_path), device="cpu", dtype="bfloat16")
    assert model.dtype == torch.bfloat16
    for k, v in weights[2].items():
        assert torch.equal(model.state_dict()[k], v), k

# ---------------------------------------------------- (h) import hygiene
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "yaml",
              "esc_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [p for p in (ROOT / "esc_tpu_torch").rglob("*.py")
     if "_build" not in p.relative_to(ROOT).parts]
    + [ROOT / "chip_smoke.py"]), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax(path):
    for node, root in _imported_roots(path):
        assert root not in _FORBIDDEN, f"{path.name}:{node.lineno} {root}"


def test_importing_the_cli_loads_no_jax():
    code = ("import sys, esc_tpu_torch.cli.compress, chip_smoke, "
            "esc_tpu_torch.serving, esc_tpu_torch.checkpoint, "
            "esc_tpu_torch.rangecoder, esc_tpu_torch.cli.test, "
            "esc_tpu_torch.cli.train, esc_tpu_torch.metrics, "
            "esc_tpu_torch.train.trainer, esc_tpu_torch.train.trainer_adv, "
            "esc_tpu_torch.parallel, esc_tpu_torch.models.discriminator, "
            "esc_tpu_torch.baselines.dac.trainer, "
            "esc_tpu_torch.baselines.dac.__main__, "
            "esc_tpu_torch.utils.profiling; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r}); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------ (i) device policy
def test_entry_points_without_device_raise_on_a_cpu_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ESC(**TINY)
    from esc_tpu_torch.models import make_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model(TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ESC(device="cuda", **TINY)
    assert ESC(device="cpu", **TINY).device == torch.device("cpu")


# ------------------------------------- chip_smoke's accounting, on the CPU
@pytest.mark.parametrize("num_streams", [1, 2, 6])
def test_chip_smoke_predicts_the_main_path_calls(monkeypatch, rng,
                                                 num_streams):
    import chip_smoke
    from esc_tpu_torch.modules import transformer, vq
    from esc_tpu_torch.ops.kernels import (codebook_argmin_plain,
                                           window_attention_plain)

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
    cfg = dict(TINY, swin_depth=2, win_len=20, hop_len=5, sr=16000)
    model = ESC(seed=0, device="cpu", **cfg)
    model.roundtrip(0.1 * rng.standard_normal((2, 7920)).astype(np.float32),
                    num_streams=num_streams)
    argmin_calls, attn_calls = chip_smoke.main_path_calls(cfg, 2, 7920,
                                                          num_streams)
    assert seen["argmin"] == argmin_calls
    assert seen["attn"] == attn_calls


@pytest.mark.parametrize("num_streams", [1, 4, 6])
def test_chip_smoke_predicts_the_eval_forward_calls(monkeypatch, rng,
                                                    num_streams):
    import chip_smoke
    from esc_tpu_torch.modules import transformer, vq
    from esc_tpu_torch.ops.kernels import (codebook_argmin_plain,
                                           window_attention_plain)

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
    cfg = dict(TINY, swin_depth=2, win_len=20, hop_len=5, sr=16000)
    model = ESC(seed=0, device="cpu", **cfg)
    out = model(0.1 * rng.standard_normal((3, 9520)).astype(np.float32),
                num_streams=num_streams)
    assert tuple(out["codes"].shape) == (3, num_streams, 3, 30)
    argmin_calls, attn_calls = chip_smoke.main_path_calls(
        cfg, 3, 9520, num_streams, forward=True)
    assert seen["argmin"] == argmin_calls
    assert seen["attn"] == attn_calls
