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
    blob = pack_codes(codes, K, (2, 300))
    assert blob == jax_pack_codes(codes, K, (2, 300), entropy=False)
    back, fs = unpack_codes(blob)
    np.testing.assert_array_equal(back, codes)
    assert fs == (2, 300)


def test_escb_v2_is_refused(rng):
    blob = bytearray(pack_codes(np.zeros((1, 1, 3, 4), np.int32), 1024,
                                (2, 2)))
    blob[4] = 2
    with pytest.raises(NotImplementedError):
        unpack_codes(bytes(blob))


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


# ---------------------------------------------------- (h) import hygiene
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "esc_tpu")


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
        if root == "yaml":  # only inside read_yaml
            assert path.name == "config.py", f"{path.name}:{node.lineno}"


def test_importing_the_cli_loads_no_jax():
    code = ("import sys, esc_tpu_torch.cli.compress, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r} or m == 'yaml'); print(bad); "
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
