"""The port's serving layer against the JAX package, downsized: pipelined
serving, chunked long files, the bf16 serving mode and both compress CLIs
end to end.

Weights are made by the JAX model and carried into the port
(``from_jax_params``), or written by ``esc_tpu.checkpoint.save_checkpoint``
and read by the port's own ``.ckpt`` reader.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esc_tpu.checkpoint import save_checkpoint
from esc_tpu.metrics import MelSpectrogramDistance
from esc_tpu.models import ESC as JaxESC
from esc_tpu_torch.convert import from_jax_params
from esc_tpu_torch.io import load_wav, save_wav
from esc_tpu_torch.models import ESC
from esc_tpu_torch.serving import stream_map, stream_roundtrip
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401
from tests.test_torch_port_io import jax_native  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = dict(
    backbone="transformer", in_dim=2, in_freq=192,
    h_dims=[16, 16, 24, 24, 32, 64], max_streams=6,
    win_len=20, hop_len=5, sr=16000, patch_size=[3, 2],
    swin_heads=[2, 2, 4, 4, 4], swin_depth=2, window_size=4,
    mlp_ratio=2.0, overlap=2, group_size=3, codebook_size=128,
    codebook_dims=[8, 8, 8, 8, 8, 8], l2norm=True,
)
L = 15920  # ~1 s, tests/test_bf16_mode.py's length


@pytest.fixture(scope="module")
def pair():
    ref = JaxESC(**CONFIG)
    ref.init_params(seed=11, example_len=L)
    port = ESC(device="cpu", **CONFIG)
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                      ref.variables)))
    return ref, port


# ------------------------------------------ stream_map (tests/test_serving)
def test_stream_map_order_and_values():
    xs = [np.full((2, 3), i, np.float32) for i in range(7)]
    outs = list(stream_map(lambda x: torch.as_tensor(x) + 1, xs, depth=3))
    assert len(outs) == 7
    for i, o in enumerate(outs):
        assert isinstance(o, np.ndarray)
        np.testing.assert_array_equal(o, xs[i] + 1)


def test_stream_map_depth_one_is_serial_and_device_mode():
    calls, seen = [], []
    xs = [np.ones((2,), np.float32) * i for i in range(3)]

    def fn(x):
        calls.append(len(seen))
        return torch.as_tensor(x) * 2

    outs = []
    for o in stream_map(fn, xs, depth=1, to_host=False, device="cpu"):
        seen.append(o)
        outs.append(o)
    # depth 1: batch i + 1 is called only after batch i was yielded
    assert calls == [0, 1, 2]
    assert len(outs) == 3
    assert isinstance(outs[0], torch.Tensor)  # tensors, no download
    np.testing.assert_array_equal(outs[2].numpy(), xs[2] * 2)


def test_stream_map_keeps_depth_batches_in_flight():
    calls, seen = [], []

    def fn(x):
        calls.append(len(seen))
        return torch.as_tensor(x)

    for o in stream_map(fn, [np.zeros(1)] * 5, depth=3):
        seen.append(o)
    assert calls == [0, 0, 0, 1, 2]


def test_stream_map_tree_outputs():
    xs = [np.ones((2,), np.float32) * i for i in range(4)]
    outs = list(stream_map(lambda x: {"a": torch.as_tensor(x),
                                      "b": (torch.as_tensor(x) + 1,)},
                           xs, depth=2))
    assert outs[3]["a"][0] == 3.0 and outs[3]["b"][0][0] == 4.0
    assert isinstance(outs[3]["b"], tuple)


def test_stream_map_rejects_bad_depth():
    with pytest.raises(ValueError):
        list(stream_map(lambda x: x, [1], depth=0))


def test_stream_roundtrip_equals_the_serial_loop(pair, rng):
    _, port = pair
    batches = [(0.1 * rng.standard_normal((2, 7920))).astype(np.float32)
               for _ in range(3)]
    outs = list(stream_roundtrip(port, batches, num_streams=3, depth=2))
    for x, (codes, recon) in zip(batches, outs):
        c, _, r = port.roundtrip(x, num_streams=3)
        np.testing.assert_array_equal(codes, c.numpy())
        np.testing.assert_array_equal(recon, r.numpy())


# ------------------------------------------------------ chunked long files
CHUNK, MARGIN = 0.5, 0.25   # 24 and 12 code frames
LONG = 60 * 320 - 80        # 60 code frames, three chunks


@pytest.fixture(scope="module")
def chunked(pair):
    ref, port = pair
    x = (0.1 * np.random.default_rng(5).standard_normal((1, LONG))
         ).astype(np.float32)
    kw = dict(chunk_seconds=CHUNK, margin_seconds=MARGIN)
    rc, rfs = ref.encode_chunked(x, num_streams=6, **kw)
    oc, ofs = port.encode_chunked(x, num_streams=6, **kw)
    return x, kw, (np.asarray(rc), rfs), (oc, ofs)


def test_encode_chunked_codes_bit_exact(chunked):
    _, _, (rc, rfs), (oc, ofs) = chunked
    assert tuple(ofs) == tuple(rfs)
    assert oc.dtype == torch.int32 and tuple(oc.shape) == rc.shape
    assert rc.shape[-1] == 60
    np.testing.assert_array_equal(oc.numpy(), rc)


def test_encode_chunked_interior_codes_equal_full_file(pair, chunked):
    _, port = pair
    x, kw, _, (oc, ofs) = chunked
    full, fs = port.encode(x, num_streams=6)
    assert tuple(fs) == tuple(ofs)
    chunk, margin = port._chunking(kw["chunk_seconds"],
                                   kw["margin_seconds"])
    assert (chunk, margin) == (24, 12)
    # the first chunk sees the whole file's left edge and 12 frames of
    # right context: its frames away from its right seam are the file's
    np.testing.assert_array_equal(oc[..., :chunk - 4].numpy(),
                                  full[..., :chunk - 4].numpy())
    agree = float((oc == full).float().mean())
    assert agree > 0.95, f"chunked/full code agreement {agree:.3f}"


def test_decode_chunked_matches_jax(pair, chunked):
    ref, port = pair
    _, kw, (rc, rfs), _ = chunked
    want = np.asarray(ref.decode_chunked(rc, rfs, **kw))
    got = port.decode_chunked(rc, rfs, **kw).numpy()
    assert got.shape == want.shape == (1, (rfs[1] * 2 - 1) * 80)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_short_files_skip_chunking(pair, rng):
    _, port = pair
    x = (0.1 * rng.standard_normal((1, L))).astype(np.float32)
    c, fs = port.encode_chunked(x, num_streams=3, chunk_seconds=10.0)
    c2, fs2 = port.encode(x, num_streams=3)
    assert fs == fs2 and torch.equal(c, c2)
    torch.testing.assert_close(port.decode_chunked(c, fs, chunk_seconds=10),
                               port.decode(c, fs), atol=0, rtol=0)


# ------------------------------------ bf16 serving (tests/test_bf16_mode)
# port bf16 against JAX bf16 codes: measured 90.4 % on this config, seed
# and input (torch 2.13 on the CPU against XLA on the CPU), about as far
# apart as each is from its float32 codes: the two frameworks round bf16
# products and sums at other places. The bar is set below the measurement.
PORT_VS_JAX_BF16_MIN = 0.85


@pytest.fixture(scope="module")
def bf16_models(pair):
    ref, port = pair
    ref16 = JaxESC(**CONFIG, dtype=jnp.bfloat16)
    ref16.variables = ref.variables
    port16 = ESC(device="cpu", dtype=torch.bfloat16, **CONFIG)
    port16.load_state_dict(port.state_dict())
    return ref16, port16


def test_bf16_params_are_float32(bf16_models):
    _, port16 = bf16_models
    assert {p.dtype for p in port16.module.parameters()} == {torch.float32}
    assert port16.dtype == torch.bfloat16


def test_bf16_codes_mostly_agree(pair, bf16_models, rng):
    _, port = pair
    ref16, port16 = bf16_models
    x = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    c32, s32 = port.encode(x, num_streams=6)
    c16, s16 = port16.encode(x, num_streams=6)
    assert tuple(s32) == tuple(s16)
    agree = float((c32 == c16).float().mean())
    assert agree > 0.8, f"bf16/fp32 code agreement only {agree:.2%}"
    j16, _ = ref16.encode(x, num_streams=6)
    vs_jax = float((c16.numpy() == np.asarray(j16)).mean())
    assert vs_jax >= PORT_VS_JAX_BF16_MIN, (
        f"port bf16 / JAX bf16 code agreement {vs_jax:.2%}")


def test_bf16_quality_neutral(pair, bf16_models, rng):
    _, port = pair
    _, port16 = bf16_models
    x = (0.1 * rng.standard_normal((2, L))).astype(np.float32)
    _, _, r32 = port.roundtrip(x, num_streams=6)
    _, _, r16 = port16.roundtrip(x, num_streams=6)
    assert r16.dtype == torch.float32  # the ISTFT output stays float32
    assert bool(torch.isfinite(r16).all())
    mel = MelSpectrogramDistance()
    d32 = float(np.mean(mel(x, r32.numpy())))
    d16 = float(np.mean(mel(x, r16.numpy())))
    assert abs(d16 - d32) / d32 < 0.05, (
        f"bf16 MelDistance {d16:.4f} vs fp32 {d32:.4f}")


# ------------------------------------------- both compress CLIs end to end
@pytest.fixture(scope="module")
def model_dir(pair, tmp_path_factory):
    ref, _ = pair
    d = tmp_path_factory.mktemp("esc_model")
    lines = ["model_name: csvq+swinT", "model:"]
    for k, v in CONFIG.items():
        lines.append(f"  {k}: {str(v).lower() if isinstance(v, bool) else v}")
    (d / "config.yaml").write_text("\n".join(lines) + "\n")
    save_checkpoint(str(d), "model.ckpt", step=1,
                    model_state=ref.variables["params"])
    wav = d / "clip.wav"
    rng = np.random.default_rng(9)
    save_wav(str(wav), (0.1 * rng.standard_normal(LONG)).astype(np.float32))
    return d, wav


def _run_cli(module, args, tmp):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["ESC_TPU_PLATFORM"] = "cpu"
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


@pytest.mark.parametrize("extra", [[], ["--chunk_seconds", str(CHUNK)]],
                         ids=["whole", "chunked"])
def test_both_clis_agree_on_a_jax_checkpoint(jax_native, model_dir, tmp_path,
                                            extra):
    d, wav = model_dir
    common = ["--input", str(wav), "--model_path", str(d),
              "--num_streams", "6", *extra]
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    _run_cli("esc_tpu.cli.compress", [*common, "--save_path", str(jax_out)],
             tmp_path)
    said = _run_cli("esc_tpu_torch.cli.compress",
                    [*common, "--save_path", str(port_out), "--device",
                     "cpu"], tmp_path)
    assert "model.ckpt" in said
    stem = "9.0kbps_clip"
    np.testing.assert_array_equal(
        np.load(port_out / f"encoded_{stem}.npy"),
        np.load(jax_out / f"encoded_{stem}.npy"))
    assert (port_out / f"encoded_{stem}.escb").read_bytes() == \
        (jax_out / f"encoded_{stem}.escb").read_bytes()
    ours = load_wav(str(port_out / f"decoded_{stem}.wav"))
    theirs = load_wav(str(jax_out / f"decoded_{stem}.wav"))
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= 16 / 32768
