"""The port's readers and writers against the JAX package: YAML configs,
WAV files, ``.escb`` bitstreams (v1 and v2) and ``.ckpt`` checkpoints.

``jax_native`` (also used by the other port tests) builds the JAX
package's native libraries where they are missing, so that a comparison
with ``esc_tpu`` always meets its native path, whatever ran before it."""

import ctypes
import fcntl
import importlib.util
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from esc_tpu.cli.bitstream import pack_codes as jax_pack_codes
from esc_tpu.cli.bitstream import unpack_codes as jax_unpack_codes
from esc_tpu.train.data import load_wav as jax_load_wav
from esc_tpu_torch import rangecoder
from esc_tpu_torch.cli.bitstream import pack_codes, unpack_codes
from esc_tpu_torch.io import load_wav
from esc_tpu_torch.utils.config import dump_yaml, parse_yaml, read_yaml

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p for p in (ROOT / "configs").rglob("*")
                 if p.suffix in (".yaml", ".yml"))
NATIVE_DIR = ROOT / "esc_tpu" / "native"
# the libraries loaded by this process, kept open: a later load of the same
# path by the JAX package gets this copy, whatever is written there since
_NATIVE_HANDLES = []


def _native_build():
    spec = importlib.util.spec_from_file_location(
        "_esc_native_build", ROOT / "native" / "build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    return build


def ensure_jax_native():
    """Build ``esc_tpu/native/lib*.so`` where one is missing or does not
    load, from ``native/build.py``'s sources with its command, then assert
    that the JAX package takes its native paths (the WAV reader and the
    range coder of ``.escb`` v2).

    Each library is compiled to a name of its own and moved into place by
    ``os.replace``, under an exclusive lock on the directory, so that two
    test processes never load a half-written library."""
    build = _native_build()
    fd = os.open(NATIVE_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        for src, lib in build.TARGETS.items():
            out = NATIVE_DIR / lib
            try:
                _NATIVE_HANDLES.append(ctypes.CDLL(str(out)))
                continue
            except OSError:
                pass
            tmp = NATIVE_DIR / f".{lib}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                     "-fPIC", "-pthread", os.path.join(build.HERE, src),
                     "-o", str(tmp)], check=True, capture_output=True,
                    timeout=300)
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
            _NATIVE_HANDLES.append(ctypes.CDLL(str(out)))
    finally:
        os.close(fd)
    from esc_tpu.native import rangecoder, wavio  # noqa: F401  (must load)
    codes = _skewed(np.random.default_rng(0), 1024, (1, 6, 3, 600))
    assert jax_pack_codes(codes, 1024, (2, 1200))[4] == 2, \
        "esc_tpu wrote .escb v1: its range coder did not load"


@pytest.fixture(scope="module")
def jax_native():
    ensure_jax_native()


# -------------------------------------------------------------------- YAML
@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_read_yaml_equals_pyyaml_on_every_config(path):
    assert read_yaml(str(path)) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_dump_yaml_reads_back_in_both_readers(path):
    config = read_yaml(str(path))
    text = dump_yaml(config)
    assert parse_yaml(text) == config
    assert yaml.safe_load(text) == config


SNIPPETS = [
    "a: 1\nb: [1, 2.5, x, 'q', \"d\\n\"]\nc: {x: 1, y: [true, null]}\n",
    "# lead\nk:\n- - 0.0\n  - 0.1\n- - 1\n  - 2\n",
    "k:\n  - a: 1\n    b: 2\n  - c: ~\nz: 'it''s'  # comment\n",
    "x: 1e-4\ny: 1.0e-4\nz: .5\nw: -0.5\nv: 0x1F\nu: 017\nt: yes\n"
    "s: Off\nr: 1_000\nq: ''\np: 'a#b'\no: a#b\nn: -.inf\n",
    "seq:\n- 1\n-\n  - 2\nm: []\nn: {}\nempty:\nmel/loss: 15.0\n",
    "- 1\n- a: b\n  c: [d, e]\n- [x, [y, z]]\n",
    "key with spaces: value with spaces\n'quoted key': 3\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_parse_yaml_equals_pyyaml_on_the_subset(text):
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["a: &x 1\nb: *x\n", "a: |\n  text\n",
                                  "a: 1\n---\nb: 2\n", "a: !!str 1\n"])
def test_parse_yaml_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_read_yaml_needs_no_pyyaml():
    # PyYAML made unimportable: the port parses ESC-Base's config anyway
    code = ("import sys; sys.modules['yaml'] = None; "
            "from esc_tpu_torch.utils.config import read_yaml; "
            "c = read_yaml('configs/9kbps_esc_base.yaml'); "
            "assert c['model']['h_dims'] == [45, 72, 96, 144, 192, 384]; "
            "assert 'yaml' not in [m for m in sys.modules if sys.modules[m]]")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --------------------------------------------------------------------- WAV
def _wav_bytes(samples: bytes, fmt: int, bits: int, channels: int,
               extensible: bool = False, extra: bytes = b"") -> bytes:
    block = channels * bits // 8
    body = struct.pack("<HHIIHH", 0xFFFE if extensible else fmt, channels,
                       16000, 16000 * block, block, bits)
    if extensible:  # cbSize, valid bits, channel mask, sub-format GUID
        body += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", fmt) \
            + b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    chunks = b"fmt " + struct.pack("<I", len(body)) + body + extra
    chunks += b"data" + struct.pack("<I", len(samples)) + samples
    if len(samples) & 1:
        chunks += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _samples(rng, kind, n, channels):
    x = rng.uniform(-0.9, 0.9, (n, channels))
    if kind == "pcm8":
        return (np.round(x * 127) + 128).astype(np.uint8).tobytes()
    if kind == "pcm16":
        return np.round(x * 32767).astype("<i2").tobytes()
    if kind == "pcm24":
        v = np.round(x * 8388607).astype("<i4").reshape(-1)
        b = v.view(np.uint8).reshape(-1, 4)[:, :3]
        return b.tobytes()
    if kind == "pcm32":
        return np.round(x * 2147483000).astype("<i4").tobytes()
    return x.astype("<f4").tobytes()


FORMATS = {"pcm8": (1, 8), "pcm16": (1, 16), "pcm24": (1, 24),
           "pcm32": (1, 32), "float32": (3, 32)}
# an odd-sized chunk before the data: the next chunk starts one byte later
ODD_CHUNK = b"LIST" + struct.pack("<I", 5) + b"INFO!" + b"\x00"


@pytest.mark.parametrize("odd", [False, True], ids=["plain", "odd_chunk"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("extensible", [False, True],
                         ids=["wave", "extensible"])
@pytest.mark.parametrize("kind", list(FORMATS))
def test_load_wav_matches_jax_package(jax_native, tmp_path, rng, kind,
                                      extensible, channels, odd):
    fmt, bits = FORMATS[kind]
    n = 801  # an odd count: odd-sized data chunks at 8 and 24 bit
    data = _samples(rng, kind, n, channels)
    path = tmp_path / f"{kind}.wav"
    path.write_bytes(_wav_bytes(data, fmt, bits, channels, extensible,
                                ODD_CHUNK if odd else b""))
    ours = load_wav(str(path))
    assert ours.dtype == np.float32 and ours.shape == (n,)
    if kind == "pcm8" and extensible:
        # neither of the JAX package's loaders reads this (the native one
        # has no 8-bit path, the stdlib one no extensible header): hold the
        # port to the stdlib one's 8-bit formula
        u8 = np.frombuffer(data, np.uint8).reshape(n, channels)[:, 0]
        np.testing.assert_array_equal(
            ours, (u8.astype(np.float32) - 128.0) / 128.0)
        return
    theirs = jax_load_wav(str(path))
    np.testing.assert_allclose(ours, theirs, atol=1.5e-7, rtol=0)


def test_load_wav_refuses_what_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all, but long enough" * 4)
    with pytest.raises(ValueError):
        load_wav(str(bad))
    f64 = tmp_path / "f64.wav"
    f64.write_bytes(_wav_bytes(np.zeros(16, "<f8").tobytes(), 3, 64, 1))
    with pytest.raises(ValueError):
        load_wav(str(f64))


# ------------------------------------------------------------------- .escb
def _skewed(rng, K, shape, alpha=0.03):
    probs = rng.dirichlet(np.full(K, alpha))
    return rng.choice(K, shape, p=probs).astype(np.int32)


CODES = {
    # (codes, K, feat_shape): what a trained codec's skewed usage gives,
    # uniform codes, and a codebook size that is no power of two
    "skewed": (lambda r: _skewed(r, 1024, (2, 6, 3, 600)), 1024, (2, 1200)),
    "uniform": (lambda r: r.integers(0, 1024, (1, 6, 3, 150)
                                     ).astype(np.int32), 1024, (1, 300)),
    "non_pow2": (lambda r: _skewed(r, 600, (1, 4, 3, 500), 0.02), 600,
                 (2, 1000)),
    "tiny": (lambda r: r.integers(0, 3, (1, 3, 2, 5)).astype(np.int32), 3,
             (2, 10)),
}


@pytest.mark.parametrize("entropy", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("name", list(CODES))
def test_escb_bytes_match_jax_package(jax_native, rng, name, entropy):
    make, K, fs = CODES[name]
    codes = make(rng)
    blob = pack_codes(codes, K, fs, entropy=entropy)
    assert blob == jax_pack_codes(codes, K, fs, entropy=entropy)
    back, got_fs = unpack_codes(blob)
    np.testing.assert_array_equal(back, codes)
    assert got_fs == fs
    theirs, _ = jax_unpack_codes(blob)
    np.testing.assert_array_equal(theirs, codes)


def test_escb_v2_wins_on_skewed_and_not_on_uniform(rng):
    make, K, fs = CODES["skewed"]
    skewed = make(rng)
    assert pack_codes(skewed, K, fs)[4] == 2
    assert len(pack_codes(skewed, K, fs)) < len(
        pack_codes(skewed, K, fs, entropy=False))
    make, K, fs = CODES["uniform"]
    assert pack_codes(make(rng), K, fs)[4] == 1


def test_escb_writes_v1_and_says_so_without_the_coder(jax_native, rng,
                                                      monkeypatch, capsys):
    def unavailable():
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(rangecoder, "library", unavailable)
    make, K, fs = CODES["skewed"]
    codes = make(rng)
    blob = pack_codes(codes, K, fs)
    assert blob[4] == 1
    assert "range coder unavailable" in capsys.readouterr().err
    v2 = jax_pack_codes(codes, K, fs)
    assert v2[4] == 2
    with pytest.raises(RuntimeError):
        unpack_codes(v2)


def test_range_coder_is_built_from_the_repo_source():
    path, _ = rangecoder.build()
    assert path.parent == ROOT / "esc_tpu_torch" / "_build"
    assert rangecoder.SOURCE == ROOT / "native" / "rangecoder.cpp"
    assert rangecoder.available()


# ------------------------------------------------------------------- .ckpt
def _equal_trees(ours, theirs, path=""):
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and set(ours) == set(theirs), path
        for k in theirs:
            _equal_trees(ours[k], theirs[k], f"{path}/{k}")
    elif isinstance(theirs, (list, tuple)):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _equal_trees(a, b, f"{path}/{i}")
    elif isinstance(theirs, np.ndarray):
        assert ours.shape == theirs.shape, path
        if theirs.dtype.name == "bfloat16":
            np.testing.assert_array_equal(ours, theirs.astype(np.float32))
        else:
            assert ours.dtype == theirs.dtype, path
            np.testing.assert_array_equal(ours, theirs)
    else:
        assert type(ours) is type(theirs) and ours == theirs, path


def test_ckpt_reader_matches_flax(tmp_path, rng):
    import jax.numpy as jnp
    from flax import serialization

    from esc_tpu.checkpoint import save_checkpoint
    from esc_tpu_torch.checkpoint import load_checkpoint

    tree = {"dense": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                      "bias": np.zeros(4, np.float32)},
            "ints": np.arange(300, dtype=np.int64).reshape(3, 100),
            "half": jnp.linspace(-2, 2, 7, dtype=jnp.bfloat16),
            "scalar": np.float32(2.5), "empty": np.zeros((0, 3), np.float32)}
    path = save_checkpoint(str(tmp_path), "model.ckpt", step=70000,
                           model_state=tree, best_perf=-1.5,
                           rng_state='{"state": [1, 2]}',
                           extra={"name": "x" * 40, "n": -40000,
                                  "big": 2 ** 40, "c": 1 + 2j, "t": (1, 2.0)})
    ours = load_checkpoint(path)
    with open(path, "rb") as f:
        theirs = serialization.msgpack_restore(f.read())
    _equal_trees(ours, theirs)


def test_ckpt_reader_imports_no_flax_or_msgpack():
    code = ("import sys; import esc_tpu_torch.checkpoint, "
            "esc_tpu_torch.cli.compress; "
            "bad = [m for m in ('flax', 'msgpack', 'jax', 'yaml') "
            "if m in sys.modules]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_ckpt_model_state_loads_into_the_port(tmp_path):
    import jax

    from esc_tpu.checkpoint import save_checkpoint
    from esc_tpu.models import ESC as JaxESC
    from esc_tpu_torch.checkpoint import load_model_state
    from esc_tpu_torch.convert import from_jax_params
    from esc_tpu_torch.models import ESC

    cfg = dict(in_dim=2, in_freq=192, h_dims=[8, 8, 8, 8, 16, 16],
               max_streams=6, patch_size=[3, 2], swin_heads=[2, 2, 2, 2, 2],
               swin_depth=1, window_size=4, mlp_ratio=2.0, overlap=2,
               group_size=3, codebook_size=64, codebook_dims=[4] * 6,
               l2norm=True)
    ref = JaxESC(**cfg)
    ref.init_params(example_len=7920)
    params = jax.tree.map(np.asarray, ref.variables["params"])
    path = save_checkpoint(str(tmp_path), "model.ckpt", step=4,
                           model_state=params)
    state = load_model_state(path)
    want = from_jax_params(params)
    assert state.keys() == want.keys()
    assert all(torch.equal(state[k], want[k]) for k in want)
    port = ESC(seed=3, device="cpu", **cfg)
    port.load_state_dict(state)  # strict: every weight of the port
    got = port.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_ckpt_writer_gives_flax_bytes(tmp_path, rng):
    from flax import serialization

    from esc_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
    from esc_tpu_torch.checkpoint import load_checkpoint, packb, \
        save_checkpoint

    tree = {"b": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                  "bias": np.zeros(4, np.float32)},
            "a": [1, 2.5, "x" * 40, -3, 300, -40000, 2 ** 40, None, True],
            "s": np.float32(2.5), "i": np.int64(7), "e": np.zeros((0, 3)),
            "many": {str(i): i for i in range(20)}, "bin": b"\x00" * 300}
    assert packb(tree) == serialization.msgpack_serialize(tree)
    path = save_checkpoint(str(tmp_path), "best.ckpt", step=12,
                           model_state=tree["b"], optimizer_state={"n": 1},
                           scheduler_state={"type": "constant", "step": 12},
                           best_perf=2.5, rng_state="{}")
    assert [p.name for p in tmp_path.iterdir()] == ["best.ckpt"]
    ours, theirs = load_checkpoint(path), jax_load_checkpoint(path)
    _equal_trees(ours, theirs)
    assert set(theirs) == {"step", "model_state_dict", "optimizer_state_dict",
                           "scheduler_state_dict", "best_perf", "rng_state"}
    np.testing.assert_array_equal(theirs["model_state_dict"]["kernel"],
                                  tree["b"]["kernel"])
