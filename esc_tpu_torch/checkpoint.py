"""The JAX package's ``.ckpt`` checkpoints, read and written without flax or
msgpack.

Port of ``esc_tpu/checkpoint.py`` (``load_checkpoint``,
``save_checkpoint``).
A ``.ckpt`` is one msgpack document as ``flax.serialization.
msgpack_serialize`` writes it: maps with str keys, arrays, str and bin, ints,
floats, nil and bools, and msgpack extension types for numpy values (1: an
ndarray, packed as the msgpack array ``(shape, dtype name, buffer)``; 2: a
complex; 3: a numpy scalar, packed as an ndarray). Arrays above flax's
chunk size come as ``{"__msgpack_chunked_array__": True, "shape": ...,
"chunks": ...}`` and are joined again.

:func:`load_checkpoint` returns that tree with numpy leaves, as
``flax.serialization.msgpack_restore`` does (msgpack arrays as lists;
bfloat16 arrays widened, exactly, to float32). :func:`load_model_state`
turns a checkpoint's ``model_state_dict`` into the port's state dict: a
flax parameter tree (what both trainers write), or flax variables
``{"params": ..., "batch_stats": ...}``, whose BatchNorm statistics (the
convolution backbone's) become the modules' running buffers.
:func:`save_checkpoint` writes the training state in the same layout and
encoding (:func:`packb`, the bytes ``flax.serialization.msgpack_serialize``
gives for such a tree), the weights in flax's parameter layout, so that
both packages read what the port trains.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from .convert import from_jax_params

__all__ = ["load_checkpoint", "unpackb", "load_model_state", "packb",
           "save_checkpoint"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    """A msgpack decoder over one buffer (the subset flax writes)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _ext(self, n: int):
        code = self._unpack(">b")
        return _ext_value(code, bytes(self._take(n)))

    def value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self._take(self._unpack(sized[b])))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sized:
            return self._str(self._unpack(sized[b]))
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            return self._ext(self._unpack(sized[b]))
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        if b in (0xDC, 0xDD):
            n = self._unpack(">H" if b == 0xDC else ">I")
            return [self.value() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    """One msgpack document -> Python tree (str as bytes where ``raw``)."""
    reader = _Reader(data, raw)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return value


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buffer = unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":  # the high half of a float32, exactly
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _ext_value(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"msgpack extension type {code} is not supported")


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked arrays (``__msgpack_chunked_array__``)."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape, chunks = tree["shape"], tree["chunks"]
        shape = tuple(shape[str(i)] for i in range(len(shape)))
        chunks = [chunks[str(i)] for i in range(len(chunks))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a ``.ckpt`` payload (``esc_tpu.checkpoint.load_checkpoint``):
    the top-level keys (``step``, ``model_state_dict``, ...) with numpy
    array leaves."""
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))


def load_model_state(path: str) -> Dict[str, torch.Tensor]:
    """The codec weights of a ``.ckpt`` as the port's state dict."""
    return from_jax_params(load_checkpoint(path)["model_state_dict"])


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    forms = ((">B", 0xCC, 0, 0xFF), (">H", 0xCD, 0, 0xFFFF),
             (">I", 0xCE, 0, 0xFFFFFFFF), (">Q", 0xCF, 0, 2 ** 64 - 1)) \
        if n >= 0 else ((">b", 0xD0, -2 ** 7, -1), (">h", 0xD1, -2 ** 15, -1),
                        (">i", 0xD2, -2 ** 31, -1), (">q", 0xD3, -2 ** 63, -1))
    for fmt, tag, lo, hi in forms:
        if lo <= n <= hi:
            return bytes([tag]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} does not fit msgpack's 64-bit integers")


def _pack_sized(n: int, small: Optional[int], tags, limit: int = 31
                ) -> bytes:
    """The header of a str / bin / array / map of ``n`` entries: the fix
    form below ``limit`` (where there is one), else 8 / 16 / 32 bits."""
    if small is not None and n <= limit:
        return bytes([small | n])
    for fmt, tag in zip((">B", ">H", ">I"), tags):
        if tag is not None and n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([tag]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} entries do not fit msgpack")


def _pack_ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        head = bytes([fixed[len(data)]])
    else:
        head = _pack_sized(len(data), None, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + data


def _pack_ndarray(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.nbytes > 2 ** 30:
        raise ValueError(f"cannot write an array of {a.dtype} and "
                         f"{a.nbytes} bytes")
    return packb([list(a.shape), a.dtype.name, a.tobytes("C")])


def packb(value: Any) -> bytes:
    """One msgpack document of ``value``, as flax writes it: maps with
    sorted str keys, str and bin, lists, ints, floats as doubles, nil,
    bools, numpy arrays (extension 1) and numpy scalars (extension 3)."""
    if value is None:
        return b"\xc0"
    if isinstance(value, bool):
        return b"\xc3" if value else b"\xc2"
    if isinstance(value, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _pack_ndarray(value))
    if isinstance(value, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _pack_ndarray(np.asarray(value)))
    if isinstance(value, int):
        return _pack_int(value)
    if isinstance(value, float):
        return b"\xcb" + struct.pack(">d", value)
    if isinstance(value, str):
        b = value.encode("utf-8")
        return _pack_sized(len(b), 0xA0, (0xD9, 0xDA, 0xDB)) + b
    if isinstance(value, (bytes, bytearray)):
        return _pack_sized(len(value), None, (0xC4, 0xC5, 0xC6)) + bytes(
            value)
    if isinstance(value, (list, tuple)):
        return _pack_sized(len(value), 0x90, (None, 0xDC, 0xDD), 15) + \
            b"".join(packb(v) for v in value)
    if isinstance(value, dict):
        if not all(isinstance(k, str) for k in value):
            raise TypeError("checkpoint maps take str keys")
        return _pack_sized(len(value), 0x80, (None, 0xDE, 0xDF), 15) + \
            b"".join(packb(k) + packb(value[k]) for k in sorted(value))
    raise TypeError(f"cannot write {type(value).__name__} to a checkpoint")


def save_checkpoint(save_path: str, tag: str, *, step: int,
                    model_state: Dict[str, Any],
                    optimizer_state: Optional[Dict[str, Any]] = None,
                    scheduler_state: Optional[Dict[str, Any]] = None,
                    best_perf: float = -1.0,
                    rng_state: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``{save_path}/{tag}`` with ``esc_tpu``'s top-level keys
    (``esc_tpu/checkpoint.py:40-67``): ``model_state`` is the flax
    parameter tree (:func:`esc_tpu_torch.convert.to_jax_params`), or the
    flax variables of a codec with BatchNorm statistics
    (:func:`esc_tpu_torch.convert.to_jax_variables`), the optimizer state
    optax's (:meth:`esc_tpu_torch.train.optim.AdamW.state_dict`); ``extra``
    adds keys, as the adversarial trainer's ``model_disc_state_dict`` (a
    flax parameter tree) and ``optimizer_disc_state_dict``. The file is written under a name of its
    own in the same directory and moved into place, so that a reader never
    sees half of it and two writers never share a temporary file."""
    os.makedirs(save_path, exist_ok=True)
    payload = {"step": int(step), "model_state_dict": model_state,
               "optimizer_state_dict": optimizer_state or {},
               "scheduler_state_dict": scheduler_state or {},
               "best_perf": float(best_perf)}
    if rng_state is not None:
        payload["rng_state"] = rng_state
    payload.update(extra or {})
    path = os.path.join(save_path, tag)
    fd, tmp = tempfile.mkstemp(prefix=f".{tag}.", suffix=".tmp",
                               dir=save_path)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(packb(payload))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path
