"""The adaptive range coder of ``.escb`` v2, bound by ctypes.

Port of ``esc_tpu/native/rangecoder.py``. The coder is the repo's
``native/rangecoder.cpp``, unchanged: one adaptive frequency model per
(stream, group) context, so encoder and decoder need no tables. It is
compiled with the host's C++ compiler (``$CXX``, else ``c++`` or ``g++``) at
first use into ``esc_tpu_torch/_build/`` (listed in ``.gitignore``), under a
name that carries the source's hash, so a changed source is rebuilt. The
coder is integer arithmetic only: any compiler gives the same bytes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["SOURCE", "library_path", "build", "library", "available",
           "encode", "decode"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "native" / "rangecoder.cpp"
BUILD_DIR = _PKG / "_build"

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler ($CXX, c++ or g++) to build the "
                       "range coder of .escb v2 with")


def library_path() -> Path:
    if not SOURCE.exists():
        raise RuntimeError(f"range coder source {SOURCE} is missing")
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libescrc_{digest}.so"


def build() -> tuple[Path, bool]:
    """Compile the coder unless the library of its source's hash exists.
    Returns ``(path, built)``; raises ``RuntimeError`` on failure."""
    path = library_path()
    if path.exists():
        return path, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_compiler(), "-O3", "-std=c++17", "-shared", "-fPIC",
           str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the range coder failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, True


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded coder, built first if needed."""
    lib = ctypes.CDLL(str(build()[0]))
    lib.esc_rc_encode.restype = ctypes.c_long
    lib.esc_rc_encode.argtypes = [_i32p, _i32p, ctypes.c_long, ctypes.c_int,
                                  ctypes.c_int, _u8p, ctypes.c_long]
    lib.esc_rc_decode.restype = ctypes.c_long
    lib.esc_rc_decode.argtypes = [_u8p, ctypes.c_long, _i32p, ctypes.c_long,
                                  ctypes.c_int, ctypes.c_int, _i32p]
    return lib


def available() -> bool:
    """True when the coder builds and loads on this machine."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def encode(symbols: np.ndarray, contexts: np.ndarray, K: int,
           n_ctx: int) -> bytes:
    """Range-encode int symbols (< K) with context ids (< n_ctx)."""
    symbols = np.ascontiguousarray(symbols, np.int32).reshape(-1)
    contexts = np.ascontiguousarray(contexts, np.int32).reshape(-1)
    if symbols.shape != contexts.shape:
        raise ValueError("one context id per symbol expected")
    cap = symbols.size * 4 + 64
    out = np.empty(cap, np.uint8)
    n = library().esc_rc_encode(symbols.ctypes.data_as(_i32p),
                                contexts.ctypes.data_as(_i32p), symbols.size,
                                K, n_ctx, out.ctypes.data_as(_u8p), cap)
    if n < 0:
        raise RuntimeError("range coder output overflow")
    return out[:n].tobytes()


def decode(blob: bytes, contexts: np.ndarray, K: int,
           n_ctx: int) -> np.ndarray:
    """Inverse of :func:`encode` (the same context sequence)."""
    contexts = np.ascontiguousarray(contexts, np.int32).reshape(-1)
    data = np.frombuffer(blob, np.uint8)
    out = np.empty(contexts.size, np.int32)
    library().esc_rc_decode(data.ctypes.data_as(_u8p), data.size,
                            contexts.ctypes.data_as(_i32p), contexts.size,
                            K, n_ctx, out.ctypes.data_as(_i32p))
    return out
