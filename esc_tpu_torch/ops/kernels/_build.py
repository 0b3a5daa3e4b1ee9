"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

All sources under ``esc_tpu_torch/csrc/*.cu`` are compiled in one ``nvcc``
call into one shared library with a plain C interface, for ``sm_90a``
(Hopper). No PyTorch header is included, so the build takes seconds. The
library lands in ``esc_tpu_torch/_build/`` (listed in ``.gitignore``) under
a name that carries the hash of the sources, so a changed source is rebuilt
and an unchanged one is loaded as it is. The build runs at the first launch
of a kernel, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "nvcc_command", "library_path",
           "build", "library", "check"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENCODE = "arch=compute_90a,code=sm_90a"

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "esc_codebook_argmin": ([_vp, _vp, _vp, _i, _i, _i, _vp], _i),
    "esc_window_attention": ([_vp, _i, _vp, _vp, _i, _vp, _i, _i, _i, _f,
                              _vp], _i),
    "esc_cuda_error_string": ([_i], ctypes.c_char_p),
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "port's CUDA kernels are built with it at first use")


def nvcc_command(output: Path) -> list[str]:
    return [_nvcc(), "-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(output),
            *(str(p) for p in _sources())]


def library_path() -> Path:
    digest = hashlib.sha256()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libesc_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, bool]:
    """Compile the sources unless the library of their hash exists.

    Returns ``(path, built)``; raises with the compiler's output on failure.
    """
    path = library_path()
    if path.exists():
        return path, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, True


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's entry point returned a CUDA error."""
    if err:
        msg = library().esc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
