"""Build the port's CUDA kernels with plain ``nvcc`` and load them with ctypes.

Every source under ``esc_tpu_torch/csrc/*.cu`` is compiled by its own
``nvcc`` process, all started together, and the objects are linked into one
shared library with a plain C interface, for ``sm_90a`` (Hopper). No
PyTorch header is included, so the build takes seconds. The
library lands in ``esc_tpu_torch/_build/`` (listed in ``.gitignore``) under
a name that carries the hash of the sources, so a changed source is rebuilt
and an unchanged one is loaded as it is. The build runs at the first launch
of a kernel, never at import.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "nvcc_commands", "library_path",
           "build", "build_log", "library", "function", "check", "num_sms",
           "on_device", "stream_of", "MAX_SMEM_PER_BLOCK", "SMEM_PER_SM",
           "SMEM_RESERVED_PER_BLOCK"]

# an H100 SM: 228 KB of shared memory, of which a block may take 227 KB and
# the system reserves 1 KB per block
MAX_SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENCODE = "arch=compute_90a,code=sm_90a"

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (argtypes, restype)
    "esc_codebook_argmin": ([_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i,
                             _i, _vp], _i),
    "esc_window_attention": ([_vp, _i, _vp, _vp, _i, _vp, _i, _i, _i, _f,
                              _i, _i, _i, _i, _i, _i, _i, _i, _vp], _i),
    "esc_layer_norm": ([_vp, _vp, _vp, _vp, _f, ctypes.POINTER(_i), _vp],
                       _i),
    "esc_snake": ([_vp, _vp, _vp, ctypes.POINTER(ctypes.c_uint32), _vp],
                  _i),
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


def nvcc_commands(output: Path) -> tuple[list[list[str]], list[str]]:
    """(one compile command per source, the link command) that build
    ``output``; the objects lie beside it."""
    nvcc = _nvcc()
    compiles, objects = [], []
    for src in _sources():
        obj = output.with_name(f"{output.stem}.{src.stem}.o")
        objects.append(str(obj))
        compiles.append([nvcc, "-gencode", GENCODE, "-std=c++17", "-O3",
                         "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c",
                         str(src), "-o", str(obj)])
    link = [nvcc, "-gencode", GENCODE, "-shared", "-o", str(output),
            *objects]
    return compiles, link


def library_path() -> Path:
    digest = hashlib.sha256()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return BUILD_DIR / f"libesc_kernels_{digest.hexdigest()[:16]}.so"


def _log_path(path: Path) -> Path:
    return path.with_suffix(".ptxas.txt")


def build() -> tuple[Path, bool]:
    """Compile the sources unless the library of their hash exists.

    Returns ``(path, built)``; raises with the compiler's output on failure.
    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills of every kernel) is kept beside the library, see
    :func:`build_log`.
    """
    path = library_path()
    if path.exists():
        return path, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    compiles, link = nvcc_commands(tmp)
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in compiles]
    outputs = [p.communicate()[0] for p in procs]
    log = "".join(outputs)
    try:
        failed = [p.returncode for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for cmd in compiles:  # the objects ("-o" is each command's last)
            Path(cmd[-1]).unlink(missing_ok=True)
    _log_path(path).write_text(log)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return path, True


def build_log() -> str:
    """The ``-Xptxas -v`` report of the library's build ("" if not kept)."""
    log = _log_path(library_path())
    return log.read_text() if log.exists() else ""


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


@functools.lru_cache(maxsize=None)
def function(name: str):
    """One entry point of the loaded library, resolved once."""
    return getattr(library(), name)


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(dev: torch.device):
    """A context that makes ``dev`` current, entered only when it is not."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def stream_of(dev: torch.device) -> int:
    """The raw current CUDA stream of ``dev``, for a kernel's launch (read
    without building a ``torch.cuda.Stream``, which costs about 10 us of
    host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def check(err: int, what: str) -> None:
    """Raise if a kernel's entry point returned a CUDA error."""
    if err:
        msg = library().esc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
