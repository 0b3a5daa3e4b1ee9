"""Device constants: numpy arrays built once and uploaded once a device.

The port's fixed arrays (DFT matrices, overlap-add envelopes, mel banks,
SW-MSA masks, resampling taps) are built in float64 numpy by cached
functions, marked read-only by :func:`frozen`, and reach a device through
:func:`on_device`, which keeps each upload in one bounded cache.

A captured CUDA graph reads a constant at the address it had at the
capture, so a constant must live as long as the graph that read it,
whatever this cache evicts meanwhile. While a list is set by
:func:`keeping`, :func:`on_device` appends each constant it returns to
it; the stage graphs (:mod:`esc_tpu_torch.utils.graphs`) keep that list
with the chain they capture. :func:`capturing` says whether one is set.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, List

import numpy as np
import torch

__all__ = ["frozen", "on_device", "keeping", "capturing"]

_KEPT = threading.local()   # .held: the list this thread's constants go to


def frozen(*arrays: np.ndarray):
    """Mark cached numpy constants read-only: every caller of a cached
    function shares its arrays, so a write by one would reach all."""
    for a in arrays:
        a.setflags(write=False)
    return arrays if len(arrays) > 1 else arrays[0]


@functools.lru_cache(maxsize=192)
def _uploaded(make, args: tuple, index: int, device: torch.device
              ) -> torch.Tensor:
    a = make(*args)
    return torch.tensor(a if index < 0 else a[index], device=device)


def on_device(make, args: tuple, index: int, device: torch.device
              ) -> torch.Tensor:
    """``make(*args)[index]`` (or ``make(*args)`` where ``index`` is -1), a
    numpy constant, as a tensor kept on ``device``: it is uploaded once,
    not at every call. On the CPU too the tensor is a copy, so that it
    shares no memory with the cached numpy array. Handed to the list of
    :func:`keeping`, if one is set."""
    t = _uploaded(make, args, index, device)
    held = getattr(_KEPT, "held", None)
    if held is not None:
        held.append(t)
    return t


@contextlib.contextmanager
def keeping(held: List[torch.Tensor]) -> Iterator[None]:
    """Meanwhile, in this thread, every constant :func:`on_device` returns
    is appended to ``held`` too."""
    outer = getattr(_KEPT, "held", None)
    _KEPT.held = held
    try:
        yield
    finally:
        _KEPT.held = outer


def capturing() -> bool:
    """Whether this thread keeps its constants for a capture
    (:func:`keeping`)."""
    return getattr(_KEPT, "held", None) is not None
