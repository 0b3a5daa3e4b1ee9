"""Pipelined serving: keep a bounded number of batches in flight.

Port of ``esc_tpu/serving.py``. PyTorch queues CUDA work without waiting for
it, so a serving loop pipelines by itself as long as the host does not block
on each batch. :func:`stream_map` keeps at most ``depth`` batches in flight:

- host arrays are uploaded from pinned memory with ``non_blocking=True``;
- each batch's results are copied back into pinned buffers, followed by a
  recorded CUDA event;
- the host waits only on the oldest batch's event, and then yields it.

So the host launches batch ``i + 1 .. i + depth - 1`` while batch ``i``
computes and downloads. ``depth=1`` is the serial loop. On the CPU the calls
are plain.

Under a profiler each batch shows as four spans
(:mod:`esc_tpu_torch.utils.profiling`): ``serving.upload``,
``serving.launch`` (the host's enqueue of ``fn``'s work),
``serving.download`` and ``serving.wait``.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from .utils.profiling import annotate

__all__ = ["stream_map", "stream_roundtrip"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _upload(tree, device: torch.device):
    """Host arrays and CPU tensors of ``tree`` onto ``device``; to a card
    from pinned memory, without blocking the host."""
    def up(leaf):
        if isinstance(leaf, np.ndarray):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        if not isinstance(leaf, torch.Tensor) or leaf.device == device:
            return leaf
        if device.type == "cuda" and leaf.device.type == "cpu":
            return leaf.pin_memory().to(device, non_blocking=True)
        return leaf.to(device)
    with annotate("serving.upload"):
        return _tree_map(up, tree)


def _start_download(tree):
    """(host tree, event): CUDA tensors copied into pinned host buffers on
    the current stream, then an event recorded behind the copies."""
    event = None

    def down(leaf):
        nonlocal event
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf, non_blocking=True)
            event = torch.cuda.Event()
            return host
        return leaf
    with annotate("serving.download"):
        host = _tree_map(down, tree)
        if event is not None:
            event.record()
    return host, event


def _finish(item, to_host: bool):
    if not to_host:
        return item
    host, event = item
    with annotate("serving.wait"):
        if event is None:
            return _tree_map(lambda leaf: leaf.numpy()
                             if isinstance(leaf, torch.Tensor) else leaf,
                             host)
        event.synchronize()
        # copied out, so that the pinned buffers go back to PyTorch's cache
        # of pinned memory for the next batches instead of being pinned anew
        return _tree_map(lambda leaf: leaf.numpy().copy()
                         if isinstance(leaf, torch.Tensor) else leaf, host)


def stream_map(fn: Callable[[Any], Any], inputs: Iterable[Any],
               depth: int = 2, to_host: bool = True,
               device: Optional[Union[str, torch.device]] = None
               ) -> Iterator[Any]:
    """Map ``fn`` over ``inputs`` with up to ``depth`` batches in flight.

    With ``device``, each input's numpy arrays and CPU tensors are uploaded
    there before ``fn`` sees them. With ``to_host`` the yielded values are
    numpy trees, each yielded once its download has landed; otherwise
    ``fn``'s tensors are yielded with no wait. Outputs come in input order.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dev = torch.device(device) if device is not None else None
    inflight: deque = deque()
    for batch in inputs:
        if dev is not None:
            batch = _upload(batch, dev)
        with annotate("serving.launch"):
            out = fn(batch)
        inflight.append(_start_download(out) if to_host else out)
        if len(inflight) >= depth:
            yield _finish(inflight.popleft(), to_host)
    while inflight:
        yield _finish(inflight.popleft(), to_host)


def stream_roundtrip(model, batches: Iterable[np.ndarray],
                     num_streams: int = 6, depth: int = 2,
                     to_host: bool = True) -> Iterator[Any]:
    """Pipelined encode + decode over a stream of ``(B, L)`` host batches.

    Yields ``(codes, recon)`` per batch, in order, with ``depth`` batches in
    flight (see :func:`stream_map`).
    """
    def fn(x):
        codes, _, recon = model.roundtrip(x, num_streams=num_streams)
        return codes, recon

    return stream_map(fn, batches, depth=depth, to_host=to_host,
                      device=model.device)
