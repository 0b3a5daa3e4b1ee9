"""Local replicas of a codec: one process drives several cards.

Serving and evaluation need no gradient and no collective, so spreading them
over the cards of a host takes no ``torch.distributed``: the codec's module
is copied once onto each card, the work is cut into one piece per card, and
every card's piece is queued before any result is read back, so that the
cards run at the same time. This is the inference side of
``esc_tpu/parallel/mesh.py::DataParallel`` (its ``replicate`` and ``shard``
over the local devices); training's data parallelism, one rank per process,
is :class:`esc_tpu_torch.parallel.DataParallel`.

    dp = Replicas()                              # every visible card
    replicas = dp.replicate(model)               # model first, then copies
    outs = dp.map(replicas, lambda r, x: r.encode(x, 6)[0], pieces)
"""

from __future__ import annotations

import copy
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

from ..serving import _tree_map, _upload

__all__ = ["Replicas"]

Device = Union[str, torch.device]


class Replicas:
    """The devices a codec is copied onto; ``None`` means every visible
    card (raises where there is none). Devices may repeat (``["cpu"] *
    3``): each entry takes one piece of the work."""

    def __init__(self, devices: Optional[Sequence[Device]] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass the "
                                   "devices, e.g. Replicas(['cpu'])")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [_indexed(torch.device(d)) for d in devices]
        if not self.devices:
            raise ValueError("Replicas needs at least one device")

    @classmethod
    def visible(cls, device: Device) -> "Replicas":
        """Every visible card for a CUDA ``device``, else ``device``
        alone."""
        device = torch.device(device)
        return cls() if device.type == "cuda" else cls([device])

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def replicate(self, model) -> List[Any]:
        """One codec per device, in order: ``model`` itself where the
        device is its own, else a copy of its facade around a copy of its
        module on that device (the kernels' and compute dtype's settings
        are the module's attributes, so the copy keeps them)."""
        home = _indexed(torch.device(model.device))
        copies = {home: model}
        for dev in self.devices:
            if dev not in copies:
                replica = copy.copy(model)
                replica.module = copy.deepcopy(model.module).to(dev)
                replica.device = dev
                copies[dev] = replica
        return [copies[dev] for dev in self.devices]

    def map(self, replicas: Sequence[Any], fn: Callable[[Any, Any], Any],
            pieces: Sequence[Any], out_device: Device = "cpu") -> List[Any]:
        """``fn(replica, piece)`` for each pair, in order, with the piece's
        host arrays uploaded to the replica's device first. Every piece's
        work is queued before any output moves, so the cards overlap; the
        outputs' tensors are then moved to ``out_device`` (the host by
        default) in order."""
        if len(pieces) > len(replicas):
            raise ValueError(f"{len(pieces)} pieces for {len(replicas)} "
                             "replicas")
        outs = [fn(r, _upload(p, r.device)) for r, p in zip(replicas, pieces)]
        out_device = torch.device(out_device)
        return [_tree_map(lambda t: t.to(out_device) if isinstance(
            t, torch.Tensor) else t, o) for o in outs]


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal cards compare equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev

