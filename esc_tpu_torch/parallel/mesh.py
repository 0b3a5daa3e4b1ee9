"""Data parallelism over ``torch.distributed``: one rank per card.

Port of ``esc_tpu/parallel/mesh.py``. The JAX package runs one program
over a mesh of devices and lets XLA insert the gradient reduction; here
each rank is a process that drives one card (NCCL) or, with ``--device
cpu``, one CPU process (gloo), and what SPMD does implicitly is explicit:

- the global batch is cut into one block of rows per rank
  (:meth:`DataParallel.shard`);
- the parameters are broadcast from rank 0 (:meth:`DataParallel.replicate`);
- after the backward pass, the gradients are averaged over the ranks by
  one all-reduce of one flat buffer (:meth:`DataParallel.average_grads`);
  a parameter with no gradient in a step (the codebooks, or the
  discriminator, in the freeze steps) contributes zeros, as in the JAX
  package's gradient, so every rank reduces the same buffer;
- logged values are averaged the same way (:meth:`DataParallel.mean`).

Each exchange runs in the span ``dp.allreduce``
(:mod:`esc_tpu_torch.utils.profiling`).

With one rank and no process group every method is the identity.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.profiling import annotate

__all__ = ["DataParallel", "init_distributed", "process_is_main"]


def _backend_for(device: torch.device) -> str:
    """NCCL between cards, gloo between CPU processes."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device: torch.device, init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> int:
    """Join the process group of this run; returns its size.

    Given ``init_method`` (``tcp://localhost:<port>``), ``world_size`` and
    ``rank``, as the train CLI's spawned ranks are, those are used. Without
    them, ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``) is read, which spans hosts, as
    ``esc_tpu``'s ``init_distributed`` does for a multi-host TPU slice; with
    neither, this process trains alone. Idempotent.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if init_method is not None:
        dist.init_process_group(_backend_for(device), init_method=init_method,
                                world_size=world_size, rank=rank)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group(_backend_for(device), init_method="env://")
    else:
        return 1
    return dist.get_world_size()


def process_is_main() -> bool:
    """Rank 0 logs, evaluates and writes (the reference's
    ``accel.is_main_process``)."""
    return not dist.is_initialized() or dist.get_rank() == 0


class DataParallel:
    """The ranks of this run's process group, or one process alone.

        dp = DataParallel(device)
        dp.replicate(module.parameters())       # rank 0's weights everywhere
        rows = dp.shard(global_batch_rows)      # this rank's block
        loss.backward(); dp.average_grads(params); opt.step()
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.active = dist.is_initialized() and dist.get_world_size() > 1
        self.num_devices = dist.get_world_size() if self.active else 1
        self.rank = dist.get_rank() if self.active else 0

    def shard(self, rows: Sequence) -> Sequence:
        """This rank's block of a global batch's rows: rows ``r*b`` to
        ``(r+1)*b - 1`` of ``b * num_devices``."""
        b, rem = divmod(len(rows), self.num_devices)
        if rem:
            raise ValueError(f"a global batch of {len(rows)} rows does not "
                             f"split over {self.num_devices} ranks")
        return rows[self.rank * b:(self.rank + 1) * b]

    @torch.no_grad()
    def replicate(self, tensors: Iterable[torch.Tensor]) -> None:
        """Overwrite ``tensors`` on every rank with rank 0's."""
        if self.active:
            for t in tensors:
                dist.broadcast(t.data, 0)

    @torch.no_grad()
    def average_grads(self, params: Sequence[torch.Tensor]) -> None:
        """Every parameter's ``.grad`` becomes its mean over the ranks; a
        missing gradient is taken as zeros (and then set)."""
        if not self.active:
            return
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        with annotate("dp.allreduce"):
            dist.all_reduce(flat)
        flat /= self.num_devices
        for p, g in zip(params, flat.split([g.numel() for g in grads])):
            p.grad = g.view_as(p)

    @torch.no_grad()
    def mean(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` averaged over the ranks (a new tensor)."""
        if not self.active:
            return values
        out = values.detach().clone()
        with annotate("dp.allreduce"):
            dist.all_reduce(out)
        return out / self.num_devices

    def barrier(self) -> None:
        """Wait for every rank: after rank 0's evaluation and writes."""
        if self.active:
            if dist.get_backend() == "nccl":
                dist.barrier(device_ids=[self.device.index or 0])
            else:
                dist.barrier()
