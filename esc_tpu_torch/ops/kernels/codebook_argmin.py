"""Codebook distance-argmin: CUDA kernel wrapper and its plain PyTorch version.

Port of ``esc_tpu/ops/pallas/vq_kernels.py::codebook_argmin``. For each
query row: ``argmin_k(|z|^2 - 2 z.c_k + |c_k|^2)`` in fp32, the first index
on exact ties, code 0 for a row whose distances hold a NaN. The kernel is
``esc_tpu_torch/csrc/codebook_argmin.cu``; its launch plan is
:func:`launch_plan`, a pure function of the shapes. A codebook too large for
a block's shared memory streams through it in K-tiles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["codebook_argmin", "codebook_argmin_plain", "launch_plan",
           "ArgminPlan"]

MAX_THREADS = 256         # the kernel's __launch_bounds__
MAX_WARPS = MAX_THREADS // 32
MAX_ROWS = 8              # rows per block
SPECIALISED_DIMS = (6, 8, 12, 16, 24, 32)  # the kernel's template widths
TILE_BYTES = 64 * 1024    # a K-tile's aim, where the codebook does not fit


class ArgminPlan(NamedTuple):
    """How one call maps onto the card; checked again by the kernel.

    ``grid`` blocks of ``threads`` threads take ``rows`` consecutive query
    rows each; the codebook passes through shared memory ``k_tile``
    codewords at a time (``k_tile == K``: all of it at once), ``bulk_bytes``
    of a full tile by one bulk copy (when the codebook is 16-byte aligned),
    the rest by plain loads.
    """
    rows: int
    threads: int
    grid: int
    smem: int
    bulk_bytes: int
    k_tile: int


def max_rows(d: int) -> int:
    """Rows per block a width allows (the kernel keeps ``rows * d`` query
    values in registers; the generic instance keeps them in shared
    memory)."""
    if d not in SPECIALISED_DIMS:
        return MAX_ROWS
    return max(1, min(MAX_ROWS, 64 // d))


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(k_tile: int, d: int, rows: int) -> int:
    """The kernel's smem_bytes: one codebook tile, the query rows, the
    per-warp partial minima and the mbarrier."""
    return (_round16(k_tile * d * 4) + _round16(rows * d * 4)
            + MAX_WARPS * MAX_ROWS * 16 + 8)


@functools.lru_cache(maxsize=None)
def launch_plan(N: int, K: int, d: int, num_sms: int) -> ArgminPlan:
    """The kernel's launch plan for ``N`` rows against a ``(K, d)`` codebook
    on a card of ``num_sms`` SMs: about ``N / num_sms`` rows per block, so
    that one wave of blocks covers the card. The codebook is one tile where
    it fits in a block's shared memory, else tiles of about
    :data:`TILE_BYTES` (a multiple of 4 codewords, so that every tile starts
    on 16 bytes). Raises ``ValueError`` where not even 4 codewords fit."""
    rows = min(max_rows(d), max(1, -(-N // num_sms)))
    grid = -(-N // rows)
    k_tile = K
    if smem_bytes(K, d, rows) > _build.MAX_SMEM_PER_BLOCK:
        k_tile = min(K, max(4, TILE_BYTES // (d * 4) // 4 * 4))
    smem = smem_bytes(k_tile, d, rows)
    if smem > _build.MAX_SMEM_PER_BLOCK:
        raise ValueError(f"codebook ({K}, {d}): not even a tile of "
                         f"{k_tile} codewords fits in shared memory")
    threads = min(MAX_THREADS, 32 * -(-k_tile // 32))
    return ArgminPlan(rows, threads, grid, smem, k_tile * d * 4 // 16 * 16,
                      k_tile)


def codebook_argmin_plain(z: torch.Tensor, codebook: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version: (N, d), (K, d) float32 -> (N,) int32 codes.

    The distance expansion keeps the kernel's order, ``(zsq - 2 dot) + csq``.
    The argmin is the TPU kernel's two-pass min: the min distance, then the
    least index among the exact minima; a NaN makes the min NaN, no distance
    is ``<=`` it, and the row gets code 0.
    """
    z = z.float()
    codebook = codebook.float()
    K = codebook.shape[0]
    dist = ((z * z).sum(1, keepdim=True) - 2.0 * (z @ codebook.T)
            + (codebook * codebook).sum(1)[None, :])
    m = dist.min(1, keepdim=True).values
    idx = torch.arange(K, device=z.device, dtype=torch.int32)[None, :]
    cand = torch.where(dist <= m, idx, K)
    code = cand.min(1).values
    return torch.where(code >= K, 0, code).to(torch.int32)


def codebook_argmin(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook row for each query: (N, d), (K, d) -> (N,) int32.

    A CUDA tensor goes through the CUDA kernel; a CPU tensor through
    :func:`codebook_argmin_plain`.
    """
    if z.device.type == "cpu" and codebook.device.type == "cpu":
        return codebook_argmin_plain(z, codebook)
    if z.device.type != "cuda" or codebook.device != z.device:
        raise ValueError(f"z on {z.device} and codebook on {codebook.device}:"
                         " both must lie on one CUDA device")
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"float32 expected, got {z.dtype} and {codebook.dtype}")
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"shapes (N, d) and (K, d) expected, got "
                         f"{tuple(z.shape)} and {tuple(codebook.shape)}")
    if not (z.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("z and codebook must be contiguous")
    if torch.is_grad_enabled() and (z.requires_grad or codebook.requires_grad):
        raise RuntimeError("codebook_argmin has no backward: call it under "
                           "torch.no_grad()")
    N, d = z.shape
    K = codebook.shape[0]
    dev = z.device
    plan = launch_plan(N, K, d, _build.num_sms(dev.index))
    out = torch.empty(N, dtype=torch.int32, device=dev)
    fn = _build.function("esc_codebook_argmin")
    with _build.on_device(dev):
        _build.check(fn(
            z.data_ptr(), codebook.data_ptr(), out.data_ptr(), N, K, d,
            plan.rows, plan.threads, plan.grid, plan.smem, plan.k_tile,
            _build.stream_of(dev)), "codebook_argmin")
    codebook_argmin.launches += 1
    return out


codebook_argmin.launches = 0
