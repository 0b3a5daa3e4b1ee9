"""LayerNorm over the last axis: CUDA kernel wrapper and its plain PyTorch
version.

Replaces no TPU kernel (``esc_tpu`` leaves LayerNorm to XLA). Per row of
``x``'s last axis, width C: ``(x - mean) * rsqrt(var + eps) * weight +
bias``, with the biased variance, in fp32. The kernel is
``esc_tpu_torch/csrc/layer_norm.cu``; it normalises tiles of consecutive rows
within a warp, so that one launch runs at the card's memory bandwidth for
any width. Its launch plan is :func:`launch_plan`, a pure function of the
rows, the width and the card's SMs. The codec's inference path reaches it
through :class:`esc_tpu_torch.modules.scale.LayerNorm`; training keeps
``F.layer_norm`` and its backward.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["layer_norm", "layer_norm_plain", "launch_plan", "LayerNormPlan",
           "MAX_WIDTH"]

MAX_WIDTH = 4096          # the kernel's kMaxC
MAX_WARPS = 4             # the kernel's __launch_bounds__, in warps
STAGES = 2                # tile buffers of a warp (the kernel's kStages)
# aim of one tile, 2 KB: on an H100, serve-batch's 79 calls a batch took
# 2.11 ms with 2 KB tiles in blocks of 4 warps, 2.33 ms with 4 KB tiles in
# blocks of 8, 3.06-3.40 ms with 8 KB tiles
TILE_FLOATS = 512
LANE_GROUPS = (1, 2, 4, 8, 16, 32)


class LayerNormPlan(NamedTuple):
    """How one call maps onto the card; checked again by the kernel.

    A row is reduced by ``lanes`` lanes of a warp (``32 // lanes`` rows at a
    time); a tile is ``rows_per_tile`` consecutive rows, held in a buffer of
    ``pitch`` floats; ``grid`` blocks of ``warps`` warps walk the ``tiles``
    tiles, a warp at a time, with ``smem`` bytes of shared memory each.
    """
    lanes: int
    rows_per_tile: int
    warps: int
    grid: int
    pitch: int
    smem: int
    tiles: int


def bank_conflicts(C: int, lanes: int) -> int:
    """The most distinct 4-byte words that one shared-memory read of the
    kernel's reduction puts on one bank: lane ``g * lanes + k`` reads
    column ``k`` of row ``g`` of rows ``C`` floats apart."""
    banks = {}
    for lane in range(32):
        g, k = divmod(lane, lanes)
        word = g * C + k
        banks.setdefault(word % 32, set()).add(word)
    return max(len(words) for words in banks.values())


def lane_group(C: int) -> int:
    """Lanes a row of width ``C``: the group size whose reads cost least
    per row, reads weighted by their bank conflicts, plus the shuffles that
    add a group's sums; ties go to the larger group (fewer rows a tile)."""
    def cost(lanes):
        reads = -(-C // lanes) * bank_conflicts(C, lanes)
        return lanes * (reads + 2 * math.log2(lanes)) / 32
    return min(LANE_GROUPS, key=lambda lanes: (cost(lanes), -lanes))


def smem_bytes(C: int, warps: int, pitch: int) -> int:
    """The kernel's smem_bytes: gamma and beta, each padded to 16 bytes,
    then the tile buffers of every warp."""
    return 4 * (2 * (-(-C // 4) * 4) + warps * STAGES * pitch)


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, C: int, num_sms: int) -> LayerNormPlan:
    """The kernel's launch plan for ``rows`` rows of width ``C`` on a card
    of ``num_sms`` SMs.

    The lanes of a row come from :func:`lane_group`; a tile holds about
    :data:`TILE_FLOATS` floats, a multiple of the rows a warp reduces at a
    time and no more rows than the call has; a block takes
    :data:`MAX_WARPS` warps where shared memory allows, fewer for wide rows.
    The grid covers the tiles once, at most as many blocks as the card
    holds at once. Raises ``ValueError`` for ``C`` outside
    1..:data:`MAX_WIDTH`.
    """
    if not 1 <= C <= MAX_WIDTH:
        raise ValueError(f"LayerNorm width {C} outside 1..{MAX_WIDTH}")
    lanes = lane_group(C)
    at_once = 32 // lanes
    per_tile = at_once * max(1, min(TILE_FLOATS // (C * at_once),
                                    -(-max(rows, 1) // at_once)))
    pitch = -(-(per_tile * C + 3) // 4) * 4
    warps = MAX_WARPS
    while (warps > 1 and smem_bytes(C, warps, pitch)
           > _build.MAX_SMEM_PER_BLOCK):
        warps -= 1
    smem = smem_bytes(C, warps, pitch)
    if smem > _build.MAX_SMEM_PER_BLOCK:
        raise ValueError(f"LayerNorm width {C}: a warp's tiles need more "
                         "shared memory than a block has")
    tiles = -(-max(rows, 1) // per_tile)
    per_sm = min(_build.SMEM_PER_SM
                 // (smem + _build.SMEM_RESERVED_PER_BLOCK),
                 2048 // (32 * warps), 32)
    grid = min(-(-tiles // warps), num_sms * max(1, per_sm))
    return LayerNormPlan(lanes, per_tile, warps, grid, pitch, smem, tiles)


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version: ``F.layer_norm`` over the last axis."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


@functools.lru_cache(maxsize=None)
def _launch_args(rows: int, C: int, num_sms: int):
    """The entry point's plan array: rows, C and :func:`launch_plan`'s
    fields up to ``smem`` (one argument keeps the ctypes call short)."""
    p = launch_plan(rows, C, num_sms)
    return (ctypes.c_int * 8)(rows, C, p.lanes, p.rows_per_tile, p.warps,
                              p.grid, p.pitch, p.smem)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm of ``x`` over its last axis, width C, with ``weight`` and
    ``bias`` of shape ``(C,)`` (see :func:`layer_norm_plain`).

    A CUDA tensor goes through the CUDA kernel: float32, contiguous, the
    weight and bias on 16-byte boundaries. A CPU tensor goes through
    :func:`layer_norm_plain`.
    """
    dev = x.device
    if dev.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if dev.type != "cuda" or weight.device != dev or bias.device != dev:
        raise ValueError("x, weight and bias must lie on one CUDA device")
    f32 = torch.float32
    if x.dtype is not f32 or weight.dtype is not f32 or bias.dtype is not f32:
        raise TypeError(f"float32 expected, got {x.dtype}, {weight.dtype} "
                        f"and {bias.dtype}")
    shape = x.shape
    C = shape[-1] if shape else 0
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"weight and bias ({C},) expected for x "
                         f"{tuple(shape)}, got {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")
    if not 1 <= C <= MAX_WIDTH:
        raise ValueError(f"LayerNorm width {C} outside 1..{MAX_WIDTH}")
    if not (x.is_contiguous() and weight.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("x, weight and bias must be contiguous")
    if weight.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("weight and bias must start on a 16-byte boundary: "
                         "the kernel reads them 16 bytes at a time")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("layer_norm has no backward: call it under "
                           "torch.no_grad()")
    args = _launch_args(x.numel() // C, C, _build.num_sms(dev.index))
    out = torch.empty_like(x)
    fn = _build.function("esc_layer_norm")
    with _build.on_device(dev):
        _build.check(fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), eps, args, _build.stream_of(dev)),
                     "layer_norm")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
