"""The DAC's snake activation: CUDA kernel wrapper and its plain PyTorch
version.

Replaces no TPU kernel: ``esc_tpu/baselines/dac/layers.py:20`` writes snake
as ``jnp`` expressions and leaves them to XLA, which fuses them on the TPU.
In PyTorch the same expression is five ATen kernels over the whole
``(B, C, T)`` array (a product, ``sin``, a square, a quotient, a sum): about
44 bytes of memory traffic an element, where one pass reads 4 and writes 4.
The DAC runs 58 snakes a roundtrip over 2.33 G elements of a batch of 16
clips of 3 s, so bytes bound the activation, and ATen's passes took about a
quarter of the DAC's device time. The kernel
(``esc_tpu_torch/csrc/snake.cu``) computes each snake in one pass, with
ATen's float32 operations in ATen's order, so its output is the plain
version's bit for bit: it streams the array as one flat run of 16-byte
loads and stores, cut evenly among at most as many blocks as the card holds
at once, and finds each element's channel by two multiply-high divisions.
Its launch plan is :func:`launch_plan`, a pure function of the rows
``B C``, the row length ``T`` and the card's SMs; the divisions' magic
numbers come from :func:`divider`. The DAC's inference reaches it through
:class:`esc_tpu_torch.baselines.dac.layers.Snake1d`; training keeps the
plain expression and its backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build

__all__ = ["snake", "snake_plain", "launch_plan", "SnakePlan", "divider",
           "MAX_ELEMENTS"]

THREADS = 256             # the kernel's kThreads (__launch_bounds__)
UNROLL = 4                # float4s a thread loads before it computes
BLOCKS_PER_SM = 4         # the kernel's kMinBlocks (__launch_bounds__)
LINE = 8                  # float4s of a 128-byte line
MAX_ELEMENTS = 2 ** 31 - 1  # the divisions' range


class SnakePlan(NamedTuple):
    """How one call maps onto the card; checked again by the kernel.

    The array's float4 body is cut into ``grid`` spans of ``per_block``
    float4s (the last one shorter), one a block of ``threads`` threads,
    each thread loading ``unroll`` float4s at a time.
    """
    threads: int
    unroll: int
    grid: int
    per_block: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def launch_plan(rows: int, T: int, num_sms: int) -> SnakePlan:
    """The kernel's launch plan for ``rows`` rows (``B C``) of ``T``
    elements on a card of ``num_sms`` SMs.

    The body of ``rows T // 4`` float4s (at least one) is cut into spans of
    whole 128-byte lines, as even as the lines allow, one a block, over as
    many blocks as fill one round of every thread's loads, at most as many
    as the card holds at once (:data:`BLOCKS_PER_SM` an SM). Raises
    ``ValueError`` for an empty shape or one beyond :data:`MAX_ELEMENTS`.
    """
    n = rows * T
    if rows < 1 or T < 1 or n > MAX_ELEMENTS:
        raise ValueError(f"snake of {rows} rows of {T}: 1..{MAX_ELEMENTS} "
                         "elements")
    work = max(n // 4, 1)
    blocks = min(_ceil_div(work, THREADS * UNROLL), num_sms * BLOCKS_PER_SM)
    per_block = _ceil_div(_ceil_div(work, blocks), LINE) * LINE
    return SnakePlan(THREADS, UNROLL, _ceil_div(work, per_block), per_block)


@functools.lru_cache(maxsize=None)
def divider(d: int) -> tuple[int, int]:
    """``(mul, shift)`` with ``n // d == ((n * mul >> 32) + n) >> shift``
    for ``0 <= n < 2**31`` (Granlund and Montgomery, as PyTorch's
    ``IntDivider``); the kernel computes the same and checks them."""
    if not 1 <= d <= MAX_ELEMENTS:
        raise ValueError(f"divisor {d} outside 1..{MAX_ELEMENTS}")
    shift = (d - 1).bit_length()
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def snake_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x + sin²(alpha x) / (alpha + 1e-9)``
    (``esc_tpu/baselines/dac/layers.py:20``), alpha broadcast per
    channel."""
    return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)


@functools.lru_cache(maxsize=None)
def _launch_args(rows: int, T: int, C: int, num_sms: int):
    """The entry point's plan array: n, T, C, :func:`launch_plan`'s fields
    and the magic numbers of the divisions by T and by C."""
    p = launch_plan(rows, T, num_sms)
    return (ctypes.c_uint32 * 11)(rows * T, T, C, p.threads, p.unroll,
                                  p.grid, p.per_block, *divider(T),
                                  *divider(C))


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake of ``x`` ``(B, C, T)`` with ``alpha`` ``(1, C, 1)`` (see
    :func:`snake_plain`).

    A CUDA tensor goes through the CUDA kernel: float32, contiguous, outside
    autograd (the kernel has no backward). A CPU tensor goes through
    :func:`snake_plain`.
    """
    dev = x.device
    if dev.type == "cpu":
        return snake_plain(x, alpha)
    if dev.type != "cuda" or alpha.device != dev:
        raise ValueError("x and alpha must lie on one CUDA device")
    if x.dtype is not torch.float32 or alpha.dtype is not torch.float32:
        raise TypeError(f"float32 expected, got {x.dtype} and {alpha.dtype}")
    if x.dim() != 3 or alpha.shape != (1, x.shape[1], 1):
        raise ValueError(f"x (B, C, T) and alpha (1, C, 1) expected, got "
                         f"{tuple(x.shape)} and {tuple(alpha.shape)}")
    if not (x.is_contiguous() and alpha.is_contiguous()):
        raise ValueError("x and alpha must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad):
        raise RuntimeError("snake has no backward: call it under "
                           "torch.no_grad()")
    B, C, T = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    args = _launch_args(B * C, T, C, _build.num_sms(dev.index))
    fn = _build.function("esc_snake")
    with _build.on_device(dev):
        _build.check(fn(x.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                        args, _build.stream_of(dev)), "snake")
    snake.launches += 1
    return out


snake.launches = 0
