"""Fused window attention: CUDA kernel wrapper and its plain PyTorch version.

Port of ``esc_tpu/ops/pallas/attention_kernels.py::fused_window_attention``.
Per window g and head h of the qkv projection ``(G, N, 3C)``:
``softmax((q * scale) k^T + bias[h] + mask[g % nW]) v``, with fp32 scores
and softmax and an fp32 ``(G, N, C)`` output. The kernel is
``esc_tpu_torch/csrc/window_attention.cu``; it copies whole windows of the
projection into shared memory, so no split copies are made. Where one window
of all heads does not fit a block's shared memory, or a head is wider than
:data:`MAX_REGISTER_HEAD_DIM`, heads are split into groups across blocks, as
the TPU kernel does (``attention_kernels.py:47-58``). Its launch plan is
:func:`launch_plan`, a pure function of the shapes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import _build

__all__ = ["window_attention", "window_attention_plain", "launch_plan",
           "AttentionPlan", "WINDOW_TOKENS", "MAX_HEAD_DIM"]

WINDOW_TOKENS = 16  # 4 x 4 windows
MAX_HEAD_DIM = 256          # the grouped kernel's attend_wide
MAX_REGISTER_HEAD_DIM = 32  # the all-heads kernel (per-channel registers)
MAX_THREADS = 768         # the kernel's __launch_bounds__
MAX_BULK_BYTES = 1 << 20  # an mbarrier counts fewer transaction bytes
STAGE_BYTES = 32 * 1024   # aim for one tile's input
PAIRS_PER_TILE = 12       # aim for (window, head) pairs, one warp each
REGS_PER_THREAD = 80      # the most __launch_bounds__(768) leaves ptxas
BIAS_PITCH = WINDOW_TOKENS + 1
MASK_PITCH = 20
GROUP_STAGE_BYTES = 64 * 1024  # aim for one unit's input, grouped kernel


class AttentionPlan(NamedTuple):
    """How one call maps onto the card; checked again by the kernel.

    A tile is ``windows`` consecutive windows; ``grid`` persistent blocks of
    ``threads`` threads walk the tiles through a ring of ``stages`` input
    buffers whose rows are ``in_pitch`` bytes apart, each tile's output
    going through a buffer with rows of ``out_pitch`` floats.

    With ``heads > 0`` (the grouped kernel) a unit of work is a tile times a
    group of ``heads`` heads, ``groups`` groups per tile; the blocks walk
    ``tiles * groups`` units through one input buffer (``stages`` 1) and
    write the output straight to global memory (``out_pitch`` 0).
    ``heads == 0`` is the all-heads kernel, ``groups`` 1.
    """
    windows: int
    stages: int
    threads: int
    grid: int
    in_pitch: int
    out_pitch: int
    smem: int
    tiles: int
    row_bytes: int
    heads: int = 0
    groups: int = 1


def _smem(windows: int, stages: int, in_pitch: int, out_pitch: int,
          nh: int, masked: bool) -> int:
    # the kernel's smem_bytes: input ring, mask ring, two output buffers,
    # padded bias, one mbarrier per stage
    n = WINDOW_TOKENS
    mask = windows * n * MASK_PITCH * 4 if masked else 0
    return (stages * (windows * n * in_pitch + mask)
            + 2 * windows * n * out_pitch * 4 + nh * n * BIAS_PITCH * 4
            + 8 * stages)


def _grouped_smem(windows: int, threads: int, in_pitch: int, nh: int,
                  hd: int, masked: bool) -> int:
    # the kernel's grouped_smem_bytes: input buffer, mask buffer, padded
    # bias of every head, one probability tile per warp for wide heads
    n = WINDOW_TOKENS
    tile = n * BIAS_PITCH * 4
    return (windows * n * in_pitch
            + (windows * n * MASK_PITCH * 4 if masked else 0)
            + nh * tile
            + (threads // 32 * tile if hd > MAX_REGISTER_HEAD_DIM else 0))


def _group_pitch(heads: int, hd: int, elem: int) -> int:
    # a buffer row [q_g | k_g | v_g], padded to 16 bytes and off a multiple
    # of 128 (so that rows start on different banks)
    pitch = -(-3 * heads * hd * elem // 16) * 16
    return pitch + 16 if pitch % 128 == 0 else pitch


def _grouped_plan(G: int, nh: int, hd: int, bf16: bool, masked: bool,
                  num_sms: int) -> AttentionPlan:
    n = WINDOW_TOKENS
    elem = 2 if bf16 else 4
    heads = max(1, min(nh, GROUP_STAGE_BYTES
                       // (n * _group_pitch(1, hd, elem))))
    while True:
        heads = -(-nh // -(-nh // heads))  # groups of one size where it can
        in_pitch = _group_pitch(heads, hd, elem)
        windows = max(1, min(G, PAIRS_PER_TILE // heads,
                             GROUP_STAGE_BYTES // (n * in_pitch)))
        threads = 32 * min(windows * heads, MAX_THREADS // 32)
        smem = _grouped_smem(windows, threads, in_pitch, nh, hd, masked)
        if smem <= _build.MAX_SMEM_PER_BLOCK:
            break
        if heads == 1:
            raise ValueError(f"window attention: {nh} heads x {hd} channels "
                             "need more shared memory than a block has")
        heads -= 1
    groups = -(-nh // heads)
    tiles = -(-G // windows)
    per_sm = min(_build.SMEM_PER_SM
                 // (smem + _build.SMEM_RESERVED_PER_BLOCK),
                 2048 // threads, 65536 // (threads * REGS_PER_THREAD))
    grid = min(tiles * groups, num_sms * max(1, per_sm))
    return AttentionPlan(windows, 1, threads, grid, in_pitch, 0, smem, tiles,
                         3 * nh * hd * elem, heads, groups)


@functools.lru_cache(maxsize=None)
def launch_plan(G: int, nh: int, hd: int, bf16: bool, masked: bool,
                num_sms: int) -> AttentionPlan:
    """The kernel's launch plan for ``G`` windows of ``nh`` heads of width
    ``hd`` (with a mask or not) on a card of ``num_sms`` SMs.

    A row of 3C elements that spans a multiple of 128 bytes is padded by 16
    bytes in shared memory (and then copied row by row), so that rows start
    on different banks; so are output rows of a multiple of 8 floats,
    padded by 4 floats (and then stored row by row). A tile holds about
    :data:`PAIRS_PER_TILE` (window, head) pairs and at most
    :data:`STAGE_BYTES` of input where a window allows; two stages where
    shared memory allows, else one.

    Where not even one window of all heads fits that way, or ``hd`` exceeds
    :data:`MAX_REGISTER_HEAD_DIM`, the plan is the grouped kernel's
    (``heads > 0``): groups of equal size where ``nh`` allows, as many heads
    as about :data:`GROUP_STAGE_BYTES` of input hold. Raises ``ValueError``
    for ``hd`` outside 1..:data:`MAX_HEAD_DIM` and where not even one
    window of one head fits.
    """
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if hd > MAX_REGISTER_HEAD_DIM:
        return _grouped_plan(G, nh, hd, bf16, masked, num_sms)
    n = WINDOW_TOKENS
    C = nh * hd
    row_bytes = 3 * C * (2 if bf16 else 4)
    in_pitch = row_bytes + 16 if row_bytes % 128 == 0 else row_bytes
    out_pitch = C + 4 if C % 8 == 0 else C
    windows = max(1, min(PAIRS_PER_TILE // nh, G))
    while windows > 1 and windows * n * in_pitch > STAGE_BYTES:
        windows -= 1
    candidates = [(w, 2) for w in range(windows, 0, -1)] + [(1, 1)]
    for windows, stages in candidates:
        smem = _smem(windows, stages, in_pitch, out_pitch, nh, masked)
        if (smem <= _build.MAX_SMEM_PER_BLOCK
                and windows * n * (row_bytes + n * 4) < MAX_BULK_BYTES):
            break
    else:
        return _grouped_plan(G, nh, hd, bf16, masked, num_sms)
    threads = 32 * min(windows * nh, MAX_THREADS // 32)
    per_sm = min(_build.SMEM_PER_SM
                 // (smem + _build.SMEM_RESERVED_PER_BLOCK),
                 2048 // threads, 65536 // (threads * REGS_PER_THREAD))
    tiles = -(-G // windows)
    grid = min(tiles, num_sms * max(1, per_sm))
    return AttentionPlan(windows, stages, threads, grid, in_pitch, out_pitch,
                         smem, tiles, row_bytes)


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                           mask: Optional[torch.Tensor], num_heads: int,
                           scale: float) -> torch.Tensor:
    """Plain PyTorch version, the einsum path of
    ``esc_tpu/modules/transformer.py:249-263``.

    qkv ``(G, N, 3C)`` float32 or bfloat16; bias ``(nh, N, N)``; mask
    ``(nW, N, N)`` with ``G % nW == 0``, or None. Returns ``(G, N, C)``
    float32. bf16 inputs are multiplied exactly in fp32; the scaled q and
    the probabilities are rounded to bf16 first, as in the TPU kernel.
    """
    G, N, C3 = qkv.shape
    C = C3 // 3
    nh = num_heads
    hd = C // nh
    t = qkv.reshape(G, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = t[0], t[1], t[2]                       # (G, nh, N, hd)
    attn = torch.matmul((q * scale).float(), k.float().transpose(-2, -1))
    attn = attn + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.reshape(G // nW, nW, nh, N, N) + mask.float()[None, :, None]
        attn = attn.reshape(G, nh, N, N)
    attn = attn.softmax(-1)
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.transpose(1, 2).reshape(G, N, C)


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor], num_heads: int,
                     scale: float) -> torch.Tensor:
    """Window attention over the qkv projection (see
    :func:`window_attention_plain` for the contract).

    A CUDA tensor goes through the CUDA kernel; a CPU tensor through
    :func:`window_attention_plain`.
    """
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, bias, mask, num_heads, scale)
    dev = qkv.device
    if dev.type != "cuda" or bias.device != dev or (
            mask is not None and mask.device != dev):
        raise ValueError("qkv, bias and mask must lie on one CUDA device")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if bias.dtype != torch.float32 or (
            mask is not None and mask.dtype != torch.float32):
        raise TypeError("bias and mask must be float32")
    G, N, C3 = qkv.shape
    nh = num_heads
    C = C3 // 3
    hd = C // nh if nh > 0 else 0
    if N != WINDOW_TOKENS or C3 != 3 * C or C != nh * hd:
        raise ValueError(f"qkv (G, {WINDOW_TOKENS}, 3C) with C = heads * hd "
                         f"expected, got {tuple(qkv.shape)}, heads {nh}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} outside 1..{MAX_HEAD_DIM}")
    if tuple(bias.shape) != (nh, N, N):
        raise ValueError(f"bias {tuple(bias.shape)} != {(nh, N, N)}")
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (N, N)
                             or G % mask.shape[0]):
        raise ValueError(f"mask (nW, {N}, {N}) with G % nW == 0 expected, "
                         f"got {tuple(mask.shape)} for G = {G}")
    if not (qkv.is_contiguous() and bias.is_contiguous()
            and (mask is None or mask.is_contiguous())):
        raise ValueError("qkv, bias and mask must be contiguous")
    if qkv.data_ptr() % 16 or (mask is not None and mask.data_ptr() % 16):
        raise ValueError("qkv and mask must start on a 16-byte boundary: "
                         "the kernel copies them with bulk copies")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("window_attention has no backward: call it under "
                           "torch.no_grad()")
    bf16 = qkv.dtype == torch.bfloat16
    plan = launch_plan(G, nh, hd, bf16, mask is not None,
                       _build.num_sms(dev.index))
    out = torch.empty((G, N, C), dtype=torch.float32, device=dev)
    fn = _build.function("esc_window_attention")
    with _build.on_device(dev):
        _build.check(fn(
            qkv.data_ptr(), int(bf16), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            mask.shape[0] if mask is not None else 0, out.data_ptr(), G, nh,
            hd, float(scale), plan.windows, plan.stages, plan.threads,
            plan.grid, plan.in_pitch, plan.out_pitch, plan.smem, plan.heads,
            _build.stream_of(dev)), "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0
