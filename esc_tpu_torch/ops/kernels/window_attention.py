"""Fused window attention: CUDA kernel wrapper and its plain PyTorch version.

Port of ``esc_tpu/ops/pallas/attention_kernels.py::fused_window_attention``.
Per window g and head h of the qkv projection ``(G, N, 3C)``:
``softmax((q * scale) k^T + bias[h] + mask[g % nW]) v``, with fp32 scores
and softmax and an fp32 ``(G, N, C)`` output. The kernel is
``esc_tpu_torch/csrc/window_attention.cu``; it reads q, k and v straight
from the projection, so no split copies are made.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["window_attention", "window_attention_plain", "WINDOW_TOKENS",
           "MAX_HEAD_DIM"]

WINDOW_TOKENS = 16  # 4 x 4 windows
MAX_HEAD_DIM = 32


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
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("window_attention has no backward: call it under "
                           "torch.no_grad()")
    out = torch.empty((G, N, C), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.esc_window_attention(
            qkv.data_ptr(), int(qkv.dtype == torch.bfloat16), bias.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            mask.shape[0] if mask is not None else 0, out.data_ptr(), G, nh,
            hd, float(scale), stream), "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0
