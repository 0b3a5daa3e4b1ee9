"""Swin window-attention layers.

Port of ``esc_tpu/modules/transformer.py`` (reference:
esc/modules/transformer/attention.py). The SW-MSA mask and the relative
position index are functions of the static token grid, built once in numpy
and cached on the device. The attention between the qkv and output
projections is the fused window-attention kernel
(:mod:`esc_tpu_torch.ops.kernels.window_attention`).

The Linear layers of the attention and the MLP compute in their module's
``compute_dtype`` (set by the codec: float32, or bfloat16 in the bf16
serving mode) from float32 parameters, as the JAX package's
``nn.Dense(dtype=...)`` does; LayerNorm (the LayerNorm kernel,
:class:`esc_tpu_torch.modules.scale.LayerNorm`) and the residual stream stay
float32 (``esc_tpu/modules/transformer.py:180-280``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import window_attention, window_attention_plain
from ..ops.stft import frozen
from ..utils.graphs import capturing, hold
from .scale import LN_EPS, LayerNorm, PatchMerge, PatchSplit

__all__ = ["swin_attention_mask", "relative_position_index",
           "window_partition", "window_reverse", "WindowAttention",
           "FeedForward", "SwinBlock", "TransformerLayer"]


@functools.lru_cache(maxsize=128)
def swin_attention_mask(H: int, W: int, window: int, shift: int
                        ) -> np.ndarray:
    """Static SW-MSA mask ``(nW, window², window²)`` of 0 / -100."""
    Hp = -(-H // window) * window
    Wp = -(-W // window) * window
    img = np.zeros((Hp, Wp), dtype=np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(Hp // window, window, Wp // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = m[:, None, :] - m[:, :, None]
    return frozen(np.where(diff != 0, -100.0, 0.0).astype(np.float32))


@functools.lru_cache(maxsize=64)
def _mask_cached(H: int, W: int, window: int, shift: int,
                 device: torch.device) -> torch.Tensor:
    return torch.tensor(swin_attention_mask(H, W, window, shift),
                        device=device)


def _mask_on(H: int, W: int, window: int, shift: int,
             device: torch.device) -> torch.Tensor:
    """The SW-MSA mask on ``device``, uploaded once; a capturing chain of
    stage graphs keeps it (:func:`esc_tpu_torch.utils.graphs.hold`)."""
    return hold(_mask_cached(H, W, window, shift, device))


@functools.lru_cache(maxsize=16)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Static ``(N, N)`` index into the ``(2wh-1)(2ww-1)`` bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return frozen(rel.sum(-1))


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype
           ) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``: input, weight and bias cast to it
    (fp32 accumulation in bf16 products), the parameters kept as they are.
    Outside autograd the cast weight and bias are kept on the layer until
    the parameters change (a new version or storage), so that serving
    casts only activations; a graph being captured casts them itself, so
    that its replays follow the parameters."""
    if dtype == torch.float32 and x.dtype == torch.float32:
        return layer(x)
    w, b = layer.weight, layer.bias
    key = (dtype, w.data_ptr(), w._version,
           None if b is None else (b.data_ptr(), b._version))
    cast = getattr(layer, "_cast", None)
    fresh = torch.is_grad_enabled() or capturing()
    if cast is None or cast[0] != key or fresh:
        cast = (key, w.to(dtype), None if b is None else b.to(dtype))
        if not fresh:
            layer._cast = cast
    return F.linear(x.to(dtype), cast[1], cast[2])


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window, window, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C)


def window_reverse(windows: torch.Tensor, window: int, H: int, W: int
                   ) -> torch.Tensor:
    """(B*nW, window, window, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // (H * W // window // window)
    x = windows.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowAttention(nn.Module):
    """Multi-head attention inside 4x4 windows with a learned relative
    position bias.

    ``plain_ops`` (set by the codec) runs the plain PyTorch attention in
    place of the kernel, on any device: the yardstick the kernel is held to.
    Training mode runs it too, as the JAX package trains
    (``esc_tpu/modules/transformer.py:225``).
    ``compute_dtype`` (set by the codec) is the dtype of the projections.
    """

    plain_ops = False
    compute_dtype = torch.float32

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size = window_size
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.tensor(relative_position_index(window_size, window_size)),
            persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """x ``(B_, N, C)`` windows; mask ``(nW, N, N)`` or None."""
        N = x.shape[1]
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(N, N, -1)
        bias = bias.permute(2, 0, 1).contiguous()         # (nh, N, N)
        attend = window_attention_plain if self.plain_ops or self.training \
            else window_attention
        dt = self.compute_dtype
        out = attend(_linear(self.qkv, x, dt), bias, mask, self.num_heads,
                     self.scale)
        return _linear(self.proj, out.to(dt), dt)


class FeedForward(nn.Module):
    """Linear -> exact GELU -> Linear, in ``compute_dtype`` (set by the
    codec)."""

    compute_dtype = torch.float32

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear_1 = nn.Linear(dim, hidden)
        self.linear_2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return _linear(self.linear_2, F.gelu(_linear(self.linear_1, x, dt)),
                      dt)


class SwinBlock(nn.Module):
    """LN -> (shifted) window MSA -> residual -> LN -> MLP -> residual,
    with zero padding to whole windows after norm1 and a crop at the end."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 4,
                 shift_size: int = 0, mlp_ratio: float = 2.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = FeedForward(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        ws, ss = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        pad_b = (ws - H % ws) % ws
        pad_r = (ws - W % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if ss > 0:
            x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
            mask = _mask_on(H, W, ws, ss, x.device)
        windows = window_partition(x, ws).reshape(-1, ws * ws, C)
        attn = self.attn(windows, mask).reshape(-1, ws, ws, C)
        x = window_reverse(attn, ws, Hp, Wp)
        if ss > 0:
            x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :H, :W]
        x = shortcut + x.reshape(B, H * W, C)
        return x + self.mlp(self.norm2(x))


class TransformerLayer(nn.Module):
    """``depth`` SwinBlocks (alternating W-MSA / SW-MSA) and an optional
    PatchMerge (``scale="down"``) or PatchSplit (``scale="up"``) along H.

    Call protocol: ``(x, H, W) -> (x', H', W')``.
    """

    def __init__(self, in_dim: int, out_dim: int, num_heads: int,
                 depth: int = 2, window_size: int = 4,
                 mlp_ratio: float = 2.0, scale: Optional[str] = None):
        super().__init__()
        self.swint_blocks = nn.ModuleList([
            SwinBlock(in_dim, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio)
            for i in range(depth)])
        self.scale = scale
        if scale == "down":
            self.subsample = PatchMerge(in_dim, out_dim)
        elif scale == "up":
            self.subsample = PatchSplit(in_dim, out_dim)
        elif scale is not None:
            raise ValueError(f"scale must be None, 'down' or 'up': {scale!r}")

    def forward(self, x: torch.Tensor, H: int, W: int
                ) -> Tuple[torch.Tensor, int, int]:
        for blk in self.swint_blocks:
            x = blk(x, H, W)
        if self.scale == "down":
            return self.subsample(x, H), (H + 1) // 2, W
        if self.scale == "up":
            return self.subsample(x, H), H * 2, W
        return x, H, W
