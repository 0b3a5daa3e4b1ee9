"""The ESC codec: ``ESCModule`` (an ``nn.Module``) and the ``ESC`` facade.

Port of ``esc_tpu/models/codecs.py`` for ESC (``csvq+swinT``) at
inference (reference: esc/models/codecs.py:9-94):

    model = ESC(**config, device="cuda")     # seeded random init
    codes, feat_shape = model.encode(x, num_streams=6)
    recon = model.decode(codes, feat_shape)

Parameter names are the reference's torch keys, so one state dict serves
weights carried from the JAX package (:func:`esc_tpu_torch.convert.
from_jax_params`) and reference checkpoints.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ..device import resolve_device
from ..io import esc_pad_length
from ..modules.transformer import WindowAttention
from ..modules.vq import Codebook, ProductVectorQuantize
from ..ops.stft import audio_reconstruct, spec_transform
from .base import Encoder, max_bps
from .csrvq import CrossScaleRVQDecoder

__all__ = ["ESCModule", "ESC", "make_model"]


class ESCModule(nn.Module):
    """Efficient Speech Codec, transformer backbone."""

    def __init__(self, in_dim: int = 2, in_freq: int = 192,
                 h_dims: Sequence[int] = (45, 72, 96, 144, 192, 384),
                 max_streams: int = 6, win_len: int = 20, hop_len: int = 5,
                 sr: int = 16000, patch_size: Sequence[int] = (3, 2),
                 swin_heads: Sequence[int] = (3, 6, 12, 24, 24),
                 swin_depth: int = 2, window_size: int = 4,
                 mlp_ratio: float = 4.0, overlap: int = 2,
                 group_size: int = 3, codebook_size: int = 1024,
                 codebook_dims: Sequence[int] = (8, 8, 8, 8, 8, 8),
                 l2norm: bool = True, backbone: str = "transformer"):
        super().__init__()
        if backbone != "transformer":
            raise NotImplementedError(
                f"backbone {backbone!r}: the port runs the transformer "
                "backbone only")
        self.in_freq, self.win_len, self.hop_len, self.sr = (
            in_freq, win_len, hop_len, sr)
        self.patch_size = tuple(patch_size)
        self.max_streams, self.overlap = max_streams, overlap
        self.group_size, self.codebook_size = group_size, codebook_size
        h = list(h_dims)
        dec_h = h[::-1]
        H = in_freq // patch_size[0]
        # scale i quantizes the residual entering decoder block i - 1;
        # scales 0 and 1 both sit at the bottom of the decoder
        self.quantizers = nn.ModuleList([
            ProductVectorQuantize(
                dec_h[max(i - 1, 0)], H // 2 ** (max_streams - max(i, 1)),
                overlap, group_size, codebook_dims[i], codebook_size, l2norm)
            for i in range(max_streams)])
        self.encoder = Encoder(in_dim, h, patch_size, swin_heads, swin_depth,
                               window_size, mlp_ratio)
        self.decoder = CrossScaleRVQDecoder(in_freq, in_dim, dec_h,
                                            patch_size, list(swin_heads)[::-1],
                                            swin_depth, window_size,
                                            mlp_ratio)

    def encode(self, x: torch.Tensor, num_streams: int) -> torch.Tensor:
        """Waveform ``(B, L)`` -> codes ``(B, num_streams, groups, T)``."""
        feat = spec_transform(x, self.in_freq, self.win_len, self.hop_len,
                              self.sr)
        enc_hs, feat_shape = self.encoder(feat)
        return self.decoder.encode(enc_hs, num_streams, self.quantizers,
                                   feat_shape)

    def decode(self, codes: torch.Tensor, feat_shape: Tuple[int, int]
               ) -> torch.Tensor:
        """Codes -> waveform ``(B, (T-1)*hop)``."""
        feat = self.decoder.decode(codes, self.quantizers, feat_shape)
        return audio_reconstruct(feat, self.in_freq, self.win_len,
                                 self.hop_len, self.sr)


@torch.no_grad()
def _init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init, drawn on the CPU so a seed gives the same
    weights on every machine: LeCun-normal linear and conv weights (flax's
    default), zero biases, unit LayerNorm scales, 0.02-std relative
    position tables and Kaiming-normal codebooks (as in esc_tpu)."""
    def randn(t):
        return torch.randn(t.shape, generator=generator, dtype=torch.float32)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(randn(m.weight) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, WindowAttention):
            t = m.relative_position_bias_table
            t.copy_((0.02 * randn(t)).clamp(-0.04, 0.04))
        elif isinstance(m, Codebook):
            w = m.embedding.weight
            w.copy_(randn(w) * math.sqrt(2.0 / w.shape[1]))


class ESC:
    """Stateful facade around :class:`ESCModule`: owns the device and the
    weights and takes numpy arrays or tensors.

    ``plain_ops=True`` runs the plain PyTorch versions of the kernels on
    any device, as the yardstick the kernels are held to.
    """

    def __init__(self, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 plain_ops: bool = False, **config):
        self.config = dict(config)
        self.device = resolve_device(device)
        self.module = ESCModule(**config)
        _init_parameters(self.module, torch.Generator().manual_seed(seed))
        for m in self.module.modules():
            if isinstance(m, (WindowAttention, Codebook)):
                m.plain_ops = plain_ops
        self.module.to(self.device).eval()

    # -- weights ----------------------------------------------------------

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        """Load torch-key weights; the reference's
        ``relative_position_index`` buffers are rebuilt, not loaded."""
        sd = {k: torch.as_tensor(v) for k, v in state_dict.items()
              if not k.endswith("relative_position_index")}
        return self.module.load_state_dict(sd, strict=strict)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    # -- geometry ---------------------------------------------------------

    @property
    def max_streams(self) -> int:
        return self.module.max_streams

    @property
    def max_bps(self) -> float:
        m = self.module
        return max_bps(m.overlap, m.max_streams, m.codebook_size,
                       m.group_size, m.patch_size[1])

    def _hop(self) -> int:
        return int(self.module.hop_len * self.module.sr * 1e-3)

    def feat_shape(self, audio_len: int) -> Tuple[int, int]:
        """Bottom-scale token grid ``(H, W)`` for an input length."""
        patch = self.module.patch_size
        H = self.module.in_freq // patch[0]
        for _ in range(self.max_streams - 1):
            H = (H + 1) // 2
        return H, (audio_len // self._hop() + 1) // patch[1]

    def pad_length(self, n: int) -> int:
        """Smallest grid-exact input length >= n."""
        return esc_pad_length(n, self._hop(), self.module.patch_size[1])

    # -- serving ----------------------------------------------------------

    def _check_streams(self, num_streams: int) -> None:
        if not 1 <= num_streams <= self.max_streams:
            raise ValueError(
                f"num_streams must be in 1..{self.max_streams} "
                f"(got {num_streams}); bitrate = num_streams * 1.5 kbps")

    def _audio(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        x = x.to(self.device, torch.float32)
        return x[None] if x.dim() == 1 else x

    @torch.no_grad()
    def encode(self, x, num_streams: int = 6
               ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """Waveform ``(B, L)`` -> (int32 codes ``(B, s, groups, T)`` on the
        device, feat_shape)."""
        self._check_streams(num_streams)
        x = self._audio(x)
        return self.module.encode(x, num_streams), self.feat_shape(x.shape[-1])

    @torch.no_grad()
    def decode(self, codes, feat_shape: Tuple[int, int]) -> torch.Tensor:
        """(codes, feat_shape) -> waveform ``(B, L)`` on the device."""
        if not isinstance(codes, torch.Tensor):
            codes = torch.from_numpy(np.array(codes))
        codes = codes.to(self.device)
        return self.module.decode(codes, tuple(feat_shape))

    def roundtrip(self, x, num_streams: int = 6):
        """Waveform -> (codes, feat_shape, reconstruction)."""
        codes, fs = self.encode(x, num_streams)
        return codes, fs, self.decode(codes, fs)


def make_model(model_config, model_name: str = "csvq+swinT", seed: int = 0,
               device: Optional[Union[str, torch.device]] = None,
               plain_ops: bool = False) -> ESC:
    """Build a codec from a config dict (esc/models/codecs.py:190). The port
    serves ``csvq+swinT``; the other reference names raise."""
    if model_name != "csvq+swinT":
        raise NotImplementedError(
            f"{model_name!r}: the port serves 'csvq+swinT' only")
    cfg = model_config if isinstance(model_config, dict) \
        else vars(model_config)
    cfg = _normalize_config(dict(cfg))
    return ESC(seed=seed, device=device, plain_ops=plain_ops, **cfg)


def _normalize_config(cfg: dict) -> dict:
    """Fix the reference configs' quirks for ``csvq`` models: a scalar
    ``codebook_dim`` becomes per-scale ``codebook_dims``; ``num_rvqs`` is
    dropped (``esc_tpu/models/codecs.py:_normalize_config``)."""
    if "codebook_dim" in cfg and "codebook_dims" not in cfg:
        d = cfg.pop("codebook_dim")
        n = cfg.get("max_streams", 6)
        cfg["codebook_dims"] = [d] * n if isinstance(d, int) else list(d)
    cfg.pop("num_rvqs", None)
    return cfg
