"""The codecs: ``ESCModule`` and ``RVQModule`` (``nn.Module`` s) behind the
``ESC`` and ``RVQCodecs`` facades.

Port of ``esc_tpu/models/codecs.py`` (reference: esc/models/codecs.py):
ESC (cross-scale product VQ) and the ablation codecs' bottleneck
product-residual VQ, each on the Swin transformer or the convolution
backbone, as the four names of :data:`model_dict`:

    model = make_model(config, "rvq+conv", device="cuda")  # seeded init
    codes, feat_shape = model.encode(x, num_streams=6)
    recon = model.decode(codes, feat_shape)
    out = model(x, num_streams=6)            # the eval forward's dict

The modules' ``forward`` is the full forward; in training mode
(``module.train()``) it runs the kernels' plain versions and returns the
straight-through losses, as the JAX package trains. The convolution
backbone does not train, as in the JAX package (see
:func:`esc_tpu_torch.modules.convolution.refuse_training`).

``dtype=torch.bfloat16`` is the bf16 serving mode (``esc_tpu/models/
codecs.py:304-339``): parameters stay float32; the Swin blocks' Linear
layers (attention qkv and proj, the MLP) run in bf16 with fp32
accumulation, as the JAX package's ``nn.Dense(dtype=bf16)`` layers do; the
attention kernel takes the bf16 qkv and returns fp32 (rounded back to bf16
before ``proj``); the convolution backbone's convolutions run in bf16 and
their outputs widen to fp32 before BatchNorm, as the JAX package's
``nn.Conv(dtype=bf16)`` ahead of a float32 BatchNorm; LayerNorm, the patch
layers, the VQ distances and the STFT / ISTFT stay float32.
``encode_chunked`` / ``decode_chunked`` serve long files in constant
memory.

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
from ..modules.convolution import Convolution2D, refuse_training
from ..modules.scale import LayerNorm
from ..modules.transformer import FeedForward, WindowAttention
from ..modules.vq import (Codebook, ProductResidualVectorQuantize,
                          ProductVectorQuantize)
from ..ops.stft import audio_reconstruct, spec_transform
from ..utils.graphs import StageGraphs, stage
from ..utils.profiling import annotate
from .base import Decoder, Encoder, max_bps
from .csrvq import CrossScaleRVQDecoder

__all__ = ["ESCModule", "RVQModule", "Codec", "ESC", "RVQCodecs",
           "model_dict", "make_model"]

# reference state-dict keys that hold no weight of the port's modules, as
# esc_tpu's converter ignores them (esc_tpu/convert.py:172-173): the
# torchaudio STFT transforms at the top of the reference's module, and
# buffers anywhere
IGNORED_PREFIXES = ("ft.", "ift.")
IGNORED_PARTS = ("relative_position_index", "num_batches_tracked",
                 "mel_transf")


def _stft(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The codec module's spectrum of the waveform ``x``."""
    return stage("codec.stft", spec_transform, x, module.in_freq,
                 module.win_len, module.hop_len, module.sr)


def _istft(module: nn.Module, feat: torch.Tensor) -> torch.Tensor:
    """The codec module's waveform of the spectrum ``feat``."""
    return stage("codec.istft", audio_reconstruct, feat, module.in_freq,
                 module.win_len, module.hop_len, module.sr)


class ESCModule(nn.Module):
    """Efficient Speech Codec: product VQs at every decoder scale."""

    def __init__(self, in_dim: int = 2, in_freq: int = 192,
                 h_dims: Sequence[int] = (45, 72, 96, 144, 192, 384),
                 max_streams: int = 6, win_len: int = 20, hop_len: int = 5,
                 sr: int = 16000, patch_size: Sequence[int] = (3, 2),
                 swin_heads: Sequence[int] = (3, 6, 12, 24, 24),
                 swin_depth: int = 2, window_size: int = 4,
                 mlp_ratio: float = 4.0, overlap: int = 2,
                 group_size: int = 3, codebook_size: int = 1024,
                 codebook_dims: Sequence[int] = (8, 8, 8, 8, 8, 8),
                 l2norm: bool = True, backbone: str = "transformer",
                 kernel_size: Sequence[int] = (5, 2), conv_depth: int = 1):
        super().__init__()
        self.backbone = backbone
        self.in_freq, self.win_len, self.hop_len, self.sr = (
            in_freq, win_len, hop_len, sr)
        self.patch_size = tuple(patch_size)
        self.max_streams, self.overlap = max_streams, overlap
        self.window_size = window_size
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
                               window_size, mlp_ratio, backbone, kernel_size,
                               conv_depth)
        self.decoder = CrossScaleRVQDecoder(in_freq, in_dim, dec_h,
                                            patch_size, list(swin_heads)[::-1],
                                            swin_depth, window_size,
                                            mlp_ratio, backbone, kernel_size,
                                            conv_depth)

    def forward(self, x: torch.Tensor, num_streams: int = 6,
                freeze_codebook: bool = False) -> dict:
        """Full forward (esc/models/codecs.py:30-66): the reference output
        dict with per-sample ``(B,)`` losses. ``freeze_codebook`` (the
        pretraining stage) runs every scale with the quantizers bypassed."""
        if self.training and self.backbone == "convolution":
            refuse_training()
        if freeze_codebook:
            num_streams = self.max_streams
        x_feat = _stft(self, x)
        enc_hs, feat_shape = self.encoder(x_feat)
        recon_feat, codes, cm_loss, cb_loss = self.decoder(
            enc_hs, num_streams, self.quantizers, feat_shape,
            freeze_vq=freeze_codebook)
        recon_x = _istft(self, recon_feat)
        return {"cm_loss": cm_loss, "cb_loss": cb_loss, "raw_audio": x,
                "recon_audio": recon_x, "raw_feat": x_feat,
                "recon_feat": recon_feat, "codes": codes}

    def encode(self, x: torch.Tensor, num_streams: int) -> torch.Tensor:
        """Waveform ``(B, L)`` -> codes ``(B, num_streams, groups, T)``."""
        enc_hs, feat_shape = self.encoder(_stft(self, x))
        return self.decoder.encode(enc_hs, num_streams, self.quantizers,
                                   feat_shape)

    def decode(self, codes: torch.Tensor, feat_shape: Tuple[int, int]
               ) -> torch.Tensor:
        """Codes -> waveform ``(B, (T-1)*hop)``."""
        return _istft(self, self.decoder.decode(codes, self.quantizers,
                                               feat_shape))


class RVQModule(nn.Module):
    """The RVQ ablation codec (esc/models/codecs.py:96-181): the encoder,
    one product-residual VQ at its bottom, and the plain mirror decoder."""

    def __init__(self, in_dim: int = 2, in_freq: int = 192,
                 h_dims: Sequence[int] = (45, 72, 96, 144, 192, 384),
                 max_streams: int = 6, backbone: str = "transformer",
                 kernel_size: Sequence[int] = (5, 2), conv_depth: int = 1,
                 patch_size: Sequence[int] = (3, 2),
                 swin_heads: Sequence[int] = (3, 6, 12, 24, 24),
                 swin_depth: int = 2, window_size: int = 4,
                 mlp_ratio: float = 4.0, overlap: int = 2,
                 num_rvqs: int = 6, group_size: int = 3,
                 codebook_dim: int = 8, codebook_size: int = 1024,
                 l2norm: bool = True, win_len: int = 20, hop_len: int = 5,
                 sr: int = 16000):
        super().__init__()
        self.backbone = backbone
        self.in_freq, self.win_len, self.hop_len, self.sr = (
            in_freq, win_len, hop_len, sr)
        self.patch_size = tuple(patch_size)
        self.max_streams, self.overlap = max_streams, overlap
        self.window_size = window_size
        self.group_size, self.codebook_size = group_size, codebook_size
        h = list(h_dims)
        dec_h = h[::-1]
        H = in_freq // patch_size[0]
        self.quantizers = ProductResidualVectorQuantize(
            dec_h[0], H // 2 ** (max_streams - 1), overlap, group_size,
            num_rvqs, codebook_dim, codebook_size, l2norm)
        self.encoder = Encoder(in_dim, h, patch_size, swin_heads, swin_depth,
                               window_size, mlp_ratio, backbone, kernel_size,
                               conv_depth)
        self.decoder = Decoder(in_freq, in_dim, dec_h, patch_size,
                               list(swin_heads)[::-1], swin_depth,
                               window_size, mlp_ratio, backbone, kernel_size,
                               conv_depth)

    def forward(self, x: torch.Tensor, num_streams: int = 6,
                freeze_codebook: bool = False) -> dict:
        """Full forward (esc/models/codecs.py:123-150), the output dict of
        :meth:`ESCModule.forward`. At inference every residual stage adds
        to the latent whatever ``num_streams`` is, as in the JAX package;
        in training the stages past it are masked."""
        if self.training and self.backbone == "convolution":
            refuse_training()
        x_feat = _stft(self, x)
        enc_hs, feat_shape = self.encoder(x_feat)
        out = stage("vq.s0", lambda: self.quantizers(
            enc_hs[-1], num_streams, freeze_vq=freeze_codebook))
        recon_feat = self.decoder(out["z_q"], feat_shape)
        recon_x = _istft(self, recon_feat)
        return {"cm_loss": out["cm_loss"], "cb_loss": out["cb_loss"],
                "raw_audio": x, "recon_audio": recon_x, "raw_feat": x_feat,
                "recon_feat": recon_feat, "codes": out["codes"]}

    def encode(self, x: torch.Tensor, num_streams: int) -> torch.Tensor:
        """Waveform ``(B, L)`` -> codes ``(B, num_streams, groups, T)``."""
        enc_hs, _ = self.encoder(_stft(self, x))
        return stage("vq.s0", lambda: self.quantizers.encode(enc_hs[-1],
                                                             num_streams))

    def decode(self, codes: torch.Tensor, feat_shape: Tuple[int, int]
               ) -> torch.Tensor:
        """Codes -> waveform ``(B, (T-1)*hop)``."""
        z_q = stage("vq.s0", self.quantizers.decode, codes,
                    self.decoder.latent_dims)
        return _istft(self, self.decoder(z_q, feat_shape))


@torch.no_grad()
def _init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init, drawn on the CPU so a seed gives the same
    weights on every machine: LeCun-normal linear and conv weights (flax's
    default), zero biases, unit LayerNorm scales, 0.02-std relative
    position tables and Kaiming-normal codebooks (as in esc_tpu)."""
    def randn(t):
        return torch.randn(t.shape, generator=generator, dtype=torch.float32)

    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
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


class Codec:
    """Stateful facade around a codec module (``module_cls``): owns the
    device and the weights and takes numpy arrays or tensors.

    ``plain_ops=True`` runs the plain PyTorch versions of the kernels on
    any device, as the yardstick the kernels are held to. ``dtype`` is the
    compute dtype of the Swin blocks' Linear layers and of the convolution
    backbone's convolutions (float32, or bfloat16 for the bf16 serving
    mode; see the module docstring).

    On a CUDA device, with the kernels and in eval mode, :meth:`encode`
    and :meth:`decode` replay a repeated call (the same shapes, streams
    and dtype) as one captured CUDA graph per stage
    (:mod:`esc_tpu_torch.utils.graphs`): a call's first run is eager, its
    second runs eagerly and captures, the later ones replay.
    """

    module_cls: type = None           # the subclass's codec module

    def __init__(self, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 plain_ops: bool = False,
                 dtype: Union[str, torch.dtype] = torch.float32, **config):
        self.config = dict(config)
        self.device = resolve_device(device)
        self.dtype = _compute_dtype(dtype)
        self.plain_ops = plain_ops
        self.module = self.module_cls(**config)
        _init_parameters(self.module, torch.Generator().manual_seed(seed))
        for m in self.module.modules():
            if isinstance(m, (WindowAttention, Codebook, LayerNorm)):
                m.plain_ops = plain_ops
            if isinstance(m, (WindowAttention, FeedForward, Convolution2D)):
                m.compute_dtype = self.dtype
        self.module.to(self.device).eval()

    # -- weights ----------------------------------------------------------

    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        """Load torch-key weights. The keys of :data:`IGNORED_PREFIXES`
        and :data:`IGNORED_PARTS` that the module does not hold are dropped:
        the reference's ``relative_position_index`` buffers (rebuilt here),
        its torchaudio STFT windows ``ft.window`` / ``ift.window``
        (constants here), its mel transforms, and ``num_batches_tracked``
        where no BatchNorm takes it. Every other key loads strictly."""
        own = self.module.state_dict()
        sd = {k: torch.as_tensor(v) for k, v in state_dict.items()
              if k in own or not (k.startswith(IGNORED_PREFIXES) or any(
                  part in k for part in IGNORED_PARTS))}
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
        """Bottom-scale grid ``(H, W)`` for an input length: the Swin
        layers halve H rounding up, the convolutions rounding down."""
        patch = self.module.patch_size
        H = self.module.in_freq // patch[0]
        up = self.module.backbone == "transformer"
        for _ in range(self.max_streams - 1):
            H = (H + 1) // 2 if up else H // 2
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

    def _audio(self, x, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """The waveform ``x`` as float32 ``(B, L)`` on the device, or
        copied into ``out``."""
        with annotate("codec.upload"):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x, np.float32))
            x = x[None] if x.dim() == 1 else x
            return x.to(self.device, torch.float32) if out is None \
                else out.copy_(x)

    def _codes(self, codes: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``codes`` on the device, or copied into ``out``."""
        with annotate("codec.upload"):
            return codes.to(self.device) if out is None else out.copy_(codes)

    def _graphs(self) -> Optional[StageGraphs]:
        """The stage graphs of this codec's module where its calls may
        replay them (a CUDA device, the kernels, eval mode), else None."""
        if (self.device.type != "cuda" or self.plain_ops
                or self.module.training):
            return None
        graphs = self.__dict__.get("_stage_graphs")
        if graphs is None or graphs.module is not self.module:
            graphs = self._stage_graphs = StageGraphs(self.module,
                                                      self.device)
        return graphs

    @torch.no_grad()
    def encode(self, x, num_streams: int = 6
               ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """Waveform ``(B, L)`` -> (int32 codes ``(B, s, groups, T)`` on the
        device, feat_shape)."""
        with annotate("codec.encode"):
            self._check_streams(num_streams)
            graphs = self._graphs()
            if graphs is None:
                x = self._audio(x)
                return (self.module.encode(x, num_streams),
                        self.feat_shape(x.shape[-1]))
            shape = tuple(np.shape(x))
            shape = (1,) + shape if len(shape) == 1 else shape
            codes = graphs.call(
                ("encode", shape, num_streams, self.dtype), shape,
                torch.float32, lambda out: self._audio(x, out),
                lambda x: self.module.encode(x, num_streams))
            return codes, self.feat_shape(shape[-1])

    @torch.no_grad()
    def decode(self, codes, feat_shape: Tuple[int, int]) -> torch.Tensor:
        """(codes, feat_shape) -> waveform ``(B, L)`` on the device."""
        with annotate("codec.decode"):
            if not isinstance(codes, torch.Tensor):
                codes = torch.from_numpy(np.array(codes))
            feat_shape = tuple(feat_shape)
            graphs = self._graphs()
            if graphs is None:
                return self.module.decode(self._codes(codes), feat_shape)
            shape = tuple(codes.shape)
            return graphs.call(
                ("decode", shape, codes.dtype, feat_shape, self.dtype), shape,
                codes.dtype, lambda out: self._codes(codes, out),
                lambda codes: self.module.decode(codes, feat_shape))

    def roundtrip(self, x, num_streams: int = 6):
        """Waveform -> (codes, feat_shape, reconstruction)."""
        codes, fs = self.encode(x, num_streams)
        return codes, fs, self.decode(codes, fs)

    @torch.no_grad()
    def __call__(self, x, num_streams: int = 6,
                 freeze_codebook: bool = False) -> dict:
        """Eval-mode forward (``esc_tpu/models/codecs.py:403``): the
        reference output dict, on the device. It runs the same encoder,
        product VQs and decoder as :meth:`encode` and :meth:`decode`, so on
        the card both kernels. (The JAX package's ``x_feat``, a spectrum in
        place of the waveform, has no caller and is not ported.)"""
        self._check_streams(num_streams)
        if self.module.training:
            raise RuntimeError("the eval forward needs module.eval()")
        return self.module(self._audio(x), num_streams, freeze_codebook)

    def print_codec(self) -> None:
        """Each scale's quantizer geometry, from the bottom up
        (esc/models/base.py:86-107); the bottom one of an RVQ codec."""
        m = self.module
        if isinstance(m, RVQModule):
            q = m.quantizers
            print("Codec Visualization [only at bottom]")
            print("     Freq dim:                ", q.in_freq)
            print("     Channel(hidden) dim:     ", q.fix_dim // q.in_freq)
            print("     Reshaped hidden dim:     ", q.fix_dim)
            print("     Codebook dim:            ", q.codebook_dim)
            return
        freqs = [q.in_freq for q in m.quantizers]
        dims = [q.fix_dim // q.in_freq for q in m.quantizers]
        print("Codec Visualization [from bottom to top]: ")
        print("     Freq dims:                ", freqs)
        print("     Channel(hidden) dims:     ", dims)
        print("     Reshaped hidden dims:     ",
              [f * d for f, d in zip(freqs, dims)])
        print("     Codebook dims:            ",
              [q.vqs[0].embedding.weight.shape[1] for q in m.quantizers])

    # -- long files (constant memory) --------------------------------------

    def _samples_per_code(self) -> int:
        m = self.module
        return self._hop() * m.patch_size[1] * m.overlap  # 320 for ESC-Base

    def _chunking(self, chunk_seconds: float, margin_seconds: float
                  ) -> Tuple[int, int]:
        """Chunk and margin in code frames, both multiples of
        ``window_size // overlap`` so that every chunk keeps the Swin window
        grid of the whole file (DESIGN.md section 8)."""
        m, spc = self.module, self._samples_per_code()
        align = max(1, m.window_size // m.overlap)
        chunk = max(align, (int(chunk_seconds * m.sr) // spc)
                    // align * align)
        margin = max(align, -(-int(margin_seconds * m.sr) // spc)
                     // align * align)
        return chunk, margin

    def encode_chunked(self, x, num_streams: int = 6,
                       chunk_seconds: float = 10.0,
                       margin_seconds: float = 1.0
                       ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """Encode a long file chunk by chunk, each with ``margin_seconds``
        of context on both sides, keeping the chunk's own codes
        (``esc_tpu/models/codecs.py:441``). Codes equal the whole file's
        away from the seams. Returns (codes on the device, feat_shape of
        the whole file). Two chunks are in flight (:mod:`..serving`)."""
        from ..serving import stream_map

        self._check_streams(num_streams)
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        spc = self._samples_per_code()
        L = x.shape[-1]
        fs_full = self.feat_shape(L)
        total_codes = fs_full[1] // self.module.overlap
        chunk, margin = self._chunking(chunk_seconds, margin_seconds)
        if total_codes <= chunk:
            return self.encode(x, num_streams)
        # the last center-padded STFT frame makes the whole file's codes
        # cover total_codes * spc samples: zero-fill the tail
        need = total_codes * spc
        if need > L:
            x = np.pad(x, ((0, 0), (0, need - L)))
        metas, segs = [], []
        for start in range(0, total_codes, chunk):
            end = min(start + chunk, total_codes)
            lo, hi = max(0, start - margin), min(total_codes, end + margin)
            metas.append((start, lo, end))
            segs.append(x[:, lo * spc:hi * spc])
        pieces = [c[..., start - lo:end - lo] for (start, lo, end), c in zip(
            metas, stream_map(lambda s: self.encode(s, num_streams)[0], segs,
                              depth=2, device=self.device))]
        codes = torch.from_numpy(np.concatenate(pieces, axis=-1))
        return codes.to(self.device), fs_full

    def decode_chunked(self, codes, feat_shape: Tuple[int, int],
                       chunk_seconds: float = 10.0,
                       margin_seconds: float = 1.0,
                       crossfade: int = 160) -> torch.Tensor:
        """Decode chunk by chunk, the inverse of :meth:`encode_chunked`
        (``esc_tpu/models/codecs.py:498``): each chunk with margins, the
        seams joined by a linear crossfade of ``crossfade`` samples, the
        result padded to the whole file's ``(W * patch_t - 1) * hop``
        samples. Returns the waveform on the device."""
        from ..serving import stream_map

        if isinstance(codes, torch.Tensor):
            codes = codes.cpu().numpy()
        codes = np.asarray(codes)
        spc = self._samples_per_code()
        total_codes = codes.shape[-1]
        chunk, margin = self._chunking(chunk_seconds, margin_seconds)
        if total_codes <= chunk:
            return self.decode(codes, feat_shape)
        H, overlap = feat_shape[0], self.module.overlap
        metas, segs = [], []
        for start in range(0, total_codes, chunk):
            end = min(start + chunk, total_codes)
            lo, hi = max(0, start - margin), min(total_codes, end + margin)
            metas.append((start, lo, end))
            segs.append(codes[..., lo:hi])
        out = None
        for (start, lo, end), y in zip(metas, stream_map(
                lambda c: self.decode(c, (H, c.shape[-1] * overlap)), segs,
                depth=2, device=self.device)):
            keep = y[:, (start - lo) * spc:(end - lo) * spc].copy()
            if out is None:
                out = keep
                continue
            xf = min(crossfade, keep.shape[-1], out.shape[-1])
            if xf > 0:
                # fade from the previous chunk into this chunk's decode of
                # the samples before its start (its left margin)
                tail = y[:, (start - lo) * spc - xf:(start - lo) * spc]
                w = np.linspace(0.0, 1.0, xf, dtype=np.float32)[None]
                out[:, -xf:] = out[:, -xf:] * (1 - w) + tail * w
            out = np.concatenate([out, keep], axis=-1)
        expected = (feat_shape[1] * self.module.patch_size[1] - 1) \
            * self._hop()
        if out.shape[-1] < expected:
            out = np.pad(out, ((0, 0), (0, expected - out.shape[-1])))
        return torch.from_numpy(out[:, :expected]).to(self.device)


def _compute_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    dt = names.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype!r}")
    return dt


class ESC(Codec):
    """Efficient Speech Codec (reference ESC, esc/models/codecs.py:9)."""

    module_cls = ESCModule


class RVQCodecs(Codec):
    """The RVQ ablation codec (reference RVQCodecs,
    esc/models/codecs.py:96)."""

    module_cls = RVQModule


model_dict = {
    "csvq+conv": ESC,
    "csvq+swinT": ESC,
    "rvq+conv": RVQCodecs,
    "rvq+swinT": RVQCodecs,
}


def make_model(model_config, model_name: str = "csvq+swinT", seed: int = 0,
               device: Optional[Union[str, torch.device]] = None,
               plain_ops: bool = False,
               dtype: Union[str, torch.dtype] = torch.float32) -> Codec:
    """Build a codec from a config dict (esc/models/codecs.py:190); an
    unknown ``model_name`` raises ``ValueError``."""
    if model_name not in model_dict:
        raise ValueError(f"{model_name!r} is not valid within "
                         f"[{', '.join(model_dict)}]")
    cfg = model_config if isinstance(model_config, dict) \
        else vars(model_config)
    cfg = _normalize_config(dict(cfg), model_name)
    return model_dict[model_name](seed=seed, device=device,
                                  plain_ops=plain_ops, dtype=dtype, **cfg)


def _normalize_config(cfg: dict, model_name: str) -> dict:
    """Fix the reference configs' quirks (``esc_tpu/models/codecs.py:
    _normalize_config``): ``csvq`` models take per-scale
    ``codebook_dims`` (a scalar ``codebook_dim`` repeated) and no
    ``num_rvqs``; ``rvq`` models take one ``codebook_dim`` (the first of
    ``codebook_dims``)."""
    if model_name.startswith("csvq"):
        if "codebook_dim" in cfg and "codebook_dims" not in cfg:
            d = cfg.pop("codebook_dim")
            n = cfg.get("max_streams", 6)
            cfg["codebook_dims"] = [d] * n if isinstance(d, int) else list(d)
        cfg.pop("num_rvqs", None)
    elif "codebook_dims" in cfg and "codebook_dim" not in cfg:
        d = cfg.pop("codebook_dims")
        cfg["codebook_dim"] = d[0] if isinstance(d, (list, tuple)) else d
    elif isinstance(cfg.get("codebook_dim"), (list, tuple)):
        cfg["codebook_dim"] = cfg["codebook_dim"][0]
    return cfg
