"""DAC: snake-convolution encoder, residual VQ, transposed-convolution
decoder, and the windowed file codec (``DACFile``).

Port of ``esc_tpu/baselines/dac/model.py`` (reference:
baselines/descript/dac/model/{dac.py,base.py}) in NCW. Module and parameter
names are the reference's torch keys (``encoder.block.1.block.0.block.1.
weight_v``, ``quantizer.quantizers.0.codebook.weight``), so a reference
state dict loads with ``load_state_dict`` and a flax tree of the JAX
package through :func:`esc_tpu_torch.convert.from_jax_params`.

    dac = DAC(sample_rate=16000, encoder_rates=[2, 4, 5, 8], ...)
    out = dac(x)                              # the forward's dict
    f = dac.compress("in.wav"); f.save("out.dac")
    y = dac.decompress("out.dac")

Compression runs every convolution unpadded (VALID) over overlapping
windows, so that windows join without seams; the delay and the output
lengths come from the convolutions' specs (:func:`conv_specs`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ...device import resolve_device
from ...utils.profiling import annotate
from .layers import Snake1d, WNConv1d, WNConvTranspose1d, _WeightNorm
from .quantize import ResidualVectorQuantize, VectorQuantize

__all__ = ["DAC", "DACModule", "DACFile", "loudness_db", "normalize_db",
           "init_dac", "conv_specs", "output_length", "delay"]

SUPPORTED_VERSIONS = ["1.0.0"]


# ----------------------------------------------------------------- audio
def loudness_db(x: np.ndarray, sample_rate: int = 16000,
                block_s: float = 0.4, eps: float = 1e-12) -> float:
    """Gated block RMS loudness in dB (no K-weighting): the JAX package's
    stand-in for BS.1770 integrated loudness, the same on both sides of a
    compress / decompress."""
    x = np.asarray(x, np.float64).reshape(-1)
    n = max(1, int(block_s * sample_rate))
    hop = n // 4 or 1
    if len(x) < n:
        ms = np.mean(x ** 2)
        return float(10 * np.log10(ms + eps))
    blocks = np.lib.stride_tricks.sliding_window_view(x, n)[::hop]
    ms = np.mean(blocks ** 2, axis=1)
    keep = ms > 10 ** (-70 / 10)          # absolute gate at -70 dB
    ms_kept = ms[keep] if keep.any() else ms
    return float(10 * np.log10(ms_kept.mean() + eps))


def normalize_db(x: np.ndarray, target_db: float,
                 sample_rate: int = 16000) -> np.ndarray:
    """``x`` scaled so that its loudness measures ``target_db``."""
    cur = loudness_db(x, sample_rate)
    return x * (10 ** ((target_db - cur) / 20.0))


# ------------------------------------------------------------------ file
@dataclass
class DACFile:
    """The compressed file (base.py:15-54): uint16 codes and metadata in one
    ``np.save`` dict, suffix ``.dac``; the JAX package's files and the
    port's are the same."""

    codes: np.ndarray
    chunk_length: int
    original_length: int
    input_db: float
    channels: int
    sample_rate: int
    padding: bool
    dac_version: str = SUPPORTED_VERSIONS[-1]

    def save(self, path: str) -> str:
        artifacts = {
            "codes": np.asarray(self.codes).astype(np.uint16),
            "metadata": {
                "input_db": np.float32(self.input_db),
                "original_length": self.original_length,
                "sample_rate": self.sample_rate,
                "chunk_length": self.chunk_length,
                "channels": self.channels,
                "padding": self.padding,
                "dac_version": SUPPORTED_VERSIONS[-1],
            },
        }
        if not str(path).endswith(".dac"):
            path = str(path) + ".dac"
        with open(path, "wb") as f:
            np.save(f, artifacts)
        return path

    @classmethod
    def load(cls, path: str) -> "DACFile":
        artifacts = np.load(path, allow_pickle=True)[()]
        meta = dict(artifacts["metadata"])
        if meta.get("dac_version") not in SUPPORTED_VERSIONS:
            raise RuntimeError(
                f"{path} can't be loaded with this codec version")
        meta.pop("dac_version")
        return cls(codes=artifacts["codes"].astype(np.int32),
                   **{k: (float(v) if k == "input_db" else v)
                      for k, v in meta.items()})


# --------------------------------------------------------------- modules
def _run(layers, x: torch.Tensor, padded: bool) -> torch.Tensor:
    for layer in layers:
        x = layer(x, padded)
    return x


class ResidualUnit(nn.Module):
    """snake, dilated conv 7, snake, conv 1; the skip cropped to match
    (dac.py:24-40)."""

    def __init__(self, dim: int, dilation: int = 1):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.block = nn.ModuleList([
            Snake1d(dim), WNConv1d(dim, dim, 7, dilation=dilation,
                                   padding=pad),
            Snake1d(dim), WNConv1d(dim, dim, 1)])

    def forward(self, x: torch.Tensor, padded: bool = True) -> torch.Tensor:
        y = _run(self.block, x, padded)
        crop = (x.shape[-1] - y.shape[-1]) // 2
        if crop > 0:
            x = x[..., crop:-crop]
        return x + y


class EncoderBlock(nn.Module):
    """Three dilated residual units, then a strided conv (dac.py:43-61)."""

    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.block = nn.ModuleList([
            ResidualUnit(dim // 2, 1), ResidualUnit(dim // 2, 3),
            ResidualUnit(dim // 2, 9), Snake1d(dim // 2),
            WNConv1d(dim // 2, dim, 2 * stride, stride=stride,
                     padding=math.ceil(stride / 2))])

    def forward(self, x: torch.Tensor, padded: bool = True) -> torch.Tensor:
        return _run(self.block, x, padded)


class Encoder(nn.Module):
    """``(B, 1, T)`` -> ``(B, d_latent, T / hop)`` (dac.py:64-91)."""

    def __init__(self, d_model: int = 64,
                 strides: Sequence[int] = (2, 4, 8, 8), d_latent: int = 64):
        super().__init__()
        block: List[nn.Module] = [WNConv1d(1, d_model, 7, padding=3)]
        for s in strides:
            d_model *= 2
            block.append(EncoderBlock(d_model, s))
        block += [Snake1d(d_model), WNConv1d(d_model, d_latent, 3, padding=1)]
        self.block = nn.ModuleList(block)

    def forward(self, x: torch.Tensor, padded: bool = True) -> torch.Tensor:
        """``x (B, T)`` or ``(B, 1, T)``; spans ``encoder.embed`` (the
        channel axis and the first conv), ``encoder.s{i}`` (one per
        :class:`EncoderBlock`) and ``encoder.post`` (last snake and conv)."""
        with annotate("encoder.embed"):
            if x.dim() == 2:
                x = x[:, None]
            x = self.block[0](x, padded)
        for i, block in enumerate(self.block[1:-2]):
            with annotate(f"encoder.s{i}"):
                x = block(x, padded)
        with annotate("encoder.post"):
            return _run(self.block[-2:], x, padded)


class DecoderBlock(nn.Module):
    """snake, strided transposed conv, three residual units
    (dac.py:94-112)."""

    def __init__(self, input_dim: int, output_dim: int, stride: int):
        super().__init__()
        self.block = nn.ModuleList([
            Snake1d(input_dim),
            WNConvTranspose1d(input_dim, output_dim, 2 * stride,
                              stride=stride, padding=math.ceil(stride / 2)),
            ResidualUnit(output_dim, 1), ResidualUnit(output_dim, 3),
            ResidualUnit(output_dim, 9)])

    def forward(self, x: torch.Tensor, padded: bool = True) -> torch.Tensor:
        return _run(self.block, x, padded)


class Decoder(nn.Module):
    """``(B, latent, T / hop)`` -> ``(B, T)`` in [-1, 1]
    (dac.py:115-144)."""

    def __init__(self, input_channel: int, channels: int,
                 rates: Sequence[int], d_out: int = 1):
        super().__init__()
        model: List[nn.Module] = [WNConv1d(input_channel, channels, 7,
                                           padding=3)]
        out_dim = channels
        for i, s in enumerate(rates):
            out_dim = channels // 2 ** (i + 1)
            model.append(DecoderBlock(channels // 2 ** i, out_dim, s))
        model += [Snake1d(out_dim), WNConv1d(out_dim, d_out, 7, padding=3)]
        self.model = nn.ModuleList(model)

    def forward(self, x: torch.Tensor, padded: bool = True) -> torch.Tensor:
        """Spans ``decoder.pre`` (the first conv), ``decoder.s{i}`` (one per
        :class:`DecoderBlock`) and ``decoder.post`` (last snake, conv, tanh
        and the channel axis dropped)."""
        with annotate("decoder.pre"):
            x = self.model[0](x, padded)
        for i, block in enumerate(self.model[1:-2]):
            with annotate(f"decoder.s{i}"):
                x = block(x, padded)
        with annotate("decoder.post"):
            return torch.tanh(_run(self.model[-2:], x, padded))[:, 0]


class DACModule(nn.Module):
    """The whole codec (dac.py:147-322); in training mode (``train()``) the
    quantizer's search and the snakes run their plain versions."""

    def __init__(self, encoder_dim: int = 64,
                 encoder_rates: Sequence[int] = (2, 4, 8, 8),
                 latent_dim: Optional[int] = None, decoder_dim: int = 1536,
                 decoder_rates: Sequence[int] = (8, 8, 4, 2),
                 n_codebooks: int = 9, codebook_size: int = 1024,
                 codebook_dim: Union[int, Sequence[int]] = 8,
                 quantizer_dropout: float = 0.0, sample_rate: int = 44100):
        super().__init__()
        self.encoder_rates = tuple(encoder_rates)
        self.decoder_rates = tuple(decoder_rates)
        self.sample_rate = sample_rate
        self.hop_length = int(np.prod(self.encoder_rates))
        latent = (latent_dim if latent_dim is not None
                  else encoder_dim * 2 ** len(self.encoder_rates))
        self.latent_dim = latent
        self.encoder = Encoder(encoder_dim, self.encoder_rates, latent)
        self.quantizer = ResidualVectorQuantize(
            latent, n_codebooks, codebook_size, codebook_dim,
            quantizer_dropout)
        self.decoder = Decoder(latent, decoder_dim, self.decoder_rates)

    def encode(self, audio: torch.Tensor, n_quantizers=None,
               padded: bool = True):
        """``audio (B, T)`` -> (z_q, codes, latents, commitment, codebook
        loss)."""
        z = self.encoder(audio, padded)
        with annotate("vq.s0"):
            return self.quantizer(z, n_quantizers)

    def decode(self, z: torch.Tensor, padded: bool = True) -> torch.Tensor:
        """Latent ``(B, latent, T')`` -> audio ``(B, T)``."""
        return self.decoder(z, padded)

    def decode_codes(self, codes: torch.Tensor,
                     padded: bool = True) -> torch.Tensor:
        with annotate("vq.s0"):
            z = self.quantizer.from_codes(codes)[0]
        return self.decode(z, padded)

    def forward(self, audio: torch.Tensor, n_quantizers=None) -> dict:
        """The padded forward (dac.py:268-322): the input padded on the
        right to a multiple of the hop, the output cropped back to at most
        the input's length. ``z`` and ``latents`` are NCW."""
        length = audio.shape[-1]
        right = -(-length // self.hop_length) * self.hop_length - length
        x = torch.nn.functional.pad(audio, (0, right))
        z, codes, latents, cm, cb = self.encode(x, n_quantizers)
        recon = self.decode(z)[..., :length]
        return {"audio": recon, "z": z, "codes": codes, "latents": latents,
                "vq/commitment_loss": cm, "vq/codebook_loss": cb}


def conv_specs(encoder_rates: Sequence[int], decoder_rates: Sequence[int]
               ) -> List[Tuple[str, int, int, int]]:
    """The model's convolutions in order, encoder then decoder, as (kind,
    kernel, stride, dilation): what the delay and the output lengths are
    computed from (base.py:82-123). The encoder's are the first
    ``2 + 7 * len(encoder_rates)``."""
    specs: List[Tuple[str, int, int, int]] = [("c", 7, 1, 1)]
    for s in encoder_rates:
        for d in (1, 3, 9):
            specs += [("c", 7, 1, d), ("c", 1, 1, 1)]
        specs += [("c", 2 * s, s, 1)]
    specs += [("c", 3, 1, 1)]
    specs += [("c", 7, 1, 1)]
    for s in decoder_rates:
        specs += [("t", 2 * s, s, 1)]
        for d in (1, 3, 9):
            specs += [("c", 7, 1, d), ("c", 1, 1, 1)]
    specs += [("c", 7, 1, 1)]
    return specs


def output_length(specs, input_length: int) -> int:
    """The unpadded (VALID) output length through ``specs``
    (base.py:108-123)."""
    L = input_length
    for kind, k, s, d in specs:
        if kind == "c":
            L = (L - d * (k - 1) - 1) // s + 1
        else:
            L = (L - 1) * s + d * (k - 1) + 1
    return L


def delay(specs) -> int:
    """The samples each window of the unpadded codec loses on each side
    (base.py:82-106)."""
    L = l_out = output_length(specs, 0)
    for kind, k, s, d in reversed(specs):
        if kind == "t":
            L = math.ceil((L - d * (k - 1) - 1) / s) + 1
        else:
            L = math.ceil((L - 1) * s + d * (k - 1) + 1)
    return (L - l_out) // 2


@torch.no_grad()
def init_dac(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init as the JAX package's (flax's WeightNorm): each direction
    ``weight_v`` normal, each magnitude ``weight_g`` one, so every kernel
    slice starts at unit norm; biases zero, snake alphas one, codebooks
    standard normal. Drawn on the CPU, so a seed gives the same weights on
    every machine."""
    for m in module.modules():
        if isinstance(m, _WeightNorm):
            m.weight_v.copy_(torch.randn(m.weight_v.shape,
                                         generator=generator))
            m.weight_g.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, Snake1d):
            m.alpha.fill_(1.0)
        elif isinstance(m, VectorQuantize):
            w = m.codebook.weight
            w.copy_(torch.randn(w.shape, generator=generator))
    return module


class DAC:
    """The codec on a device: weights from ``seed`` (or loaded), the eval
    forward, and the windowed file codec. ``plain_ops`` runs the argmin's
    and the snake's plain versions on any device, as the yardstick the
    kernels are held to."""

    def __init__(self, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 plain_ops: bool = False, **config):
        self.config = dict(config)
        self.device = resolve_device(device)
        self.module = DACModule(**config)
        init_dac(self.module, torch.Generator().manual_seed(seed))
        for m in self.module.modules():
            if isinstance(m, (VectorQuantize, Snake1d)):
                m.plain_ops = plain_ops
        self.module.to(self.device).eval()
        self.sample_rate = self.module.sample_rate
        self.hop_length = self.module.hop_length
        self.delay = self.get_delay()

    # -- weights ---------------------------------------------------------
    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        """Reference-key weights (``weight_g`` / ``weight_v``)."""
        return self.module.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()},
            strict=strict)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    # -- geometry ----------------------------------------------------------
    def _specs(self):
        return conv_specs(self.module.encoder_rates,
                          self.module.decoder_rates)

    def get_output_length(self, input_length: int) -> int:
        """The unpadded (VALID) output length of the whole model."""
        return output_length(self._specs(), input_length)

    def get_delay(self) -> int:
        """The delay of chunked unpadded inference, in samples."""
        return delay(self._specs())

    # -- serving -------------------------------------------------------------
    def _audio(self, x) -> torch.Tensor:
        with annotate("codec.upload"):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x, np.float32))
            x = x.to(self.device, torch.float32)
            if x.dim() == 3:                  # the reference's (B, 1, T)
                x = x[:, 0]
            return x[None] if x.dim() == 1 else x

    @torch.no_grad()
    def __call__(self, audio, n_quantizers: Optional[int] = None) -> dict:
        """The eval forward's dict (on the device); an int
        ``n_quantizers`` stops after that many stages."""
        if self.module.training:
            raise RuntimeError("the eval forward needs module.eval()")
        return self.module(self._audio(audio), None if n_quantizers is None
                           else int(n_quantizers))

    forward = __call__

    @torch.no_grad()
    def encode_codes(self, x, padded: bool = True) -> torch.Tensor:
        """Waveform ``(B, T)`` -> codes ``(B, N, T')`` on the device, every
        stage (span ``codec.encode``)."""
        with annotate("codec.encode"):
            return self.module.encode(self._audio(x), None, padded)[1]

    @torch.no_grad()
    def decode_codes(self, codes, padded: bool = True) -> torch.Tensor:
        """Codes ``(B, N, T')`` -> waveform ``(B, T)`` on the device (span
        ``codec.decode``)."""
        with annotate("codec.decode"):
            with annotate("codec.upload"):
                codes = torch.as_tensor(np.asarray(codes) if not isinstance(
                    codes, torch.Tensor) else codes).to(self.device)
            return self.module.decode_codes(codes, padded)

    def compress(self, audio_or_path, win_duration: float = 1.0,
                 normalize_db_target: Optional[float] = -16,
                 n_quantizers: Optional[int] = None) -> DACFile:
        """Compress in windows of ``win_duration`` seconds, in constant
        memory (base.py:125-233): loudness-normalised, and a file longer
        than one window coded unpadded with the delay on both sides."""
        if isinstance(audio_or_path, str):
            from ...io import load_wav
            x = load_wav(audio_or_path)
        else:
            x = np.asarray(audio_or_path, np.float32).reshape(-1)
        original_length = len(x)
        input_db = loudness_db(x, self.sample_rate)
        if normalize_db_target is not None:
            x = normalize_db(x, normalize_db_target, self.sample_rate)
        peak = np.abs(x).max()
        if peak > 1.0:
            x = x / peak

        if len(x) / self.sample_rate <= win_duration:
            padded = True
            right = -(-len(x) // self.hop_length) * self.hop_length - len(x)
            x = np.pad(x, (0, right))
            n_samples = hop = len(x)
        else:
            padded = False
            x = np.pad(x, (self.delay, self.delay))
            n_samples = int(win_duration * self.sample_rate)
            n_samples = -(-n_samples // self.hop_length) * self.hop_length
            hop = self.get_output_length(n_samples)

        codes, chunk_length = [], None
        for i in range(0, original_length if not padded else 1, hop):
            chunk = x[i:i + n_samples]
            if len(chunk) < n_samples:
                chunk = np.pad(chunk, (0, n_samples - len(chunk)))
            c = self.encode_codes(np.asarray(chunk, np.float32)[None],
                                  padded).cpu().numpy()
            if n_quantizers is not None:
                c = c[:, :n_quantizers]
            codes.append(c)
            chunk_length = c.shape[-1]
        return DACFile(codes=np.concatenate(codes, axis=-1),
                       chunk_length=chunk_length,
                       original_length=original_length, input_db=input_db,
                       channels=1, sample_rate=self.sample_rate,
                       padding=padded)

    def decompress(self, obj: Union[str, DACFile]) -> np.ndarray:
        """Audio ``(1, original_length)`` from a ``.dac`` file or a
        :class:`DACFile` (base.py:235-294)."""
        if isinstance(obj, str):
            obj = DACFile.load(obj)
        codes = np.asarray(obj.codes, np.int32)
        cl = obj.chunk_length
        recons = [self.decode_codes(codes[..., i:i + cl], obj.padding)
                  .cpu().numpy() for i in range(0, codes.shape[-1], cl)]
        y = np.concatenate(recons, axis=-1).reshape(-1)
        y = normalize_db(y, obj.input_db, self.sample_rate)
        if len(y) < obj.original_length:
            # a padded decode can come up a few samples short where a rate's
            # transposed conv drops a latent step (rate 5): zero-filled, as
            # in the JAX package (the torch reference would raise)
            y = np.pad(y, (0, obj.original_length - len(y)))
        return y[:obj.original_length][None]
