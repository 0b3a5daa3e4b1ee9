"""EnCodec 24 kHz, the comparison baseline, on PyTorch.

Port of ``esc_tpu/baselines/encodec/model.py`` (Défossez et al. 2022, the
causal ``encodec_24khz`` model):

  encoder: conv k7 (1 -> 32), then for each ratio r of (2, 4, 5, 8) a
           residual unit, ELU and a k 2r / stride r conv doubling the
           channels to 512; a 2-layer SLSTM, ELU, conv k7 (512 -> 128)
  quantizer: 32 codebooks of 1024 x 128 (75 frames/s: 750 bps each)
  decoder: the mirror image with transposed convolutions, ratios (8, 5,
           4, 2)

The module tree is the release's: ``encoder.model.{n}`` / ``decoder.model.
{n}`` sequences (the ELUs hold slots of their own) and ``quantizer.vq.
layers.{q}``, so its state dict has the release's 156 keys at full width.
Channels-first throughout. :class:`Encodec` is the comparison interface:
a target bandwidth, audio at any sample rate resampled to 24 kHz and back
(:func:`esc_tpu_torch.ops.resample.resample`); its ``encode`` / ``decode``
are also the serving pair ``encode_codes`` / ``decode_codes`` of
:func:`esc_tpu_torch.serving.stream_map`.

Spans (:func:`esc_tpu_torch.utils.profiling.annotate`): the SEANet stacks
walk ``model`` in stages, without renaming a module: ``encoder.embed``
(the first conv), ``encoder.s0``-``s3`` (the residual unit, ELU and
strided conv of each ratio), ``encoder.lstm``, ``encoder.post`` (ELU and
the last conv); ``decoder.pre``, ``decoder.lstm``, ``decoder.s0``-``s3``,
``decoder.post``; ``vq.s0`` around the whole quantizer in encode and in
decode; ``codec.encode`` / ``codec.decode`` around :class:`Encodec`'s
``encode`` / ``decode``, with ``codec.upload`` inside them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from ...device import resolve_device
from ...ops.resample import resample
from ...utils.graphs import StageGraphs, stage
from ...utils.profiling import annotate
from ..dac.layers import _WeightNorm
from .layers import SConv1d, SConvTranspose1d, SEANetResnetBlock, SLSTM
from .quantize import EncodecRVQ

__all__ = ["SEANetEncoder", "SEANetDecoder", "EncodecModule", "Encodec",
           "init_encodec"]

# the torch truncated normal's spread over its [-2, 2] sigma window, which
# flax's variance_scaling divides out (lecun_normal)
_TRUNC_STD = 0.87962566103423978


def _run(layers, x, into=None, out=None) -> torch.Tensor:
    if into is not None:
        x = into(x)
    for layer in layers:
        x = layer(x)
    return x if out is None else out(x)


def _staged(model: nn.Sequential, stages, x: torch.Tensor,
            into=None, out=None) -> torch.Tensor:
    """``model``'s layers in order, each run of ``stages``' ``(span,
    count)`` one stage (:func:`esc_tpu_torch.utils.graphs.stage`); ``into``
    reshapes the input inside the first, ``out`` the output inside the
    last."""
    i, last = 0, len(stages) - 1
    for k, (name, count) in enumerate(stages):
        x = stage(name, _run, model[i:i + count], x,
                  into if k == 0 else None, out if k == last else None)
        i += count
    return x


class SEANetEncoder(nn.Module):
    """``(B, 1, L)`` or ``(B, L)`` waveform -> ``(B, dimension, T)``
    latents (``model.py:40-91``)."""

    def __init__(self, dimension: int = 128, n_filters: int = 32,
                 ratios: Tuple[int, ...] = (8, 5, 4, 2),
                 n_residual_layers: int = 1, kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, compress: int = 2, lstm: int = 2,
                 causal: bool = True, true_skip: bool = False,
                 pad_mode: str = "reflect"):
        super().__init__()
        conv = dict(causal=causal, pad_mode=pad_mode)
        mult = 1
        layers = [SConv1d(1, n_filters, kernel_size, **conv)]
        for ratio in reversed(ratios):
            for j in range(n_residual_layers):
                layers.append(SEANetResnetBlock(
                    mult * n_filters, (residual_kernel_size, 1),
                    (dilation_base ** j, 1), compress, true_skip=true_skip,
                    **conv))
            layers += [nn.ELU(), SConv1d(mult * n_filters,
                                         mult * n_filters * 2, 2 * ratio,
                                         stride=ratio, **conv)]
            mult *= 2
        stages = [("encoder.embed", 1)] + [
            (f"encoder.s{i}", n_residual_layers + 2)
            for i in range(len(ratios))]
        if lstm:
            layers.append(SLSTM(mult * n_filters, lstm))
            stages.append(("encoder.lstm", 1))
        layers += [nn.ELU(), SConv1d(mult * n_filters, dimension,
                                     last_kernel_size, **conv)]
        self.model = nn.Sequential(*layers)
        self.stages = stages + [("encoder.post", 2)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _staged(self.model, self.stages, x,
                       into=(lambda x: x[:, None]) if x.dim() == 2 else None)


class SEANetDecoder(nn.Module):
    """``(B, dimension, T)`` latents -> ``(B, 1, T * hop)`` waveform, or
    with ``mono`` ``(B, T * hop)`` (``model.py:94-144``)."""

    def __init__(self, dimension: int = 128, n_filters: int = 32,
                 ratios: Tuple[int, ...] = (8, 5, 4, 2),
                 n_residual_layers: int = 1, kernel_size: int = 7,
                 last_kernel_size: int = 7, residual_kernel_size: int = 3,
                 dilation_base: int = 2, compress: int = 2, lstm: int = 2,
                 causal: bool = True, true_skip: bool = False,
                 pad_mode: str = "reflect"):
        super().__init__()
        conv = dict(causal=causal, pad_mode=pad_mode)
        mult = 2 ** len(ratios)
        layers = [SConv1d(dimension, mult * n_filters, kernel_size, **conv)]
        stages = [("decoder.pre", 1)]
        if lstm:
            layers.append(SLSTM(mult * n_filters, lstm))
            stages.append(("decoder.lstm", 1))
        stages += [(f"decoder.s{i}", n_residual_layers + 2)
                   for i in range(len(ratios))]
        for ratio in ratios:
            layers += [nn.ELU(), SConvTranspose1d(
                mult * n_filters, mult * n_filters // 2, 2 * ratio,
                stride=ratio, causal=causal)]
            for j in range(n_residual_layers):
                layers.append(SEANetResnetBlock(
                    mult * n_filters // 2, (residual_kernel_size, 1),
                    (dilation_base ** j, 1), compress, true_skip=true_skip,
                    **conv))
            mult //= 2
        layers += [nn.ELU(), SConv1d(n_filters, 1, last_kernel_size, **conv)]
        self.model = nn.Sequential(*layers)
        self.stages = stages + [("decoder.post", 2)]

    def forward(self, z: torch.Tensor, mono: bool = False) -> torch.Tensor:
        return _staged(self.model, self.stages, z,
                       out=(lambda y: y[:, 0]) if mono else None)


class EncodecModule(nn.Module):
    """Encoder -> RVQ -> decoder over ``(B, L)`` mono waveforms
    (``model.py:147-186``)."""

    def __init__(self, sample_rate: int = 24000, dimension: int = 128,
                 n_filters: int = 32, ratios: Tuple[int, ...] = (8, 5, 4, 2),
                 n_q: int = 32, bins: int = 1024):
        super().__init__()
        self.sample_rate, self.ratios = sample_rate, tuple(ratios)
        self.n_q, self.bins = n_q, bins
        self.encoder = SEANetEncoder(dimension, n_filters, self.ratios)
        self.decoder = SEANetDecoder(dimension, n_filters, self.ratios)
        self.quantizer = EncodecRVQ(n_q, bins, dimension)

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.ratios))

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.hop_length

    def encode(self, x: torch.Tensor, n_q: Optional[int] = None
               ) -> torch.Tensor:
        """``(B, L)`` -> codes ``(B, n_q, T)``."""
        return stage("vq.s0", self.quantizer.encode, self.encoder(x), n_q)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """Codes ``(B, n_q, T)`` -> ``(B, T * hop)``."""
        return self.decoder(stage("vq.s0", self.quantizer.decode, codes),
                            mono=True)

    def forward(self, x: torch.Tensor, n_q: Optional[int] = None,
                training: bool = False) -> dict:
        """``{"audio": (B, L), "codes", "vq/commitment_loss": (B,)}``; with
        ``training`` the straight-through estimator and the commitment
        loss."""
        zq, codes, commit = self.quantizer(self.encoder(x), n_q, training)
        recon = self.decoder(zq, mono=True)
        return {"audio": recon[:, :x.shape[-1]], "codes": codes,
                "vq/commitment_loss": commit}


@torch.no_grad()
def init_encodec(module: nn.Module, generator: torch.Generator
                 ) -> nn.Module:
    """Seeded init with the distributions of the JAX package's: each
    convolution's direction lecun-normal (truncated at two sigma, fan-in
    kernel x its weight's dim 1), its magnitude one and its bias zero; LSTM
    weights and biases uniform in ±1/sqrt(hidden), as torch's; codebooks
    standard normal. Drawn on the CPU, so a seed gives the same weights on
    every machine."""
    for m in module.modules():
        if isinstance(m, _WeightNorm):
            v = m.weight_v
            std = math.sqrt(1.0 / (v.shape[1] * v.shape[2])) / _TRUNC_STD
            nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            m.weight_g.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.LSTM):
            k = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                p.uniform_(-k, k, generator=generator)
        elif isinstance(m, EncodecRVQ):
            for q in range(m.n_q):
                t = m.table(q)
                t.copy_(torch.randn(t.shape, generator=generator))
    return module


class Encodec:
    """The comparison wrapper (``model.py:205-288``): pick a target
    bandwidth, feed audio at any sample rate, get the reconstruction back
    at that rate; or serve 24 kHz batches through :meth:`encode_codes` /
    :meth:`decode_codes`. Weights from ``seed``, or
    :meth:`load_torch_weights`; outputs stay on ``device`` (the card unless
    the caller asks for the CPU)."""

    def __init__(self, sample_rate: int = 24000, bandwidth: float = 6.0,
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 **config):
        if sample_rate != 24000:
            raise ValueError(
                "only the 24 kHz EnCodec architecture is implemented "
                "(the reference comparison also uses the 24 kHz model)")
        self.device = resolve_device(device)
        self.module = EncodecModule(sample_rate=sample_rate, **config)
        init_encodec(self.module, torch.Generator().manual_seed(seed))
        self.module.to(self.device).eval()
        self.sample_rate = sample_rate
        self.set_target_bandwidth(bandwidth)

    # -- bandwidth ---------------------------------------------------------
    @property
    def bits_per_codebook(self) -> float:
        return math.log2(self.module.bins)

    def set_target_bandwidth(self, bandwidth: float) -> None:
        """kbps -> codebooks: ``floor(bandwidth / (frame rate x bits))``, at
        least one; more than the model has raises (``model.py:229-238``)."""
        per_cb = self.module.frame_rate * self.bits_per_codebook
        n_q = int(max(1, math.floor(bandwidth * 1000.0 / per_cb)))
        if n_q > self.module.n_q:
            raise ValueError(f"bandwidth {bandwidth} kbps needs {n_q} "
                             f"codebooks; model has {self.module.n_q}")
        self.bandwidth, self.n_q = bandwidth, n_q

    # -- weights -----------------------------------------------------------
    def state_dict(self):
        return self.module.state_dict()

    def load_state_dict(self, state_dict, strict: bool = True):
        """Release-key weights."""
        return self.module.load_state_dict(
            {k: torch.as_tensor(v) for k, v in state_dict.items()},
            strict=strict)

    def load_torch_weights(self, path: str) -> None:
        """A released ``encodec_24khz`` file (:func:`.convert.
        load_release`), strictly."""
        from .convert import load_release
        self.load_state_dict(load_release(path))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    # -- codec -------------------------------------------------------------
    def _audio(self, x, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The waveform ``x`` as float32 ``(B, L)`` on the device, or
        copied into ``out``."""
        with annotate("codec.upload"):
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.array(x, np.float32))
            x = x[None] if x.dim() == 1 else x
            return x.to(self.device, torch.float32) if out is None \
                else out.copy_(x)

    def _codes(self, codes, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """``codes`` on the device, or copied into ``out``."""
        with annotate("codec.upload"):
            return codes.to(self.device) if out is None else out.copy_(codes)

    def _graphs(self) -> Optional[StageGraphs]:
        """The stage graphs of the module where its calls may replay them
        (a CUDA device, eval mode), else None."""
        return StageGraphs.of(self, self.module, self.device)

    @torch.no_grad()
    def encode(self, audio) -> torch.Tensor:
        """24 kHz ``(B, L)`` or ``(L,)``, a host array or a tensor on any
        device -> codes ``(B, n_q, T)`` on the device at the target
        bandwidth (span ``codec.encode``); a repeated shape on a card
        replays stage graphs (:mod:`esc_tpu_torch.utils.graphs`)."""
        with annotate("codec.encode"):
            n_q, graphs = self.n_q, self._graphs()
            if graphs is None:
                return self.module.encode(self._audio(audio), n_q)
            shape = tuple(np.shape(audio))
            shape = (1,) + shape if len(shape) == 1 else shape
            return graphs.call(("encode", shape, n_q), shape, torch.float32,
                               lambda out: self._audio(audio, out),
                               lambda x: self.module.encode(x, n_q))

    @torch.no_grad()
    def decode(self, codes) -> torch.Tensor:
        """Codes ``(B, n_q, T)``, a host array or a tensor -> 24 kHz ``(B,
        T * hop)`` on the device (span ``codec.decode``), as :meth:`encode`
        through stage graphs."""
        with annotate("codec.decode"):
            if not isinstance(codes, torch.Tensor):
                with annotate("codec.upload"):  # the key needs its dtype
                    codes = torch.from_numpy(np.array(codes))
            graphs = self._graphs()
            if graphs is None:
                return self.module.decode(self._codes(codes))
            shape = tuple(codes.shape)
            return graphs.call(
                ("decode", shape, codes.dtype), shape, codes.dtype,
                lambda out: self._codes(codes, out), self.module.decode)

    # the serving pair of :func:`esc_tpu_torch.serving.stream_map`
    encode_codes = encode
    decode_codes = decode

    @torch.no_grad()
    def __call__(self, audio, sample_rate: int = 24000) -> torch.Tensor:
        """The roundtrip at the target bandwidth, resampled in and out;
        as many samples as went in."""
        x = self._audio(audio)
        L = x.shape[-1]
        if sample_rate != self.sample_rate:
            x = resample(x, sample_rate, self.sample_rate)
        recon = self.decode(self.encode(x))[:, :x.shape[-1]]
        if sample_rate != self.sample_rate:
            recon = resample(recon, self.sample_rate, sample_rate)
        return recon[:, :L]
