"""The plain reference of DAC, the Descript Audio Codec: serving forward.

Frozen copy of ``tests/torch_mirror_dac.py``'s forward, a torch-only
re-creation of the DAC release (Kumar et al., arXiv:2306.06546;
github.com/descriptinc/descript-audio-codec, ``dac/model/dac.py``,
``dac/nn/layers.py``, ``dac/nn/quantize.py``) with the release's state dict
keys (``encoder.block.1.block.0.block.1.weight_v``,
``quantizer.quantizers.0.codebook.weight``). It is frozen here so that no
later change to the tests or to the program can move the yardstick the
benchmark holds the program to. Changes from the copy and from the
release, none to the arithmetic:

- importing this module turns TF32 off for matrix products and cuDNN
  convolutions: the reference computes in float32, as the configuration
  states, whatever the process set before (a control that wants TF32 sets
  it after the import);
- :meth:`DAC.encode` returns the codes of every stage, and the release's
  eval-mode residual loop is written out: its straight-through estimate is
  a numeric no-op, so each stage subtracts ``out_proj`` of its codeword;
- :meth:`DAC.code_gaps` follows codes handed to it, stage by stage, and
  returns by how much each lies above the best codeword's cosine distance;
- :func:`snake_alphas_to_one` sets every snake's alpha to 1, as the
  release initialises it (the benchmark's weights come from
  ``portbench/reference/weights.py::fill``, whose fan-in rule would draw
  alpha near 0, where snake is nearly the identity);
- ``torch.nn.utils.weight_norm``'s deprecation warning is silenced: its
  ``weight_g`` / ``weight_v`` are the release's keys.

Plain ``torch`` only: nothing of ``esc_tpu_torch``, ``esc_tpu`` or JAX.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn as nn
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _weight_norm(module):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return nn.utils.weight_norm(module)


# ---------------------------------------------------------------- layers
class Snake1d(nn.Module):  # layers.py:8-24
    def __init__(self, c):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, c, 1))

    def forward(self, x):
        return x + torch.sin(self.alpha * x) ** 2 / (self.alpha + 1e-9)


def WNConv1d(*a, **k):
    return _weight_norm(nn.Conv1d(*a, **k))


def WNConvTranspose1d(*a, **k):
    return _weight_norm(nn.ConvTranspose1d(*a, **k))


class ResidualUnit(nn.Module):  # dac.py:24-40
    def __init__(self, dim, dilation):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.block = nn.Sequential(
            Snake1d(dim), WNConv1d(dim, dim, 7, dilation=dilation,
                                   padding=pad),
            Snake1d(dim), WNConv1d(dim, dim, 1))

    def forward(self, x):
        y = self.block(x)
        pad = (x.shape[-1] - y.shape[-1]) // 2
        if pad > 0:
            x = x[..., pad:-pad]
        return x + y


class EncoderBlock(nn.Module):  # dac.py:43-61
    def __init__(self, dim, stride):
        super().__init__()
        self.block = nn.Sequential(
            ResidualUnit(dim // 2, 1), ResidualUnit(dim // 2, 3),
            ResidualUnit(dim // 2, 9), Snake1d(dim // 2),
            WNConv1d(dim // 2, dim, 2 * stride, stride=stride,
                     padding=math.ceil(stride / 2)))

    def forward(self, x):
        return self.block(x)


class Encoder(nn.Module):  # dac.py:64-91
    def __init__(self, d_model, strides, d_latent):
        super().__init__()
        block = [WNConv1d(1, d_model, 7, padding=3)]
        for s in strides:
            d_model *= 2
            block += [EncoderBlock(d_model, s)]
        block += [Snake1d(d_model), WNConv1d(d_model, d_latent, 3,
                                             padding=1)]
        self.block = nn.Sequential(*block)

    def forward(self, x):
        return self.block(x)


class DecoderBlock(nn.Module):  # dac.py:94-112
    def __init__(self, in_dim, out_dim, stride):
        super().__init__()
        self.block = nn.Sequential(
            Snake1d(in_dim),
            WNConvTranspose1d(in_dim, out_dim, 2 * stride, stride=stride,
                              padding=math.ceil(stride / 2)),
            ResidualUnit(out_dim, 1), ResidualUnit(out_dim, 3),
            ResidualUnit(out_dim, 9))

    def forward(self, x):
        return self.block(x)


class Decoder(nn.Module):  # dac.py:115-144
    def __init__(self, in_ch, channels, rates):
        super().__init__()
        model = [WNConv1d(in_ch, channels, 7, padding=3)]
        out = channels
        for i, s in enumerate(rates):
            out = channels // 2 ** (i + 1)
            model += [DecoderBlock(channels // 2 ** i, out, s)]
        model += [Snake1d(out), WNConv1d(out, 1, 7, padding=3), nn.Tanh()]
        self.model = nn.Sequential(*model)

    def forward(self, x):
        return self.model(x)


# -------------------------------------------------------------------- VQ
class VectorQuantize(nn.Module):  # quantize.py:13-94
    def __init__(self, input_dim, cb_size, cb_dim):
        super().__init__()
        self.in_proj = WNConv1d(input_dim, cb_dim, 1)
        self.out_proj = WNConv1d(cb_dim, input_dim, 1)
        self.codebook = nn.Embedding(cb_size, cb_dim)

    def distances(self, latents):
        """(B T, K) cosine distances of the projected latents ``(B, d, T)``
        to the codewords: squared distances of L2-normalised vectors
        (quantize.py:82-92)."""
        D = latents.shape[1]
        enc = F.normalize(latents.permute(0, 2, 1).reshape(-1, D))
        cb = F.normalize(self.codebook.weight)
        return (enc.pow(2).sum(1, keepdim=True) - 2 * enc @ cb.t()
                + cb.pow(2).sum(1, keepdim=True).t())

    def codeword(self, idx):
        """Codes ``(B, T)`` -> codewords ``(B, d, T)`` (not normalised)."""
        return F.embedding(idx, self.codebook.weight).transpose(1, 2)

    def encode(self, z):
        z_e = self.in_proj(z)
        B, _, T = z_e.shape
        idx = (-self.distances(z_e)).max(1)[1].reshape(B, T)
        return self.codeword(idx), idx


class ResidualVectorQuantize(nn.Module):  # quantize.py:97-255
    def __init__(self, input_dim, n_codebooks, cb_size, cb_dim):
        super().__init__()
        self.quantizers = nn.ModuleList(
            [VectorQuantize(input_dim, cb_size, cb_dim)
             for _ in range(n_codebooks)])

    def encode(self, z):
        codes, residual = [], z
        for q in self.quantizers:
            zq_i, idx = q.encode(residual)
            codes.append(idx)
            residual = residual - q.out_proj(zq_i)
        return torch.stack(codes, 1)

    def gaps(self, z, codes):
        """The widest amount by which a code of ``codes (B, N, T)``, taken
        as given at every stage, lies above the nearest codeword's
        distance."""
        worst, residual = 0.0, z
        for i in range(codes.shape[1]):
            q = self.quantizers[i]
            d = q.distances(q.in_proj(residual))
            got = d.gather(1, codes[:, i].reshape(-1, 1))[:, 0]
            worst = max(worst, float((got - d.min(1).values).max()))
            residual = residual - q.out_proj(q.codeword(codes[:, i]))
        return worst

    def from_codes(self, codes):
        zq = 0.0
        for i in range(codes.shape[1]):
            q = self.quantizers[i]
            zq = zq + q.out_proj(q.codeword(codes[:, i]))
        return zq


# ----------------------------------------------------------------- codec
class DAC(nn.Module):
    """Reference-equivalent DAC: codes of every stage, decode from codes.
    Takes the keys of the ``DAC`` section of a DAC configuration
    (``quantizer_dropout`` acts only in training and is not used)."""

    def __init__(self, encoder_dim, encoder_rates, decoder_dim,
                 decoder_rates, n_codebooks, codebook_size, codebook_dim,
                 sample_rate=16000, quantizer_dropout=0.0):
        super().__init__()
        latent = encoder_dim * 2 ** len(encoder_rates)
        self.hop = 1
        for s in encoder_rates:
            self.hop *= s
        self.encoder = Encoder(encoder_dim, encoder_rates, latent)
        self.quantizer = ResidualVectorQuantize(latent, n_codebooks,
                                                codebook_size, codebook_dim)
        self.decoder = Decoder(latent, decoder_dim, decoder_rates)

    def _latent(self, x):
        L = x.shape[-1]
        right = math.ceil(L / self.hop) * self.hop - L
        return self.encoder(F.pad(x, (0, right))[:, None, :])

    @torch.no_grad()
    def encode(self, x):
        """Waveform ``(B, L)`` -> codes ``(B, N, L / hop)``."""
        return self.quantizer.encode(self._latent(x))

    @torch.no_grad()
    def code_gaps(self, x, codes):
        """(the widest amount by which a code of ``codes (B, N, T)``, taken
        as given at every stage, lies above the nearest codeword's cosine
        distance, 0 where each is the nearest; None, the shape
        :meth:`decode` does not need)."""
        return self.quantizer.gaps(self._latent(x), codes.long()), None

    @torch.no_grad()
    def decode(self, codes, shape=None):
        """Codes ``(B, N, T)`` -> waveform ``(B, L')``."""
        return self.decoder(self.quantizer.from_codes(codes.long()))[:, 0]


@torch.no_grad()
def snake_alphas_to_one(module: nn.Module) -> None:
    """Every snake's alpha set to 1, the release's initial value."""
    for m in module.modules():
        if isinstance(m, Snake1d):
            m.alpha.fill_(1.0)
