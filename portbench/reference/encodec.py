"""The plain reference of EnCodec 24 kHz: serving forward.

A torch-only re-creation of the ``encodec_24khz`` release (Défossez et
al., arXiv:2210.13438; github.com/facebookresearch/encodec,
``encodec/model.py``, ``modules/seanet.py``, ``modules/conv.py``,
``modules/lstm.py``, ``quantization/core_vq.py``) with the release's
state dict keys (``encoder.model.0.conv.conv.weight_v``,
``encoder.model.13.lstm.weight_ih_l0``,
``quantizer.vq.layers.0._codebook.embed``), written here so that no change
to the tests or to the program can move the yardstick the benchmark holds
the program to. Departures from the release, none to the arithmetic of
the forward:

- importing this module turns TF32 off for matrix products and cuDNN
  convolutions: the reference computes in float32, as the configuration
  states, whatever the process set before (a control that wants TF32 sets
  it after the import);
- the LSTM is its own loop over time (:class:`LSTM`), not ``nn.LSTM``:
  per layer the input's product with ``W_ih`` for every step at once, then
  per step ``i, f, g, o`` from it plus ``h W_hhᵀ`` and both biases, with
  sigmoid and tanh, as torch documents ``nn.LSTM``; so the program's cuDNN
  recurrence is held to an independent computation;
- the codebooks are parameters, not the release's k-means buffers (the
  EMA buffers ``inited``, ``cluster_size`` and ``embed_avg`` are left out,
  as the program's loader drops them), and :func:`init_weights` fills
  every value from a generator;
- :meth:`Encodec.encode` returns codes ``(B, n_q, T)``, the release's
  layout after its transpose; the input is one segment (the 24 kHz model
  has none) and is not normalised (its ``audio_normalize`` is off);
- :meth:`Encodec.code_gaps` follows codes handed to it, stage by stage,
  and returns by how much each lies above the nearest codeword's squared
  distance, relative to it;
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

# the spread of a normal truncated at two sigma, divided out so that the
# directions are lecun-normal (the program's init_encodec)
_TRUNC_STD = 0.87962566103423978


def _weight_norm(module):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return nn.utils.weight_norm(module)


# ---------------------------------------------------------------- layers
def pad1d(x, left, right, mode="reflect"):  # conv.py:pad1d
    """Pad the time axis; a reflection longer than the signal first
    extends it with zeros on the right, which are cut off again."""
    length = x.shape[-1]
    extra = 0
    if mode == "reflect" and max(left, right) >= length:
        extra = max(left, right) - length + 1
        x = F.pad(x, (0, extra))
    padded = F.pad(x, (left, right), mode=mode)
    return padded[..., :padded.shape[-1] - extra]


class NormConv1d(nn.Module):  # conv.py:NormConv1d, norm "weight_norm"
    def __init__(self, *a, **k):
        super().__init__()
        self.conv = _weight_norm(nn.Conv1d(*a, **k))

    def forward(self, x):
        return self.conv(x)


class NormConvTranspose1d(nn.Module):  # conv.py:NormConvTranspose1d
    def __init__(self, *a, **k):
        super().__init__()
        self.convtr = _weight_norm(nn.ConvTranspose1d(*a, **k))

    def forward(self, x):
        return self.convtr(x)


class SConv1d(nn.Module):  # conv.py:SConv1d
    def __init__(self, cin, cout, k, stride=1, dilation=1, causal=True,
                 pad_mode="reflect"):
        super().__init__()
        self.conv = NormConv1d(cin, cout, k, stride=stride,
                               dilation=dilation)
        self.k_eff = (k - 1) * dilation + 1
        self.stride, self.causal, self.pad_mode = stride, causal, pad_mode

    def forward(self, x):
        padding_total = self.k_eff - self.stride
        n_frames = (x.shape[-1] - self.k_eff + padding_total) / self.stride + 1
        ideal = ((math.ceil(n_frames) - 1) * self.stride
                 + (self.k_eff - padding_total))
        extra = ideal - x.shape[-1]
        if self.causal:
            x = pad1d(x, padding_total, extra, self.pad_mode)
        else:
            right = padding_total // 2
            x = pad1d(x, padding_total - right, right + extra, self.pad_mode)
        return self.conv(x)


class SConvTranspose1d(nn.Module):  # conv.py:SConvTranspose1d
    def __init__(self, cin, cout, k, stride=1, causal=True):
        super().__init__()
        self.convtr = NormConvTranspose1d(cin, cout, k, stride=stride)
        self.padding_total, self.causal = k - stride, causal

    def forward(self, x):
        y = self.convtr(x)
        p = self.padding_total
        if self.causal:                      # trim_right_ratio 1
            return y[..., :y.shape[-1] - p]
        right = p // 2
        return y[..., p - right:y.shape[-1] - right]


class LSTM(nn.Module):
    """``num_layers`` LSTM layers over ``(T, B, C)``, the keys and gate
    order (i, f, g, o) of ``nn.LSTM``, each its own loop over time."""

    def __init__(self, dim, num_layers):
        super().__init__()
        self.hidden, self.num_layers = dim, num_layers
        for k in range(num_layers):
            for name, shape in (("weight_ih", (4 * dim, dim)),
                                ("weight_hh", (4 * dim, dim)),
                                ("bias_ih", (4 * dim,)),
                                ("bias_hh", (4 * dim,))):
                self.register_parameter(f"{name}_l{k}",
                                        nn.Parameter(torch.empty(shape)))

    def forward(self, x):
        H = self.hidden
        for k in range(self.num_layers):
            w_hh = getattr(self, f"weight_hh_l{k}")
            gx = (x @ getattr(self, f"weight_ih_l{k}").t()
                  + getattr(self, f"bias_ih_l{k}")
                  + getattr(self, f"bias_hh_l{k}"))
            h = x.new_zeros(x.shape[1], H)
            c = x.new_zeros(x.shape[1], H)
            out = []
            for t in range(x.shape[0]):
                gates = gx[t] + h @ w_hh.t()
                i = torch.sigmoid(gates[:, :H])
                f = torch.sigmoid(gates[:, H:2 * H])
                g = torch.tanh(gates[:, 2 * H:3 * H])
                o = torch.sigmoid(gates[:, 3 * H:])
                c = f * c + i * g
                h = o * torch.tanh(c)
                out.append(h)
            x = torch.stack(out)
        return x


class SLSTM(nn.Module):  # lstm.py:SLSTM, skip on
    def __init__(self, dim, num_layers):
        super().__init__()
        self.lstm = LSTM(dim, num_layers)

    def forward(self, x):
        x = x.permute(2, 0, 1)
        return (self.lstm(x) + x).permute(1, 2, 0)


class SEANetResnetBlock(nn.Module):  # seanet.py:SEANetResnetBlock
    def __init__(self, dim, kernel_sizes, dilations, compress, causal,
                 true_skip, pad_mode):
        super().__init__()
        hidden = dim // compress
        block = []
        for (cin, cout), k, d in zip(((dim, hidden), (hidden, dim)),
                                     kernel_sizes, dilations):
            block += [nn.ELU(), SConv1d(cin, cout, k, dilation=d,
                                        causal=causal, pad_mode=pad_mode)]
        self.block = nn.Sequential(*block)
        self.shortcut = nn.Identity() if true_skip else SConv1d(
            dim, dim, 1, causal=causal, pad_mode=pad_mode)

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


class SEANetEncoder(nn.Module):  # seanet.py:SEANetEncoder
    def __init__(self, channels, dimension, n_filters, ratios,
                 n_residual_layers, kernel_size, last_kernel_size,
                 residual_kernel_size, dilation_base, compress, lstm,
                 causal, true_skip, pad_mode):
        super().__init__()
        conv = dict(causal=causal, pad_mode=pad_mode)
        mult = 1
        model = [SConv1d(channels, n_filters, kernel_size, **conv)]
        for ratio in reversed(ratios):
            for j in range(n_residual_layers):
                model.append(SEANetResnetBlock(
                    mult * n_filters, (residual_kernel_size, 1),
                    (dilation_base ** j, 1), compress, causal, true_skip,
                    pad_mode))
            model += [nn.ELU(), SConv1d(mult * n_filters,
                                        mult * n_filters * 2, ratio * 2,
                                        stride=ratio, **conv)]
            mult *= 2
        if lstm:
            model.append(SLSTM(mult * n_filters, lstm))
        model += [nn.ELU(), SConv1d(mult * n_filters, dimension,
                                    last_kernel_size, **conv)]
        self.model = nn.Sequential(*model)

    def forward(self, x):
        return self.model(x)


class SEANetDecoder(nn.Module):  # seanet.py:SEANetDecoder
    def __init__(self, channels, dimension, n_filters, ratios,
                 n_residual_layers, kernel_size, last_kernel_size,
                 residual_kernel_size, dilation_base, compress, lstm,
                 causal, true_skip, pad_mode):
        super().__init__()
        conv = dict(causal=causal, pad_mode=pad_mode)
        mult = 2 ** len(ratios)
        model = [SConv1d(dimension, mult * n_filters, kernel_size, **conv)]
        if lstm:
            model.append(SLSTM(mult * n_filters, lstm))
        for ratio in ratios:
            model += [nn.ELU(), SConvTranspose1d(
                mult * n_filters, mult * n_filters // 2, ratio * 2,
                stride=ratio, causal=causal)]
            for j in range(n_residual_layers):
                model.append(SEANetResnetBlock(
                    mult * n_filters // 2, (residual_kernel_size, 1),
                    (dilation_base ** j, 1), compress, causal, true_skip,
                    pad_mode))
            mult //= 2
        model += [nn.ELU(), SConv1d(n_filters, channels, last_kernel_size,
                                    **conv)]
        self.model = nn.Sequential(*model)

    def forward(self, z):
        return self.model(z)


# -------------------------------------------------------------------- VQ
class _Codebook(nn.Module):  # core_vq.py:EuclideanCodebook
    def __init__(self, bins, dim):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(bins, dim))

    def distances(self, x):
        """(N, bins) squared distances of the rows of ``x (N, D)`` to the
        codewords, as the release's ``quantize`` writes them."""
        e = self.embed.t()
        return (x.pow(2).sum(1, keepdim=True) - 2 * x @ e
                + e.pow(2).sum(0, keepdim=True))


class _Layer(nn.Module):  # core_vq.py:VectorQuantization (no projection)
    def __init__(self, bins, dim):
        super().__init__()
        self._codebook = _Codebook(bins, dim)


class _Stages(nn.Module):  # core_vq.py:ResidualVectorQuantization
    def __init__(self, n_q, bins, dim):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(bins, dim) for _ in range(n_q))


class ResidualVectorQuantizer(nn.Module):  # quantization/vq.py
    def __init__(self, dimension, n_q, bins):
        super().__init__()
        self.vq = _Stages(n_q, bins, dimension)

    def encode(self, z, n_q):
        """``(B, D, T)`` -> codes ``(B, n_q, T)``: each stage the nearest
        codeword (``-dist``'s max), the residual less it."""
        B, D, T = z.shape
        residual, codes = z.permute(0, 2, 1).reshape(-1, D), []
        for layer in self.vq.layers[:n_q]:
            cb = layer._codebook
            idx = (-cb.distances(residual)).max(1)[1]
            codes.append(idx.view(B, T))
            residual = residual - F.embedding(idx, cb.embed)
        return torch.stack(codes, 1)

    def gaps(self, z, codes):
        """The widest amount by which a code of ``codes (B, n_q, T)``,
        taken as given at every stage, lies above the nearest codeword's
        squared distance, over that distance."""
        D = z.shape[1]
        worst, residual = 0.0, z.permute(0, 2, 1).reshape(-1, D)
        for q in range(codes.shape[1]):
            cb = self.vq.layers[q]._codebook
            idx = codes[:, q].reshape(-1)
            d = cb.distances(residual)
            got = d.gather(1, idx[:, None])[:, 0]
            best = d.min(1).values
            worst = max(worst, float(((got - best) / best).max()))
            residual = residual - F.embedding(idx, cb.embed)
        return worst

    def decode(self, codes):
        """Codes ``(B, n_q, T)`` -> the sum of their codewords ``(B, D,
        T)``, stage by stage."""
        out = 0.0
        for q in range(codes.shape[1]):
            out = out + F.embedding(codes[:, q],
                                    self.vq.layers[q]._codebook.embed)
        return out.permute(0, 2, 1)


# ----------------------------------------------------------------- codec
class Encodec(nn.Module):
    """Reference-equivalent EnCodec: codes of the first ``n_q`` stages,
    decode from codes. Takes the ``Encodec`` and ``SEANet`` sections of an
    EnCodec configuration (``norm`` weight_norm and ``activation`` ELU are
    the only ones written here)."""

    def __init__(self, sample_rate=24000, dimension=128, n_filters=32,
                 ratios=(8, 5, 4, 2), n_q=32, bins=1024, channels=1,
                 n_residual_layers=1, kernel_size=7, last_kernel_size=7,
                 residual_kernel_size=3, dilation_base=2, compress=2, lstm=2,
                 causal=True, true_skip=False, pad_mode="reflect",
                 norm="weight_norm", activation="ELU"):
        super().__init__()
        if norm != "weight_norm" or activation != "ELU" or channels != 1:
            raise ValueError("the reference writes the mono weight_norm ELU "
                             "SEANet of the release only")
        seanet = dict(channels=channels, dimension=dimension,
                      n_filters=n_filters, ratios=list(ratios),
                      n_residual_layers=n_residual_layers,
                      kernel_size=kernel_size,
                      last_kernel_size=last_kernel_size,
                      residual_kernel_size=residual_kernel_size,
                      dilation_base=dilation_base, compress=compress,
                      lstm=lstm, causal=causal, true_skip=true_skip,
                      pad_mode=pad_mode)
        self.sample_rate, self.n_q = sample_rate, n_q
        self.hop = math.prod(ratios)
        self.encoder = SEANetEncoder(**seanet)
        self.decoder = SEANetDecoder(**seanet)
        self.quantizer = ResidualVectorQuantizer(dimension, n_q, bins)

    @torch.no_grad()
    def encode(self, x, n_q=None):
        """Waveform ``(B, L)`` -> codes ``(B, n_q, T)``."""
        return self.quantizer.encode(self.encoder(x[:, None]),
                                     n_q or self.n_q)

    @torch.no_grad()
    def code_gaps(self, x, codes):
        """(the widest amount by which a code of ``codes (B, n_q, T)``,
        taken as given at every stage, lies above the nearest codeword's
        squared distance, relative to it, 0 where each is the nearest;
        None, the shape :meth:`decode` does not need)."""
        return self.quantizer.gaps(self.encoder(x[:, None]),
                                   codes.long()), None

    @torch.no_grad()
    def decode(self, codes, shape=None):
        """Codes ``(B, n_q, T)`` -> waveform ``(B, T hop)``."""
        return self.decoder(self.quantizer.decode(codes.long()))[:, 0]


@torch.no_grad()
def init_weights(module: nn.Module, gen: torch.Generator) -> None:
    """Every value of ``module`` from ``gen``, on the generator's device,
    with the distributions of the program's ``init_encodec``: each
    convolution's direction lecun-normal (truncated at two sigma, fan-in
    over the kernel and dim 1), its magnitude one and its bias zero; the
    LSTM's weights and biases uniform in ±1/sqrt(hidden); the codebooks
    standard normal."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            v = m.weight_v
            std = math.sqrt(1.0 / (v.shape[1] * v.shape[2])) / _TRUNC_STD
            nn.init.trunc_normal_(v, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            m.weight_g.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, LSTM):
            k = 1.0 / math.sqrt(m.hidden)
            for p in m.parameters():
                p.uniform_(-k, k, generator=gen)
        elif isinstance(m, _Codebook):
            m.embed.normal_(generator=gen)
