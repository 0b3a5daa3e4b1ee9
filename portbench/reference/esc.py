"""The plain reference of ESC (``csvq+swinT``): serving and training forward.

Frozen copy of ``tests/torch_mirror.py`` (the transformer backbone and the
product VQ; the RVQ ablation mirror left out), a torch-only re-creation of
the original ESC (esc/models/*, esc/modules/*) with the reference's state
dict keys. It is frozen here so that no later change to the tests or to the
program can move the yardstick the benchmark holds the program to. Changes
from the copy, none to the arithmetic:

- windows and filterbanks are made on the input's device;
- the mel filterbank is computed here (a copy of the HTK filterbank of
  ``esc_tpu/ops/mel.py``) instead of imported;
- :func:`code_gaps` follows codes handed to it, scale by scale, and returns
  by how much each lies above the best codeword's distance;
- LayerNorm's epsilon is :data:`LN_EPS`, 1e-6, the system's (``esc_tpu``
  and its port take flax's default), where the original's torch default is
  1e-5. The two differ where a token's variance is near 1e-5: at the
  benchmark's weights and speech-like inputs, by 9 % in the first encoder
  state of a small model. The benchmark holds the port to the codec as the
  repository defines it, and notes the departure in PERF.md;
- for the same reason the power-law loss's derivative is floored as the
  system floors it (:class:`_PowerLaw`).

Plain ``torch`` only: nothing of ``esc_tpu_torch``, ``esc_tpu`` or JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

LN_EPS = 1e-6


# ---------------------------------------------------------------- signal
def stft(x, in_freq=192):
    """torchaudio Spectrogram(power=None) equivalent (base.py:22-37)."""
    n_fft = (in_freq - 1) * 2
    w = torch.hann_window(320, dtype=torch.float32, device=x.device)
    s = torch.stft(x, n_fft=n_fft, hop_length=80, win_length=320, window=w,
                   center=True, pad_mode="reflect", return_complex=True)
    return torch.view_as_real(s).permute(0, 3, 1, 2).contiguous()


def istft(feat, in_freq=192):
    """InverseSpectrogram equivalent (base.py:39-47)."""
    n_fft = (in_freq - 1) * 2
    w = torch.hann_window(320, dtype=torch.float32, device=feat.device)
    cplx = torch.view_as_complex(feat.permute(0, 2, 3, 1).contiguous())
    return torch.istft(cplx, n_fft=n_fft, hop_length=80, win_length=320,
                       window=w, center=True)


# ------------------------------------------------------------- scale ops
def px_unshuffle(x, s1=2, s2=1):
    B, H, W, C = x.shape
    return x.reshape(B, H // s1, s1, W // s2, s2, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, H // s1, W // s2, C * s1 * s2)


def px_shuffle(x, s1=2, s2=1):
    B, H, W, C = x.shape
    return x.reshape(B, H, W, s1, s2, C // (s1 * s2)).permute(
        0, 1, 3, 2, 4, 5).reshape(B, H * s1, W * s2, C // (s1 * s2))


class PatchEmbed(nn.Module):  # scale.py:26-50
    def __init__(self, freq, in_chans, patch, dim):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, patch)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x):
        x = self.proj(x)
        return self.norm(x.flatten(2).transpose(1, 2))


class PatchDeEmbed(nn.Module):  # scale.py:52-81
    def __init__(self, freq, in_chans, patch, dim):
        super().__init__()
        self.patch = patch
        self.H = freq // patch[0]
        self.de_proj1 = nn.Conv2d(dim, dim * patch[0] * patch[1], 5, 1, 2)
        self.de_proj2 = nn.Conv2d(dim, in_chans, 3, 1, 1)

    def forward(self, x):
        B, L, C = x.shape
        x = x.transpose(1, 2).reshape(B, C, self.H, L // self.H)
        x = self.de_proj1(x)
        x = px_shuffle(x.permute(0, 2, 3, 1), *self.patch)
        return self.de_proj2(x.permute(0, 3, 1, 2))


class PatchMerge(nn.Module):  # scale.py:83-115
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.norm = nn.LayerNorm(2 * in_dim, eps=LN_EPS)
        self.down = nn.Linear(2 * in_dim, out_dim, bias=False)

    def forward(self, x, H):
        B, L, C = x.shape
        x = x.reshape(B, H, L // H, C)
        if H % 2:
            x = F.pad(x, (0, 0, 0, 0, 0, 1))
        x = px_unshuffle(x, 2, 1).reshape(B, -1, 2 * C)
        return self.down(self.norm(x))


class PatchSplit(nn.Module):  # scale.py:117-145
    def __init__(self, in_dim, out_dim):
        super().__init__()
        self.norm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.up = nn.Linear(in_dim, out_dim * 2, bias=False)

    def forward(self, x, H):
        x = self.up(self.norm(x))
        B, L, C = x.shape
        x = x.reshape(B, H, L // H, C)
        return px_shuffle(x, 2, 1).reshape(B, -1, C // 2)


# ------------------------------------------------------------- attention
def win_part(x, ws):  # attention.py:246-250
    B, H, W, C = x.shape
    return x.reshape(B, H // ws, ws, W // ws, ws, C).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C)


def win_rev(w, ws, H, W):  # attention.py:252-256
    B = w.shape[0] // (H * W // ws // ws)
    return w.reshape(B, H // ws, W // ws, ws, ws, -1).permute(
        0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


class WindowAttention(nn.Module):  # attention.py:180-244
    def __init__(self, dim, ws, heads):
        super().__init__()
        self.ws, self.heads = ws, heads
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * ws - 1) ** 2, heads))
        c = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws),
                                       indexing="ij")).flatten(1)
        rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0)
        rel[:, :, 0] += ws - 1
        rel[:, :, 1] += ws - 1
        rel[:, :, 0] *= 2 * ws - 1
        self.register_buffer("relative_position_index", rel.sum(-1))
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        qkv = self.qkv(x).reshape(B_, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.reshape(-1)].reshape(N, N, -1)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, self.heads, N, N) \
                + mask[None, :, None]
            attn = attn.reshape(-1, self.heads, N, N)
        x = (attn.softmax(-1) @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(x)


class FeedForward(nn.Module):  # attention.py:258-272
    def __init__(self, dim, hidden):
        super().__init__()
        self.linear_1 = nn.Linear(dim, hidden)
        self.linear_2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x)))


class SwinBlock(nn.Module):  # attention.py:93-178
    def __init__(self, dim, heads, ws, shift, mlp_ratio):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, ws, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = FeedForward(dim, int(dim * mlp_ratio))

    def forward(self, x, H, W, mask):
        B, L, C = x.shape
        short = x
        x = self.norm1(x).reshape(B, H, W, C)
        pr = (self.ws - W % self.ws) % self.ws
        pb = (self.ws - H % self.ws) % self.ws
        x = F.pad(x, (0, 0, 0, pr, 0, pb))
        Hp, Wp = H + pb, W + pr
        if self.shift:
            x = torch.roll(x, (-self.shift, -self.shift), (1, 2))
        w = win_part(x, self.ws).reshape(-1, self.ws * self.ws, C)
        w = self.attn(w, mask if self.shift else None)
        x = win_rev(w.reshape(-1, self.ws, self.ws, C), self.ws, Hp, Wp)
        if self.shift:
            x = torch.roll(x, (self.shift, self.shift), (1, 2))
        x = x[:, :H, :W].reshape(B, L, C)
        x = short + x
        return x + self.mlp(self.norm2(x))


class TransformerLayer(nn.Module):  # attention.py:9-91
    def __init__(self, in_dim, out_dim, heads, depth, ws, mlp_ratio, scale):
        super().__init__()
        self.ws = ws
        self.shift = ws // 2
        self.swint_blocks = nn.ModuleList([
            SwinBlock(in_dim, heads, ws, 0 if i % 2 == 0 else ws // 2,
                      mlp_ratio) for i in range(depth)])
        self.subsample = (PatchMerge(in_dim, out_dim) if scale == "down"
                          else PatchSplit(in_dim, out_dim) if scale == "up"
                          else None)
        self.scale = scale

    def _mask(self, H, W, dev):
        ws, ss = self.ws, self.shift
        Hp = math.ceil(H / ws) * ws
        Wp = math.ceil(W / ws) * ws
        img = torch.zeros(1, Hp, Wp, 1, device=dev)
        sl = (slice(0, -ws), slice(-ws, -ss), slice(-ss, None))
        cnt = 0
        for h in sl:
            for w in sl:
                img[:, h, w] = cnt
                cnt += 1
        mw = win_part(img, ws).reshape(-1, ws * ws)
        am = mw.unsqueeze(1) - mw.unsqueeze(2)
        return am.masked_fill(am != 0, -100.0)

    def forward(self, x, H, W):
        mask = self._mask(H, W, x.device)
        for blk in self.swint_blocks:
            x = blk(x, H, W, mask)
        if self.scale == "down":
            return self.subsample(x, H), (H + 1) // 2, W
        if self.scale == "up":
            return self.subsample(x, H), H * 2, W
        return x, H, W


# ------------------------------------------------------------------- VQ
class Codebook(nn.Module):  # codebook.py:5-83
    def __init__(self, dim, num, l2norm):
        super().__init__()
        self.embedding = nn.Embedding(num, dim)
        self.l2norm = l2norm

    def distances(self, z):
        """(rows, K) squared distances of ``z``'s rows to the codewords."""
        cb = self.embedding.weight
        zf = z.reshape(-1, z.shape[-1])
        if self.l2norm:
            cb = F.normalize(cb, dim=-1)
            zf = F.normalize(zf, dim=-1)
        return (zf.pow(2).sum(1, keepdim=True) - 2 * zf @ cb.t()
                + cb.pow(2).sum(1, keepdim=True).t())

    def encode(self, z):
        return self.distances(z).min(1).indices.reshape(z.shape[0], -1)

    def decode(self, code):
        return F.embedding(code, self.embedding.weight)

    def forward(self, z_e):  # codebook.py:57-77 (training branch)
        code = self.encode(z_e)
        z_q = self.decode(code)
        cm = F.mse_loss(z_q.detach(), z_e, reduction="none").mean([1, 2])
        cb = F.mse_loss(z_q, z_e.detach(), reduction="none").mean([1, 2])
        z_q = z_e + (z_q - z_e).detach()  # straight-through estimator
        return z_q, code, cb, cm


class ProductVQ(nn.Module):  # quantization.py:7-136
    def __init__(self, in_dim, in_freq, overlap, num_vqs, cb_dim, cb_size,
                 l2norm):
        super().__init__()
        self.in_freq, self.overlap = in_freq, overlap
        self.fix_dim = in_freq * in_dim
        total = self.fix_dim * overlap
        if total % num_vqs == 0:  # quantization.py:380-386
            self.dims = [total // num_vqs] * num_vqs
        else:
            self.dims = [total // num_vqs] * (num_vqs - 1)
            self.dims.append(total - sum(self.dims))
        self.vqs = nn.ModuleList(
            [Codebook(cb_dim, cb_size, l2norm) for _ in self.dims])
        self.down_projs = nn.ModuleList(
            [nn.Linear(d, cb_dim, bias=False) for d in self.dims])
        self.up_projs = nn.ModuleList(
            [nn.Linear(cb_dim, d, bias=False) for d in self.dims])

    def _pre(self, z):  # quantization.py:388-410
        B, L, C = z.shape
        H = self.in_freq
        z = z.reshape(B, H, L // H, C).permute(0, 2, 3, 1).reshape(
            B, L // H, self.fix_dim)
        if self.overlap > 1:
            z = z.reshape(B, -1, self.overlap * self.fix_dim)
        return z

    def _post(self, z):  # quantization.py:412-432
        B = z.shape[0]
        if self.overlap > 1:
            z = z.reshape(B, -1, self.fix_dim)
        W = z.shape[1]
        H = self.in_freq
        z = z.reshape(B, W, -1, H).permute(0, 3, 1, 2)
        return z.reshape(B, H * W, -1)

    def _groups(self, z):
        z, s = self._pre(z), 0
        for m, dp in enumerate(self.down_projs):
            yield m, dp(z[..., s:s + self.dims[m]])
            s += self.dims[m]

    def encode(self, z):
        return torch.stack([self.vqs[m].encode(ze)
                            for m, ze in self._groups(z)], 1)

    def gaps(self, z, codes):
        """Per group, how far the distance of ``codes`` (B, groups, T) lies
        above the nearest codeword's: the widest, as a float."""
        worst = 0.0
        for m, ze in self._groups(z):
            d = self.vqs[m].distances(ze)
            got = d.gather(1, codes[:, m].reshape(-1, 1).long())[:, 0]
            worst = max(worst, float((got - d.min(1).values).max()))
        return worst

    def decode(self, codes):
        zq = [up(vq.decode(codes[:, m]))
              for m, (up, vq) in enumerate(zip(self.up_projs, self.vqs))]
        return self._post(torch.cat(zq, -1))

    def forward(self, z, freeze=False):  # quantization.py:32-72
        z_qs, codes = [], []
        cb_loss, cm_loss = 0.0, 0.0
        for m, z_e_m in self._groups(z):
            z_q_m, code, cb, cm = self.vqs[m](z_e_m)
            if freeze:  # codebook frozen in pretraining
                z_q_m = z_q_m * 0.0 + z_e_m
                cb, cm = cb * 0.0, cm * 0.0
            z_qs.append(self.up_projs[m](z_q_m))
            codes.append(code)
            cb_loss = cb_loss + cb
            cm_loss = cm_loss + cm
        return {"z_q": self._post(torch.cat(z_qs, -1)),
                "codes": torch.stack(codes, 1),
                "cb_loss": cb_loss / len(self.dims),
                "cm_loss": cm_loss / len(self.dims)}


# ---------------------------------------------------------------- codec
class Encoder(nn.Module):  # base.py:110-158
    def __init__(self, cfg):
        super().__init__()
        h = cfg["h_dims"]
        self.patch_embed = PatchEmbed(cfg["in_freq"], cfg["in_dim"],
                                      tuple(cfg["patch_size"]), h[0])
        self.pre_nn = TransformerLayer(h[0], h[0], cfg["swin_heads"][0],
                                       cfg["swin_depth"], cfg["window_size"],
                                       cfg["mlp_ratio"], None)
        self.blocks = nn.ModuleList([
            TransformerLayer(h[i], h[i + 1], cfg["swin_heads"][i],
                             cfg["swin_depth"], cfg["window_size"],
                             cfg["mlp_ratio"], "down")
            for i in range(len(h) - 1)])
        self.patch = cfg["patch_size"]

    def forward(self, feat):
        H, W = feat.shape[2] // self.patch[0], feat.shape[3] // self.patch[1]
        x = self.patch_embed(feat)
        x, H, W = self.pre_nn(x, H, W)
        hs = [x]
        for blk in self.blocks:
            x, H, W = blk(x, H, W)
            hs.append(x)
        return hs, (H, W)


class CSRVQDecoder(nn.Module):  # csrvq.py:63-183
    def __init__(self, cfg):
        super().__init__()
        h = cfg["h_dims"][::-1]
        heads = cfg["swin_heads"][::-1]
        self.blocks = nn.ModuleList([
            TransformerLayer(h[i], h[i + 1], heads[i], cfg["swin_depth"],
                             cfg["window_size"], cfg["mlp_ratio"], "up")
            for i in range(len(h) - 1)])
        self.post_nn = TransformerLayer(h[-1], h[-1], heads[-1],
                                        cfg["swin_depth"],
                                        cfg["window_size"],
                                        cfg["mlp_ratio"], None)
        self.patch_deembed = PatchDeEmbed(cfg["in_freq"], cfg["in_dim"],
                                          tuple(cfg["patch_size"]), h[-1])

    def encode(self, hs, s, qs, shape):  # csrvq.py:131-158
        H, W = shape
        code0 = qs[0].encode(hs[-1])
        if s == 1:
            return code0.unsqueeze(1)
        dec = qs[0].decode(code0)
        codes = [code0]
        for i in range(s - 1):
            ci = qs[i + 1].encode(hs[-1 - i] - dec)
            codes.append(ci)
            if len(codes) == s:
                break
            dec = qs[i + 1].decode(ci) + dec
            dec, H, W = self.blocks[i](dec, H, W)
        return torch.stack(codes, 1)

    def gaps(self, hs, codes, qs, shape):
        """:meth:`encode`'s walk, taking ``codes`` (B, s, groups, T) at
        each scale instead of its own choice: the widest distance gap."""
        H, W = shape
        s = codes.shape[1]
        worst = qs[0].gaps(hs[-1], codes[:, 0])
        dec = qs[0].decode(codes[:, 0])
        for i in range(s - 1):
            worst = max(worst, qs[i + 1].gaps(hs[-1 - i] - dec,
                                              codes[:, i + 1]))
            if i + 2 == s:
                break
            dec = qs[i + 1].decode(codes[:, i + 1]) + dec
            dec, H, W = self.blocks[i](dec, H, W)
        return worst

    def decode(self, codes, qs, shape):  # csrvq.py:160-183
        H, W = shape
        s = codes.shape[1]
        dec = qs[0].decode(codes[:, 0])
        for i in range(len(self.blocks)):
            if i < s - 1:
                dec = qs[i + 1].decode(codes[:, i + 1]) + dec
            dec, H, W = self.blocks[i](dec, H, W)
        dec, H, W = self.post_nn(dec, H, W)
        return self.patch_deembed(dec)

    def forward_train(self, enc_hs, num_streams, qs, shape, freeze=False):
        H, W = shape                                   # csrvq.py:105-130

        def one(enc, dec, vq, transmit):  # csrvq.py:23-49
            out = vq(enc - dec, freeze)
            rq, code = out["z_q"], out["codes"]
            cm, cb = out["cm_loss"], out["cb_loss"]
            if not transmit:  # masking non-transmitted streams
                cm, cb, rq = cm * 0.0, cb * 0.0, rq * 0.0
            return rq + dec, cm, cb, code

        z0, cm_loss, cb_loss, code = one(enc_hs[-1], 0.0, qs[0], True)
        codes, dec = [code], z0
        for i, blk in enumerate(self.blocks):
            d_ref, cm_i, cb_i, code_i = one(enc_hs[-1 - i], dec, qs[i + 1],
                                            i < num_streams - 1)
            cm_loss = cm_loss + cm_i
            cb_loss = cb_loss + cb_i
            codes.append(code_i)
            dec, H, W = blk(d_ref, H, W)
        dec, H, W = self.post_nn(dec, H, W)
        recon_feat = self.patch_deembed(dec)
        return recon_feat, torch.stack(codes, 1), cm_loss, cb_loss


class ESC(nn.Module):
    """Reference-equivalent ESC: encode, decode, the training forward."""

    def __init__(self, **cfg):
        super().__init__()
        self.cfg = cfg
        h = cfg["h_dims"]
        dec_h = h[::-1]
        Hb = cfg["in_freq"] // cfg["patch_size"][0]
        ms = cfg["max_streams"]
        qs = [ProductVQ(dec_h[0], Hb // 2 ** (ms - 1), cfg["overlap"],
                        cfg["group_size"], cfg["codebook_dims"][0],
                        cfg["codebook_size"], cfg["l2norm"])]
        for i in range(1, ms):
            qs.append(ProductVQ(dec_h[i - 1], Hb // 2 ** (ms - i),
                                cfg["overlap"], cfg["group_size"],
                                cfg["codebook_dims"][i],
                                cfg["codebook_size"], cfg["l2norm"]))
        self.quantizers = nn.ModuleList(qs)
        self.encoder = Encoder(cfg)
        self.decoder = CSRVQDecoder(cfg)

    @torch.no_grad()
    def encode(self, x, num_streams):
        hs, shape = self.encoder(stft(x, self.cfg["in_freq"]))
        return self.decoder.encode(hs, num_streams, self.quantizers,
                                   shape), shape

    @torch.no_grad()
    def code_gaps(self, x, codes):
        """(the widest amount by which a code of ``codes`` (B, s, groups,
        T), taken as given at every scale, lies above the nearest
        codeword's distance, 0 where each is the nearest; the bottom
        scale's grid for :meth:`decode`)."""
        hs, shape = self.encoder(stft(x, self.cfg["in_freq"]))
        return self.decoder.gaps(hs, codes, self.quantizers, shape), shape

    @torch.no_grad()
    def decode(self, codes, shape):
        feat = self.decoder.decode(codes, self.quantizers, shape)
        return istft(feat, self.cfg["in_freq"])

    def forward(self, x, num_streams, freeze_codebook=False):
        """codecs.py:30-69 forward_one_step (training path)."""
        if freeze_codebook:
            num_streams = self.cfg["max_streams"]
        x_feat = stft(x, self.cfg["in_freq"])
        enc_hs, feat_shape = self.encoder(x_feat)
        recon_feat, codes, cm_loss, cb_loss = self.decoder.forward_train(
            enc_hs, num_streams, self.quantizers, feat_shape,
            freeze_codebook)
        recon_x = istft(recon_feat, self.cfg["in_freq"])
        return {"cm_loss": cm_loss, "cb_loss": cb_loss, "raw_audio": x,
                "recon_audio": recon_x, "raw_feat": x_feat,
                "recon_feat": recon_feat, "codes": codes}


# ---------------------------------------------------------------- losses
MEL_WINDOWS = [32, 64, 128, 256, 512, 1024, 2048]  # generator_loss.py:7-8
MEL_BINS = [5, 10, 20, 40, 80, 160, 320]


def mel_filterbank(n_freqs, n_mels, sample_rate=16000):
    """Triangular HTK mel filterbank ``(n_freqs, n_mels)``, as
    ``torchaudio.functional.melscale_fbanks(norm=None, mel_scale="htk")``
    (copied from ``esc_tpu/ops/mel.py``)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0),
                                  hz_to_mel(sample_rate / 2.0), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


GRAD_FLOOR = 1e-4


class _PowerLaw(torch.autograd.Function):
    """``sign(s) (|s| + eps) ** p``; its derivative takes ``|s|`` no smaller
    than :data:`GRAD_FLOOR`, as the system defines it
    (``esc_tpu/modules/losses.py:20-29``: digital silence would otherwise
    blow the gradient up by about 1e6). The original's derivative is exact;
    the two differ only where a bin's magnitude is under 1e-4."""

    @staticmethod
    def forward(ctx, s, power, eps):
        ctx.save_for_backward(s)
        ctx.power, ctx.eps = power, eps
        return torch.sign(s) * (torch.abs(s) + eps) ** power

    @staticmethod
    def backward(ctx, grad):
        (s,) = ctx.saved_tensors
        mag = torch.clamp(torch.abs(s), min=GRAD_FLOOR)
        return ctx.power * (mag + ctx.eps) ** (ctx.power - 1.0) * grad, \
            None, None


def complex_stft_loss(raw_feat, recon_feat, power=0.3, eps=1e-10):
    """generator_loss.py:12-35 (power-law compressed L2), (B,)."""
    def pl(s):
        return _PowerLaw.apply(s, power, eps)
    return F.mse_loss(pl(raw_feat), pl(recon_feat),
                      reduction="none").mean([1, 2, 3])


def mel_spectrogram_loss(x, y, clamp_eps=1e-5, sr=16000):
    """generator_loss.py:37-75: 7-scale L1 mel + log-mel, (B,)."""
    loss = 0.0
    for w, m in zip(MEL_WINDOWS, MEL_BINS):
        fb = torch.from_numpy(mel_filterbank(w // 2 + 1, m, sr)).to(
            x.device, x.dtype)
        win = torch.hann_window(w, dtype=x.dtype, device=x.device)

        def mel(a):
            s = torch.stft(a, n_fft=w, hop_length=w // 4, win_length=w,
                           window=win, center=True, pad_mode="reflect",
                           return_complex=True).abs()
            return torch.einsum("bft,fm->bmt", s, fb)

        xm, ym = mel(x), mel(y)
        loss = loss + F.l1_loss(xm, ym, reduction="none").mean([1, 2])
        loss = loss + F.l1_loss(
            xm.clamp(min=clamp_eps).pow(2).log10(),
            ym.clamp(min=clamp_eps).pow(2).log10(),
            reduction="none").mean([1, 2])
    return loss
