"""Long files over several cards: the chunks of one file spread over replicas.

Port of ``esc_tpu/parallel/chunked.py``. ESC's Swin stack sees a bounded
span of time (4-patch windows, 2-patch shifts), so a long file splits into
chunks that are encoded apart, each with a margin of context on both sides;
the margin is the halo, cut on the host, so no card talks to another.

Uniform windows, unlike :meth:`esc_tpu_torch.models.Codec.encode_chunked`'s
margins clamped at the file's edges: every segment is W = chunk + 2 *
margin code frames long, its start clamped into [0, total - W] and snapped
down to the Swin window grid, and the kept centre is sliced at its offset.
One segment length serves the whole file, and a segment at an edge sees the
file's own samples, not zeros. The segments go out in waves of one segment
per replica (:class:`esc_tpu_torch.parallel.Replicas`); the last wave is
filled with copies of its last segment.

    dp = Replicas()                                   # every visible card
    codes, fs = encode_chunked_dp(model, x, num_streams=6, dp=dp)
    audio = decode_chunked_dp(model, codes, fs, dp=dp)

``dp=None`` is the same uniform-window pass, serially on the codec's own
device.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .replicas import Replicas

__all__ = ["encode_chunked_dp", "decode_chunked_dp"]


def _grid(module, chunk_seconds: float, margin_seconds: float,
          spc: int) -> Tuple[int, int]:
    """Chunk and margin in code frames, multiples of the Swin grid's
    ``window_size // overlap`` (the rounding of ``Codec._chunking``)."""
    align = max(1, module.window_size // module.overlap)
    chunk = max(align, (int(chunk_seconds * module.sr) // spc)
                // align * align)
    margin = max(align, -(-int(margin_seconds * module.sr) // spc)
                 // align * align)
    return chunk, margin


def _starts(total: int, chunk: int, W: int, align: int
            ) -> List[Tuple[int, int, int]]:
    """``(start, offset, kept)`` of each segment: chunk k keeps the codes
    ``[k * chunk, min((k + 1) * chunk, total))``, at ``offset`` in a segment
    of W frames from ``start``. Starts are snapped down to the Swin grid,
    so that every segment sees the whole file's shifted-window phase; a
    margin of at least one grid step keeps the kept span inside W."""
    metas = []
    for k in range(-(-total // chunk)):
        c0 = k * chunk
        c1 = min(c0 + chunk, total)
        s = min(max(c0 - (W - (c1 - c0)) // 2, 0), total - W)
        s = (s // align) * align
        assert 0 <= c0 - s and (c0 - s) + (c1 - c0) <= W
        metas.append((s, c0 - s, c1 - c0))
    return metas


def _waves(model, dp: Optional[Replicas], metas, fn, segment):
    """``fn(replica, segment(meta))`` for every segment, in waves of one
    segment per replica (the last wave filled with copies of its last);
    the outputs on the host, in the segments' order. ``dp=None`` is one
    replica, the codec on its own device."""
    dp = dp if dp is not None else Replicas([model.device])
    replicas = dp.replicate(model)
    n = len(replicas)
    outs = []
    for w0 in range(0, len(metas), n):
        segs = [segment(m) for m in metas[w0:w0 + n]]
        outs += dp.map(replicas, fn, segs + [segs[-1]] * (n - len(segs))
                       )[:len(segs)]
    return outs


def encode_chunked_dp(model, x, num_streams: int = 6,
                      dp: Optional[Replicas] = None,
                      chunk_seconds: float = 10.0,
                      margin_seconds: float = 1.0
                      ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Encode a long waveform ``(B, L)`` (or ``(L,)``) with its segments
    spread over ``dp``'s replicas. Returns (codes on the codec's device,
    the whole file's feat_shape), as ``Codec.encode_chunked`` does; a file
    no longer than one segment is encoded whole."""
    model._check_streams(num_streams)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[None]
    module = model.module
    spc = model._samples_per_code()
    L = x.shape[-1]
    fs_full = model.feat_shape(L)
    total = fs_full[1] // module.overlap
    chunk, margin = _grid(module, chunk_seconds, margin_seconds, spc)
    W = chunk + 2 * margin
    if total <= W:
        return model.encode(x, num_streams)
    need = total * spc
    if need > L:
        x = np.pad(x, ((0, 0), (0, need - L)))

    align = max(1, module.window_size // module.overlap)
    metas = _starts(total, chunk, W, align)

    def encode(replica, seg):
        return replica.encode(seg, num_streams)[0]

    coded = _waves(model, dp, metas, encode, lambda m: np.ascontiguousarray(
        x[:, m[0] * spc:(m[0] + W) * spc]))
    # each (B, ns, groups, W): keep the chunk's own codes
    pieces = [c[..., off:off + keep] for (_, off, keep), c in zip(metas,
                                                                  coded)]
    return torch.cat(pieces, dim=-1).to(model.device), fs_full


def decode_chunked_dp(model, codes, feat_shape: Tuple[int, int],
                      dp: Optional[Replicas] = None,
                      chunk_seconds: float = 10.0,
                      margin_seconds: float = 1.0,
                      crossfade: int = 160) -> torch.Tensor:
    """Decode long-file codes with their segments spread over ``dp``'s
    replicas: the seams joined by a linear crossfade of ``crossfade``
    samples, the result trimmed or padded to the whole file's length, as
    ``Codec.decode_chunked`` does. Returns the waveform on the codec's
    device."""
    if isinstance(codes, torch.Tensor):
        codes = codes.cpu().numpy()
    codes = np.asarray(codes)
    module = model.module
    spc = model._samples_per_code()
    total = codes.shape[-1]
    chunk, margin = _grid(module, chunk_seconds, margin_seconds, spc)
    W = chunk + 2 * margin
    if total <= W:
        return model.decode(codes, feat_shape)

    align = max(1, module.window_size // module.overlap)
    metas = _starts(total, chunk, W, align)
    seg_fs = (feat_shape[0], W * module.overlap)

    def decode(replica, seg):
        return replica.decode(seg, seg_fs)

    decoded = [y.numpy() for y in _waves(
        model, dp, metas, decode,
        lambda m: np.ascontiguousarray(codes[..., m[0]:m[0] + W]))]
    out = None
    for (s, off, keep), y in zip(metas, decoded):
        kept = y[:, off * spc:(off + keep) * spc].copy()
        if out is None:
            out = kept
            continue
        xf = min(crossfade, kept.shape[-1], out.shape[-1], off * spc)
        if xf > 0:
            # fade from the previous chunk into this segment's decode of
            # the samples before its kept span
            prev_tail = y[:, off * spc - xf:off * spc]
            w = np.linspace(0.0, 1.0, xf, dtype=np.float32)[None]
            out[:, -xf:] = out[:, -xf:] * (1 - w) + prev_tail * w
        out = np.concatenate([out, kept], axis=-1)
    expected = (feat_shape[1] * module.patch_size[1] - 1) * model._hop()
    if out.shape[-1] < expected:
        out = np.pad(out, ((0, 0), (0, expected - out.shape[-1])))
    return torch.from_numpy(out[:, :expected]).to(model.device)
