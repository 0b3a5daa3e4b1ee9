"""STOI, Short-Time Objective Intelligibility (Taal et al., 2011).

Port of ``esc_tpu/metrics_stoi.py``, numpy on the host: 10 kHz resampling,
energy-based silent-frame removal (40 dB), 256-sample 50 %-overlap Hann
frames zero-padded to a 512-point FFT, 15 third-octave bands from 150 Hz,
384 ms (30-frame) segments with normalisation and -15 dB clipping of the
degraded signal, and the mean correlation over all band/segment units.
Silent-frame removal makes the shapes depend on the data, so it stays on
the host. ``scipy.signal.resample_poly`` is used where scipy imports, else
a numpy version of the same filter.
"""

from __future__ import annotations

import functools

import numpy as np

try:  # scipy is optional
    from scipy.signal import resample_poly as _scipy_resample_poly
except ImportError:
    _scipy_resample_poly = None

__all__ = ["STOI", "stoi"]

FS = 10_000          # internal sample rate
FRAME = 256          # analysis frame (25.6 ms)
HOP = 128            # 50% overlap
NFFT = 512
NBANDS = 15          # third-octave bands
MIN_FREQ = 150.0     # first band center
SEG = 30             # frames per segment (384 ms)
DYN_RANGE = 40.0     # silent-frame removal threshold (dB)
BETA = -15.0         # lower SDR clipping bound (dB)


def _resample_poly(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """Polyphase rational resampling, scipy.signal.resample_poly
    semantics (Kaiser beta=5 windowed sinc, 10*max(up,down) half-taps,
    output length ceil(len*up/down)). Used when scipy is absent so the
    metric stays dependency-free; scipy's C path is preferred when
    importable because it is faster on long eval sets."""
    if _scipy_resample_poly is not None:
        return _scipy_resample_poly(x, up, down)
    if up == down:
        return x.copy()
    n_in = len(x)
    max_rate = max(up, down)
    half = 10 * max_rate
    # windowed-sinc low-pass at min(pi/up, pi/down), gain `up`
    t = np.arange(-half, half + 1, dtype=np.float64)
    fc = 1.0 / max_rate
    h = fc * np.sinc(fc * t) * np.kaiser(2 * half + 1, 5.0)
    h *= up / h.sum()  # firwin(scale=True): unity DC response, gain up
    # upsample by zero-stuffing, filter, downsample — done directly so
    # memory stays O(n_out * taps) without materializing the stuffed
    # signal: y[m] = sum_k h[m*down - k*up + half] * x[k]
    n_out = -(-n_in * up // down)
    m = np.arange(n_out)
    # contributing input index range per output sample
    y = np.zeros(n_out, np.float64)
    # valid k per m: m*down - half <= k*up <= m*down + half; anchor at
    # the max contributing k and sweep down the full tap width
    for k_off in range(-(2 * half) // up - 2, 1):
        k = (m * down + half) // up + k_off
        tap = m * down - k * up + half
        ok = (k >= 0) & (k < n_in) & (tap >= 0) & (tap <= 2 * half)
        y[ok] += h[tap[ok]] * x[k[ok]]
    return y


@functools.lru_cache(maxsize=1)
def _third_octave_matrix() -> np.ndarray:
    """(NBANDS, NFFT//2+1) 0/1 matrix pooling FFT bins into bands."""
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    cf = MIN_FREQ * 2.0 ** (np.arange(NBANDS) / 3.0)
    lo, hi = cf * 2 ** (-1 / 6), cf * 2 ** (1 / 6)
    return ((f[None, :] >= lo[:, None])
            & (f[None, :] < hi[:, None])).astype(np.float64)


def _frames(x: np.ndarray) -> np.ndarray:
    n = 1 + max(0, (len(x) - FRAME)) // HOP
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    return x[idx]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    """Drop frames where the CLEAN signal is >40 dB below its loudest
    frame (window-energy criterion), overlap-adding the survivors."""
    w = np.hanning(FRAME + 2)[1:-1]
    xf = _frames(x) * w
    energy = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = energy > energy.max() - DYN_RANGE
    if not keep.any():
        return x[:0], y[:0]
    xf = xf[keep]
    yf = (_frames(y) * w)[keep]

    def ola(frames):
        out = np.zeros(FRAME + HOP * (len(frames) - 1))
        norm = np.zeros_like(out)
        for i, fr in enumerate(frames):
            out[i * HOP:i * HOP + FRAME] += fr
            norm[i * HOP:i * HOP + FRAME] += w
        return out / np.maximum(norm, 1e-12)

    return ola(xf), ola(yf)


def _band_spectrogram(x: np.ndarray) -> np.ndarray:
    """(NBANDS, n_frames) third-octave band magnitudes."""
    w = np.hanning(FRAME + 2)[1:-1]
    spec = np.fft.rfft(_frames(x) * w, NFFT, axis=1)  # (n, 257)
    power = (spec.real ** 2 + spec.imag ** 2).T       # (257, n)
    return np.sqrt(_third_octave_matrix() @ power)    # (15, n)


def stoi(x: np.ndarray, y: np.ndarray, sr: int = 16000) -> float:
    """STOI of degraded ``y`` against clean ``x`` (mono float arrays).

    Returns a correlation-based score, ~1.0 for transparent signals,
    decreasing monotonically with degradation; NaN when fewer than one
    384 ms segment of active speech survives silence removal.
    """
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    n = min(len(x), len(y))
    x, y = x[:n], y[:n]
    if sr != FS:
        g = np.gcd(int(sr), FS)
        x = _resample_poly(x, FS // g, sr // g)
        y = _resample_poly(y, FS // g, sr // g)
    # Sub-frame (incl. zero-length) signals carry no 25.6 ms analysis
    # frame — NaN, like the <1-segment case below. Guards the pad_eval
    # collate, whose final partial batch pads with length-0 rows.
    if len(x) < FRAME:
        return float("nan")
    x, y = _remove_silent_frames(x, y)
    if len(x) < FRAME:
        return float("nan")

    X = _band_spectrogram(x)  # (15, M)
    Y = _band_spectrogram(y)
    M = X.shape[1]
    if M < SEG:
        return float("nan")

    # all 384ms segments, stride one frame: (n_seg, 15, SEG)
    starts = np.arange(M - SEG + 1)
    Xs = np.stack([X[:, s:s + SEG] for s in starts])
    Ys = np.stack([Y[:, s:s + SEG] for s in starts])

    # scale the degraded segment to the clean energy per band, then clip
    alpha = (np.linalg.norm(Xs, axis=2, keepdims=True)
             / (np.linalg.norm(Ys, axis=2, keepdims=True) + 1e-12))
    Yp = np.minimum(Ys * alpha, Xs * (1 + 10 ** (-BETA / 20.0)))

    xc = Xs - Xs.mean(axis=2, keepdims=True)
    yc = Yp - Yp.mean(axis=2, keepdims=True)
    num = (xc * yc).sum(axis=2)
    den = (np.linalg.norm(xc, axis=2) * np.linalg.norm(yc, axis=2) + 1e-12)
    return float(np.mean(num / den))


def _host(x) -> np.ndarray:
    """numpy from an array or a tensor on any device."""
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)


class STOI:
    """Batch STOI with optional per-utterance valid lengths, mirroring
    the PESQ / MelSpectrogramDistance / SISDR metric classes."""

    def __init__(self, sr: int = 16000):
        self.sr = sr

    def __call__(self, x, y, lengths=None) -> np.ndarray:
        x, y = _host(x), _host(y)
        out = np.empty(len(x), np.float64)
        for i in range(len(x)):
            n = int(lengths[i]) if lengths is not None else x.shape[1]
            out[i] = stoi(x[i, :n], y[i, :n], self.sr)
        return out
