"""PESQ-WB (ITU-T P.862.2) as a numpy perceptual model.

Port of ``esc_tpu/metrics_pesq.py``, the stand-in for the ``pesq`` C
library where that does not import: level alignment, the wideband input
high-pass, 32 ms Hann STFT, Bark-band pooling, frequency and short-term
gain compensation, Zwicker loudness, masked symmetric and asymmetric
disturbance, L6-over-320 ms and L2-over-time aggregation, raw score
``4.5 - 0.1 D - 0.0309 DA`` and the P.862.2 MOS-LQO mapping. Its
approximations of the ITU model are the JAX package's (analytic Bark bands
and hearing threshold, one constant delay, no bad-interval realignment), so
scores compare within this framework.

One repair against ``esc_tpu``: where either signal's centred frame-energy
track is all zero (a silent or constant degraded signal), the delay is 0
instead of the correlation's meaningless peak, which cropped the whole clip
and gave NaN; silence now scores the MOS floor.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["pesq_wb"]

FS = 16000
FRAME = 512          # 32 ms
HOP = 256            # 50% overlap
NBARK = 49
SP = 6.910853e-006   # P.862 power scale for 16 kHz
SL = 1.866055e-001   # P.862 loudness scale for 16 kHz
TARGET_POW = 1e7     # level-alignment target band power
ZWICKER_POW = 0.23


def _bark(f):
    f = np.asarray(f, np.float64)
    return 13.0 * np.arctan(7.6e-4 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


@functools.lru_cache(maxsize=1)
def _band_tables():
    """(pool matrix (NBARK, FRAME//2+1), centre Hz, width in bark,
    absolute threshold power per band)."""
    freqs = np.fft.rfftfreq(FRAME, 1.0 / FS)
    z = _bark(freqs)
    z_max = _bark(FS / 2)
    edges = np.linspace(0.0, z_max, NBARK + 1)
    lo, hi = edges[:-1], edges[1:]
    pool = ((z[None, :] >= lo[:, None]) & (z[None, :] < hi[:, None]))
    pool = pool.astype(np.float64)  # band power = SUM of member bins
    centre_z = 0.5 * (lo + hi)
    # invert bark -> Hz by interpolation on a dense grid
    fg = np.linspace(1.0, FS / 2, 4096)
    centre_hz = np.interp(centre_z, _bark(fg), fg)
    width_z = hi - lo
    # Terhardt absolute threshold (dB SPL), mapped to internal power so
    # thr(1 kHz) ~= 1e2 — the magnitude the ITU per-band table sits at
    # relative to the 1e7 level-aligned signal power
    khz = centre_hz / 1000.0
    thr_db = (3.64 * khz ** -0.8
              - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
              + 1e-3 * khz ** 4)
    thr_1k = 3.64 - 6.5 * np.exp(-0.6 * (1.0 - 3.3) ** 2) + 1e-3
    abs_thresh = 1e2 * 10.0 ** ((thr_db - thr_1k) / 10.0)
    return pool, centre_hz, width_z, abs_thresh


def _frames(x):
    n = 1 + max(0, len(x) - FRAME) // HOP
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    return x[idx]


def _bark_spectrogram(x):
    """(n_frames, NBARK) band powers, P.862-scaled."""
    pool, _, _, _ = _band_tables()
    w = np.hanning(FRAME + 1)[:-1]
    spec = np.fft.rfft(_frames(x) * w, axis=1)
    power = spec.real ** 2 + spec.imag ** 2
    return SP * power @ pool.T


def _highpass_100hz(x):
    """WB-mode input filter: 100 Hz high-pass (FFT brickwall with a
    raised-cosine knee, stand-in for the ITU IIR)."""
    n = len(x)
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / FS)
    g = np.clip((f - 50.0) / 50.0, 0.0, 1.0)
    g = 0.5 - 0.5 * np.cos(np.pi * g)
    return np.fft.irfft(X * g, n)


def _level_align(x):
    """Scale so that mean active band power (350-3250 Hz in the ITU
    model; full audible band here, WB) hits TARGET_POW."""
    n = len(x)
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / FS)
    band = (f >= 350.0) & (f <= 3250.0)
    # Parseval: mean-square power in band, guarded for silence
    p = 2.0 * np.sum(np.abs(X[band]) ** 2) / max(n, 1) ** 2
    if p <= 0:
        return x
    return x * np.sqrt(TARGET_POW / p)


def _estimate_delay(x, y, max_lag=FS // 4):
    """Constant delay of y vs x from frame-energy cross-correlation."""
    ex = np.log1p(np.sum(_frames(x) ** 2, axis=1))
    ey = np.log1p(np.sum(_frames(y) ** 2, axis=1))
    if len(ex) < 4:
        return 0
    ex = ex - ex.mean()
    ey = ey - ey.mean()
    if not ex.any() or not ey.any():  # nothing to align on
        return 0
    c = np.correlate(ey, ex, "full")
    lag_frames = int(np.argmax(c)) - (len(ex) - 1)
    lag = lag_frames * HOP
    return int(np.clip(lag, -max_lag, max_lag))


def _loudness(bands):
    """Zwicker loudness density per band. bands: (n, NBARK)."""
    _, _, _, thr = _band_tables()
    t = thr[None, :]
    mod = ((t / 0.5) ** ZWICKER_POW
           * ((0.5 + 0.5 * bands / t) ** ZWICKER_POW - 1.0))
    return SL * np.where(bands > t, mod, 0.0)


def pesq_wb(ref: np.ndarray, deg: np.ndarray, sr: int = FS) -> float:
    """Wideband PESQ MOS-LQO of ``deg`` against clean ``ref``.

    16 kHz inputs only (the reference repo always calls it at SR=16000,
    scripts/metrics.py:92). Returns NaN for sub-frame signals.
    """
    if sr != FS:
        raise ValueError(f"pesq_wb is 16 kHz-only, got sr={sr}")
    ref = np.asarray(ref, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    n = min(len(ref), len(deg))
    if n < 2 * FRAME:
        return float("nan")
    ref, deg = ref[:n], deg[:n]

    ref = _level_align(_highpass_100hz(ref))
    deg = _level_align(_highpass_100hz(deg))

    lag = _estimate_delay(ref, deg)
    if lag > 0:
        ref, deg = ref[:-lag] if lag else ref, deg[lag:]
    elif lag < 0:
        ref, deg = ref[-lag:], deg[:lag]
    if min(len(ref), len(deg)) < 2 * FRAME:
        return float("nan")
    m = min(len(ref), len(deg))
    ref, deg = ref[:m], deg[:m]

    R = _bark_spectrogram(ref)   # (n, NBARK)
    D = _bark_spectrogram(deg)
    _, _, width, thr = _band_tables()
    audible_r = np.sum(np.where(R > thr, R, 0.0) * width, axis=1)
    audible_d = np.sum(np.where(D > thr, D, 0.0) * width, axis=1)

    # silent-frame mask: only frames with audible reference energy
    # (speech-active) are scored, 40 dB below the loudest frame
    peak = float(audible_r.max())
    active = audible_r > peak * 1e-4 if peak > 0 \
        else np.zeros(len(R), bool)
    if active.sum() < 2:
        return float("nan")

    # frequency compensation: per-band linear response of the system,
    # estimated over active frames, clipped to [-20, +20] dB, applied
    # to the REFERENCE (P.862: partial compensation of filtering)
    num = (D[active] + 1e3).mean(axis=0)
    den = (R[active] + 1e3).mean(axis=0)
    h = np.clip(num / den, 1e-2, 1e2)
    Rc = R * h[None, :]

    # short-term gain compensation: per-frame total-power ratio,
    # smoothed, clipped, applied to the DEGRADED signal
    ratio = (np.sum(Rc * width, axis=1) + 5e5) / (np.sum(D * width, axis=1)
                                                  + 5e5)
    g = np.empty_like(ratio)
    prev = 1.0
    for i, r in enumerate(ratio):          # first-order smoothing, ITU 0.8
        prev = 0.8 * prev + 0.2 * r
        g[i] = prev
    Dc = D * np.clip(g, 3e-4, 5.0)[:, None]

    LR = _loudness(Rc)
    LD = _loudness(Dc)

    # masked disturbance: deadzone of 0.25*min per band
    diff = LD - LR
    mask = 0.25 * np.minimum(LD, LR)
    d = np.where(diff > mask, diff - mask,
                 np.where(diff < -mask, diff + mask, 0.0))

    # asymmetry factor: additive (coding) noise hurts more than
    # attenuation; ratio of band powers ^1.2, zeroed < 3, capped at 12
    af = ((Dc + 50.0) / (Rc + 50.0)) ** 1.2
    af = np.where(af < 3.0, 0.0, np.minimum(af, 12.0))

    wb = width[None, :]
    # frame disturbances: weighted L2 (symmetric), L1 (asymmetric)
    d_frame = np.sqrt(np.sum((d ** 2) * wb, axis=1) * np.sum(wb))
    da_frame = np.sum(np.abs(d * af) * wb, axis=1)

    # emphasis: quiet reference frames weigh less ((P+1e5)/1e7)^0.04
    emph = ((audible_r + 1e5) / 1e7) ** 0.04
    d_frame = np.minimum(d_frame / emph, 45.0)
    da_frame = np.minimum(da_frame / emph, 45.0 * 16.0)

    d_frame = d_frame[active]
    da_frame = da_frame[active]

    def _aggregate(v, p_intra=6.0, p_inter=2.0, span=20):
        # L6 over 320 ms windows, then L2 over windows (P.862 psqm).
        # Clips shorter than one span (possible after VAD trimming +
        # delay-dependent cropping of sub-second clips) aggregate over
        # the frames that exist instead of indexing past the end.
        if len(v) == 0:
            return 0.0
        span = min(span, len(v))
        nwin = len(v) - span + 1
        idx = np.arange(span)[None, :] + np.arange(nwin)[:, None]
        w = (np.mean(v[idx] ** p_intra, axis=1)) ** (1.0 / p_intra)
        return float(np.mean(w ** p_inter) ** (1.0 / p_inter))

    D_sym = _aggregate(d_frame)
    D_asym = _aggregate(da_frame)

    raw = 4.5 - 0.1 * D_sym - 0.0309 * D_asym
    # P.862.2 wideband MOS-LQO mapping
    mos = 0.999 + 4.0 / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    return float(mos)
