"""The port's evaluation metrics against the JAX package's: the mel front end
at all seven scales, Mel distance and SI-SDR (whole and masked), the code
histogram and utilisation, STOI and PESQ.

Inputs are made from numpy seeds and go through both packages on the CPU.
Tolerances: float32 spectra and distances within rtol 1e-5 (two frameworks'
float32 sums), histograms and utilisation exact, the numpy metrics within
1e-5 (the port's copies run the same numpy code). The mel spectra are also
held, at the same tolerance, to a float64 numpy mel that shares no code
with either package, so that a mismatch says which side moved.
"""

import numpy as np
import pytest
import torch

import esc_tpu.metrics as jm
from esc_tpu.metrics_pesq import pesq_wb as jax_pesq_wb
from esc_tpu.metrics_stoi import stoi as jax_stoi
from esc_tpu.ops.mel import mel_spectrogram as jax_mel_spectrogram
from esc_tpu_torch import metrics as pm
from esc_tpu_torch.metrics_pesq import pesq_wb
from esc_tpu_torch.metrics_stoi import stoi
from esc_tpu_torch.modules import transformer as port_transformer
from esc_tpu_torch.ops import mel as port_mel
from esc_tpu_torch.ops import resample as port_resample
from esc_tpu_torch.ops import stft as port_stft
from esc_tpu_torch.ops.constants import on_device
from esc_tpu_torch.ops.mel import MEL_BINS, MEL_WINDOWS, mel_spectrogram
from tests.test_torch_port_conv import one_torch_thread  # noqa: F401

SCALES = list(zip(MEL_WINDOWS, MEL_BINS))


def _mel_float64(x, n_fft, n_mels, sr=16000):
    """torchaudio's MelSpectrogram (power 1, HTK, no norm, reflect-centred
    periodic Hann frames, hop n_fft // 4) in float64 numpy."""
    hop = n_fft // 4
    T = x.shape[-1] // hop + 1
    xp = np.pad(x.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)),
                mode="reflect")
    idx = np.arange(T)[:, None] * hop + np.arange(n_fft)[None, :]
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    mag = np.abs(np.fft.rfft(xp[:, idx] * win, axis=-1))      # (B, T, F)

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_pts = 700.0 * (10 ** (np.linspace(0.0, hz_to_mel(sr / 2), n_mels + 2)
                            / 2595.0) - 1.0)
    slopes = f_pts[None, :] - np.linspace(0.0, sr / 2, n_fft // 2 + 1)[:,
                                                                       None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / np.diff(f_pts)[:-1],
                                    slopes[:, 2:] / np.diff(f_pts)[1:]))
    return np.transpose(mag @ fb, (0, 2, 1))


def _speech_like(rng, n, f0=140.0):
    """Harmonics under a syllable-rate envelope, plus noise."""
    t = np.arange(n) / 16000.0
    x = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6)) / k
            for k in range(1, 8))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return (0.2 * env * x + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(3)
    x = np.stack([_speech_like(rng, 12000, f) for f in (110.0, 190.0)])
    y = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("n_fft,n_mels", SCALES, ids=[f"w{w}" for w, _ in
                                                       SCALES])
def test_mel_spectrogram_matches_at_every_scale(audio, n_fft, n_mels):
    x, _ = audio
    ours = mel_spectrogram(torch.from_numpy(x), n_fft, n_mels).numpy()
    theirs = np.asarray(jax_mel_spectrogram(x, n_fft, n_mels))
    truth = _mel_float64(x, n_fft, n_mels)
    assert ours.shape == theirs.shape == truth.shape == (
        2, n_mels, 12000 // (n_fft // 4) + 1)
    atol = 1e-5 * np.abs(truth).max()
    np.testing.assert_allclose(ours, truth, rtol=1e-5, atol=atol,
                               err_msg="the port against float64")
    np.testing.assert_allclose(
        ours, theirs, rtol=1e-5, atol=1e-5 * np.abs(theirs).max(),
        err_msg="the JAX package against float64: max abs error "
                f"{np.abs(theirs - truth).max():.3g}")


def test_cached_constants_are_read_only_and_not_shared():
    """The numpy constants that the port caches (DFT matrices, windows'
    overlap-add, mel filterbanks, the Swin mask and position index,
    resampling kernels) are shared by every caller of their cached
    function, so they are read-only; their tensors on a device are copies,
    on the CPU too, so that no write through a tensor reaches the cache."""
    arrays = [*port_stft._dft_matrices(32, 32),
              port_stft._ola_envelope(382, 320, 80, 10),
              port_mel.mel_filterbank(17, 5),
              port_transformer.swin_attention_mask(8, 8, 4, 2),
              port_transformer.relative_position_index(4, 4),
              port_resample.resample_kernel(2, 3),
              port_resample.julius_kernel(2, 3)]
    for a in arrays:
        assert not a.flags.writeable
        with pytest.raises(ValueError):
            a[(0,) * a.ndim] = 1
    cpu = torch.device("cpu")
    fwd = on_device(port_stft._dft_matrices, (32, 32), 0, cpu)
    fb = on_device(port_mel.mel_filterbank, (17, 5, 16000), -1, cpu)
    for t, a in ((fwd, arrays[0]), (fb, arrays[4])):
        assert not np.shares_memory(t.numpy(), a)
        np.testing.assert_array_equal(t.numpy(), a)
    mask = on_device(port_transformer.swin_attention_mask, (8, 8, 4, 2), -1,
                     cpu)
    assert not np.shares_memory(mask.numpy(), arrays[5])
    attn = port_transformer.WindowAttention(8, 4, 2)
    assert not np.shares_memory(attn.relative_position_index.numpy(),
                                arrays[6])


def test_mel_spectrogram_folds_pads_longer_than_the_signal(rng):
    # 2048-window scale: 1024 samples of reflection on a 600-sample clip
    x = rng.standard_normal((1, 600)).astype(np.float32)
    ours = mel_spectrogram(torch.from_numpy(x), 2048, 320).numpy()
    theirs = np.asarray(jax_mel_spectrogram(x, 2048, 320))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5,
                               atol=1e-5 * np.abs(theirs).max())


def test_mel_distance_and_sisdr_match(audio):
    x, y = audio
    np.testing.assert_allclose(pm.MelSpectrogramDistance()(x, y),
                               jm.MelSpectrogramDistance()(x, y), rtol=1e-5)
    np.testing.assert_allclose(pm.SISDR()(x, y), jm.SISDR()(x, y),
                               rtol=1e-5)


def test_masked_metrics_match_and_equal_the_unpadded_ones(rng):
    # a clip shorter than 1024 samples: the 2048-window scale reflects it
    # more than once
    lengths = np.array([11000, 900, 7001], np.int32)
    x = np.zeros((3, 11200), np.float32)
    y = np.zeros_like(x)
    for b, n in enumerate(lengths):
        x[b, :n] = _speech_like(rng, n, 100.0 + 60 * b)
        y[b, :n] = x[b, :n] + 0.03 * rng.standard_normal(n)
    for ours_fn, theirs_fn in ((pm.MelSpectrogramDistance(),
                                jm.MelSpectrogramDistance()),
                               (pm.SISDR(), jm.SISDR())):
        ours = ours_fn(x, y, lengths)
        np.testing.assert_allclose(ours, theirs_fn(x, y, lengths), rtol=1e-5)
        alone = [ours_fn(x[b:b + 1, :n], y[b:b + 1, :n])[0]
                 for b, n in enumerate(lengths)]
        np.testing.assert_allclose(ours, alone, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["whole", "masked"])
def test_entropy_counter_matches(rng, masked):
    ours, theirs = pm.EntropyCounter(64, 3, 3), jm.EntropyCounter(64, 3, 3)
    for _ in range(3):
        codes = rng.integers(0, 64, (4, 3, 3, 25)).astype(np.int32)
        codes[:, :, 0] %= 7      # a skewed codebook
        kw = {}
        if masked:
            kw = dict(lengths=rng.integers(0, 8000, 4), samples_per_code=320)
        ours.update(torch.from_numpy(codes), **kw)
        theirs.update(codes, **kw)
    np.testing.assert_array_equal(ours.counts, theirs.counts)
    assert ours.total_counts == theirs.total_counts
    assert ours.compute_utilization() == theirs.compute_utilization()


def test_stoi_matches(audio):
    x, y = audio
    for a, b in ((x[0], y[0]), (x[1], x[1]), (x[0], 0.5 * y[0])):
        np.testing.assert_allclose(stoi(a, b), jax_stoi(a, b), rtol=1e-5)
    np.testing.assert_allclose(pm.STOI()(torch.from_numpy(x), y),
                               jm.STOI()(x, y), rtol=1e-5)


def test_pesq_matches_away_from_silence(audio, rng):
    x, y = audio
    cases = [(x[0], y[0]), (x[1], x[1]), (x[0], 0.3 * y[0]),
             (x[1], x[1] + 0.2 * rng.standard_normal(x.shape[1]))]
    for a, b in cases:
        np.testing.assert_allclose(pesq_wb(a, b), jax_pesq_wb(a, b),
                                   rtol=1e-5)
    lengths = np.array([12000, 700])   # 700 samples: NaN on both sides
    ours = pm.PESQ()(x, y, lengths)
    theirs = jm.PESQ()(x, y, lengths)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)
    assert np.isnan(ours[1])


def test_pesq_of_silence_is_the_mos_floor():
    # esc_tpu gives NaN here (tests/test_pesq.py:180, its known failure):
    # the energy track of silence has no variance, and correlating it
    # cropped the clip away. The port takes no delay where a track is flat.
    # This is the one case the parity test above leaves out.
    t = np.arange(4000) / 16000.0
    ref = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    silent = pesq_wb(ref, 0.0 * ref)
    assert np.isnan(jax_pesq_wb(ref, 0.0 * ref))
    assert np.isfinite(silent) and 0.999 <= silent < 1.1, silent
    assert pesq_wb(ref, ref) > 4.0
