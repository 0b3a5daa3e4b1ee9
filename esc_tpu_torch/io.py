"""WAV input/output and the codec's length padding.

Port of ``esc_tpu/train/data.py`` (``load_wav`` in its stdlib form,
``save_wav``, ``esc_pad_length``).
"""

from __future__ import annotations

import wave

import numpy as np

__all__ = ["load_wav", "save_wav", "esc_pad_length"]


def load_wav(path: str) -> np.ndarray:
    """float32 mono waveform in [-1, 1] (first channel) from a PCM WAV."""
    with wave.open(path, "rb") as f:
        n = f.getnframes()
        width = f.getsampwidth()
        ch = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch)[:, 0].copy()
    return x


def save_wav(path: str, x: np.ndarray, sr: int = 16000) -> None:
    """Write float32 [-1, 1] mono audio as PCM16 WAV."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    pcm = np.clip(x * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def esc_pad_length(n: int, hop: int = 80, patch_t: int = 2) -> int:
    """Smallest codec-grid-exact length >= ``n``: a multiple of the STFT hop
    whose frame count ``L/hop + 1`` is divisible by the time patch size."""
    k = -(-n // hop)
    while (k + 1) % patch_t:
        k += 1
    return k * hop
