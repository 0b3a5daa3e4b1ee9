"""WAV input/output and the codec's length padding.

Port of ``esc_tpu/train/data.py`` (``load_wav``, ``save_wav``,
``esc_pad_length``); ``wav_frames`` reads a file's length from its chunk
headers alone. ``load_wav`` parses the RIFF chunks itself, as the JAX
package's native loader does (``native/wavio.cpp:99-125``): PCM 8/16/24/32,
IEEE float32 and ``WAVE_FORMAT_EXTENSIBLE``, the first channel of a
multichannel file, chunks of odd size padded to an even offset.
"""

from __future__ import annotations

import struct
import wave

import numpy as np

__all__ = ["load_wav", "save_wav", "wav_frames", "esc_pad_length"]

_PCM, _FLOAT, _EXTENSIBLE = 1, 3, 0xFFFE


def load_wav(path: str) -> np.ndarray:
    """float32 mono waveform in [-1, 1] (first channel) from a WAV file.

    PCM integers are scaled as the JAX package scales them (16 bit by
    2^15, 24 bit by 2^23, 32 bit by 2^31, 8 bit unsigned about 128); float32
    samples are taken as they are. Raises ``ValueError`` for a file that is
    not RIFF/WAVE, lacks a ``fmt `` or ``data`` chunk, or holds another
    sample format.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 44 or buf[:4] != b"RIFF" or buf[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    fmt = channels = bits = 0
    data = None
    pos = 12
    while pos + 8 <= len(buf):
        tag, size = buf[pos:pos + 4], struct.unpack_from("<I", buf, pos + 4)[0]
        body = pos + 8
        if tag == b"fmt " and size >= 16:
            fmt, channels = struct.unpack_from("<HH", buf, body)
            bits = struct.unpack_from("<H", buf, body + 14)[0]
            if fmt == _EXTENSIBLE and size >= 40:  # the sub-format's tag
                fmt = struct.unpack_from("<H", buf, body + 24)[0]
        elif tag == b"data":
            data = buf[body:min(body + size, len(buf))]
        pos = body + size + (size & 1)  # chunks start on even offsets
    if data is None or channels == 0:
        raise ValueError(f"missing fmt/data chunk: {path}")
    width = bits // 8
    kinds = {(_PCM, 8): np.uint8, (_PCM, 16): "<i2", (_PCM, 32): "<i4",
             (_FLOAT, 32): "<f4"}
    if (fmt, bits) == (_PCM, 24):
        n = len(data) // (3 * channels)
        b = np.frombuffer(data, np.uint8, n * 3 * channels).reshape(
            n, channels, 3)[:, 0].astype(np.int32)
        v = (b[:, 0] << 8) | (b[:, 1] << 16) | (b[:, 2] << 24)
        return (v >> 8).astype(np.float32) / np.float32(8388608.0)
    if (fmt, bits) not in kinds:
        raise ValueError(f"unsupported wav format {fmt}/{bits}bit: {path}")
    n = len(data) // (width * channels)
    x = np.frombuffer(data, kinds[(fmt, bits)], n * channels)
    x = x.reshape(n, channels)[:, 0]
    if fmt == _FLOAT:
        return x.astype(np.float32)
    if bits == 8:
        return (x.astype(np.float32) - 128.0) / np.float32(128.0)
    return x.astype(np.float32) / np.float32(2.0 ** (bits - 1))


def wav_frames(path: str) -> int:
    """Sample frames of a WAV file, from its ``fmt `` and ``data`` chunk
    headers (the samples are not read)."""
    block = None
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        end = f.seek(0, 2)
        pos = 12
        while pos + 8 <= end:
            f.seek(pos)
            tag, size = struct.unpack("<4sI", f.read(8))
            if tag == b"fmt " and size >= 16:
                channels = struct.unpack("<2xH", f.read(4))[0]
                f.seek(pos + 8 + 14)
                bits = struct.unpack("<H", f.read(2))[0]
                block = channels * bits // 8
            elif tag == b"data":
                if not block:
                    break
                return min(size, end - pos - 8) // block
            pos += 8 + size + (size & 1)
    raise ValueError(f"missing fmt/data chunk: {path}")


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
