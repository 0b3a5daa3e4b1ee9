"""Bit-packed code serialization (``.escb`` version 1).

Port of the v1 format of ``esc_tpu/cli/bitstream.py``: codes are packed at
``ceil(log2(codebook_size))`` bits per symbol (10 for K = 1024) behind a
20-byte header, so a file lands at the nominal bitrate. Version 2 (range
coded, needs the native coder) is not ported yet: its files are refused.

Format (little-endian):
  magic  b"ESCB"            4 bytes
  version u8 (1), bits_per_code u8, num_streams u8, group_size u8,
  batch u16, T u32, feat_H u16, feat_W u32
  payload: codes flattened (B, S, G, T) row-major, LSB-first bits
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

__all__ = ["pack_codes", "unpack_codes"]

_MAGIC = b"ESCB"
_HEADER = "<BBBBHIHI"


def _bits_needed(codebook_size: int) -> int:
    return max(1, int(np.ceil(np.log2(codebook_size))))


def pack_codes(codes: np.ndarray, codebook_size: int,
               feat_shape: Tuple[int, int]) -> bytes:
    """codes ``(B, S, G, T)`` int -> ``.escb`` v1 bytes."""
    codes = np.asarray(codes)
    if codes.ndim != 4:
        raise ValueError(f"codes (B, S, G, T) expected, got {codes.shape}")
    B, S, G, T = codes.shape
    bits = _bits_needed(codebook_size)
    flat = codes.astype(np.uint64).reshape(-1)
    shifts = np.arange(bits, dtype=np.uint64)
    bitmat = ((flat[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    payload = np.packbits(bitmat.reshape(-1), bitorder="little").tobytes()
    header = _MAGIC + struct.pack(_HEADER, 1, bits, S, G, B, T,
                                  feat_shape[0], feat_shape[1])
    return header + payload


def unpack_codes(blob: bytes) -> Tuple[np.ndarray, Tuple[int, int]]:
    """``.escb`` v1 bytes -> (codes ``(B, S, G, T)`` int32, feat_shape)."""
    if blob[:4] != _MAGIC:
        raise ValueError("not an ESCB bitstream")
    ver, bits, S, G, B, T, fh, fw = struct.unpack(_HEADER, blob[4:20])
    if ver != 1:
        raise NotImplementedError(
            f".escb version {ver}: the port reads version 1 (bit-packed) only")
    n = B * S * G * T
    raw = np.frombuffer(blob[20:], dtype=np.uint8)
    bitvec = np.unpackbits(raw, bitorder="little")[: n * bits]
    bitmat = bitvec.reshape(n, bits).astype(np.uint64)
    flat = (bitmat << np.arange(bits, dtype=np.uint64)[None, :]).sum(axis=1)
    return flat.astype(np.int32).reshape(B, S, G, T), (fh, fw)
