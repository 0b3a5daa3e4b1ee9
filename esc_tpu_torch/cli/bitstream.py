"""Code serialization, the ``.escb`` format (versions 1 and 2).

Port of ``esc_tpu/cli/bitstream.py``; for the same codes the bytes are the
same. Version 1 packs codes at ``ceil(log2(codebook_size))`` bits per symbol
(10 for K = 1024) behind a 20-byte header, so a file lands at the nominal
bitrate. Version 2 range-codes them with one adaptive model per (stream,
group) context (:mod:`esc_tpu_torch.rangecoder`, the repo's
``native/rangecoder.cpp``) over the alphabet ``1 << bits``; :func:`pack_codes`
writes it where its payload is smaller than version 1's.

Format (little-endian):
  magic  b"ESCB"            4 bytes
  version u8 (1 or 2), bits_per_code u8, num_streams u8, group_size u8,
  batch u16, T u32, feat_H u16, feat_W u32
  payload: codes flattened (B, S, G, T) row-major; v1 LSB-first bits,
           v2 the range coder's bytes
"""

from __future__ import annotations

import struct
import sys
from typing import Tuple

import numpy as np

from .. import rangecoder

__all__ = ["pack_codes", "unpack_codes"]

_MAGIC = b"ESCB"
_HEADER = "<BBBBHIHI"


def _bits_needed(codebook_size: int) -> int:
    return max(1, int(np.ceil(np.log2(codebook_size))))


def _contexts(B: int, S: int, G: int, T: int) -> np.ndarray:
    """Per-symbol context id ``stream * G + group``, in (B, S, G, T)
    order."""
    ctx = (np.arange(S)[:, None] * G + np.arange(G)[None, :]).astype(np.int32)
    return np.broadcast_to(ctx[None, :, :, None], (B, S, G, T)).reshape(-1)


def pack_codes(codes: np.ndarray, codebook_size: int,
               feat_shape: Tuple[int, int], entropy: bool = True) -> bytes:
    """codes ``(B, S, G, T)`` int -> ``.escb`` bytes: version 2 where
    ``entropy`` and the range-coded payload is the smaller, else version 1.

    Where the range coder cannot be built, the file is version 1 and a
    line on standard error says so.
    """
    codes = np.asarray(codes)
    if codes.ndim != 4:
        raise ValueError(f"codes (B, S, G, T) expected, got {codes.shape}")
    B, S, G, T = codes.shape
    bits = _bits_needed(codebook_size)
    flat = codes.astype(np.uint64).reshape(-1)
    shifts = np.arange(bits, dtype=np.uint64)
    bitmat = ((flat[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    payload = np.packbits(bitmat.reshape(-1), bitorder="little").tobytes()
    version = 1
    if entropy:
        try:
            # the alphabet is 1 << bits, so that the decoder, which sees
            # only bits, builds the same models for any codebook size
            coded = rangecoder.encode(codes.astype(np.int32).reshape(-1),
                                      _contexts(B, S, G, T), 1 << bits, S * G)
        except (RuntimeError, OSError) as err:
            print(f"escb: range coder unavailable, writing version 1: "
                  f"{str(err).splitlines()[0]}", file=sys.stderr)
        else:
            if len(coded) < len(payload):
                payload, version = coded, 2
    header = _MAGIC + struct.pack(_HEADER, version, bits, S, G, B, T,
                                  feat_shape[0], feat_shape[1])
    return header + payload


def unpack_codes(blob: bytes) -> Tuple[np.ndarray, Tuple[int, int]]:
    """``.escb`` bytes -> (codes ``(B, S, G, T)`` int32, feat_shape).

    Version 2 needs the range coder; where it cannot be built this raises.
    """
    if blob[:4] != _MAGIC:
        raise ValueError("not an ESCB bitstream")
    ver, bits, S, G, B, T, fh, fw = struct.unpack(_HEADER, blob[4:20])
    n = B * S * G * T
    if ver == 2:
        flat = rangecoder.decode(blob[20:], _contexts(B, S, G, T), 1 << bits,
                                 S * G)
        return flat.reshape(B, S, G, T), (fh, fw)
    if ver != 1:
        raise ValueError(f"unsupported .escb version {ver}")
    raw = np.frombuffer(blob[20:], dtype=np.uint8)
    bitvec = np.unpackbits(raw, bitorder="little")[: n * bits]
    bitmat = bitvec.reshape(n, bits).astype(np.uint64)
    flat = (bitmat << np.arange(bits, dtype=np.uint64)[None, :]).sum(axis=1)
    return flat.astype(np.int32).reshape(B, S, G, T), (fh, fw)
