"""The work a step needs, counted from shapes and from the plain reference.

- :func:`main_path_calls` is a frozen copy of ``chip_smoke.py``'s: the
  shapes of the codebook-argmin and window-attention calls that one
  ``roundtrip(x, num_streams)`` of ESC makes, from the configuration alone.
  So a kernel's roofline share reads the same work whatever implements it.
- :func:`argmin_work` and :func:`attention_work` give each call's bytes
  (every input read once, the output written once) and fp32 operations, as
  ``chip_smoke.py`` counts them; :func:`bound_s` the least time the card
  could take for them.
- :func:`model_flops` counts the floating-point operations of a function
  of the plain reference with ``torch.utils.flop_counter.FlopCounterMode``:
  matrix products, batched products and convolutions, forward and
  backward (the codebook distances are matrix products, so they count).
  Elementwise work, normalisation, softmax and the FFTs of ``torch.stft``
  are not counted, as a model FLOP count leaves them out.

Peaks: one NVIDIA H100 SXM, 3.35 TB/s of HBM and 67 TFLOP/s of fp32 off the
tensor cores (NVIDIA's data sheet). The programs run fp32 with TF32 off, so
67 TFLOP/s is the peak that applies.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "main_path_calls",
           "argmin_work", "attention_work", "bound_s", "model_flops"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def main_path_calls(cfg: dict, batch: int, length: int, num_streams: int
                    ) -> Tuple[List[tuple], List[tuple]]:
    """The kernel calls of one ``roundtrip(x, num_streams)`` on ``batch``
    clips of ``length`` samples: a list of argmin shapes (N, K, d) and of
    attention shapes (G, nh, hd, masked)."""
    hop = int(cfg["hop_len"] * cfg["sr"] * 1e-3)
    ws, depth = cfg["window_size"], cfg["swin_depth"]
    H = cfg["in_freq"] // cfg["patch_size"][0]
    W = (length // hop + 1) // cfg["patch_size"][1]
    h, heads = cfg["h_dims"], cfg["swin_heads"]
    attn = []

    def layer(Hl, C, nh):
        G = batch * (-(-Hl // ws)) * (-(-W // ws))
        attn.extend((G, nh, C // nh, i % 2 == 1) for i in range(depth))

    enc_H = [H]
    for _ in range(len(h) - 1):
        enc_H.append((enc_H[-1] + 1) // 2)
    layer(enc_H[0], h[0], heads[0])                 # encoder pre_nn
    for i in range(len(h) - 1):                     # encoder blocks
        layer(enc_H[i], h[i], heads[i])
    dec_h, dec_heads, dec_H = h[::-1], heads[::-1], enc_H[::-1]
    for i in range(num_streams - 2):                # decoder.encode's
        layer(dec_H[i], dec_h[i], dec_heads[i])
    for i in range(len(h) - 1):                     # decoder.decode's blocks
        layer(dec_H[i], dec_h[i], dec_heads[i])
    layer(dec_H[-1], dec_h[-1], dec_heads[-1])      # post_nn
    n_rows = batch * W // cfg["overlap"]
    argmin = [(n_rows, cfg["codebook_size"], cfg["codebook_dims"][s])
              for s in range(num_streams) for _ in range(cfg["group_size"])]
    return argmin, attn


def argmin_work(N: int, K: int, d: int) -> Tuple[float, float]:
    """(bytes, operations) of one search of N rows in K codewords of d:
    rows, codebook and indices once; a product and three operations per
    distance."""
    return 4.0 * (N * d + K * d + N), 2.0 * N * K * d + 3.0 * N * K


def attention_work(G: int, nh: int, hd: int, masked: bool, batch: int
                   ) -> Tuple[float, float]:
    """(bytes, operations) of one call over G windows of 16 tokens: qkv in
    and the output once, the bias table of each head, and the shift mask
    of each window of one clip (G / batch of them); two products of 16 x 16
    by hd and five operations per score."""
    C = nh * hd
    nbytes = 4.0 * (G * 16 * 4 * C + nh * 256
                    + (G // batch * 256 if masked else 0))
    return nbytes, float(G * nh * (4 * 256 * hd + 5 * 256))


def bound_s(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time for the work on one H100, and which bound sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def model_flops(fn: Callable[[], object]) -> int:
    """The floating-point operations ``fn()`` runs, forward and backward,
    by ``FlopCounterMode`` (see the module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
