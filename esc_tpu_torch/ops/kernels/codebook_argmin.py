"""Codebook distance-argmin: CUDA kernel wrapper and its plain PyTorch version.

Port of ``esc_tpu/ops/pallas/vq_kernels.py::codebook_argmin``. For each
query row: ``argmin_k(|z|^2 - 2 z.c_k + |c_k|^2)`` in fp32, the first index
on exact ties, code 0 for a row whose distances hold a NaN. The kernel is
``esc_tpu_torch/csrc/codebook_argmin.cu``.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["codebook_argmin", "codebook_argmin_plain"]


def codebook_argmin_plain(z: torch.Tensor, codebook: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version: (N, d), (K, d) float32 -> (N,) int32 codes.

    The distance expansion keeps the kernel's order, ``(zsq - 2 dot) + csq``.
    The argmin is the TPU kernel's two-pass min: the min distance, then the
    least index among the exact minima; a NaN makes the min NaN, no distance
    is ``<=`` it, and the row gets code 0.
    """
    z = z.float()
    codebook = codebook.float()
    K = codebook.shape[0]
    dist = ((z * z).sum(1, keepdim=True) - 2.0 * (z @ codebook.T)
            + (codebook * codebook).sum(1)[None, :])
    m = dist.min(1, keepdim=True).values
    idx = torch.arange(K, device=z.device, dtype=torch.int32)[None, :]
    cand = torch.where(dist <= m, idx, K)
    code = cand.min(1).values
    return torch.where(code >= K, 0, code).to(torch.int32)


def codebook_argmin(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook row for each query: (N, d), (K, d) -> (N,) int32.

    A CUDA tensor goes through the CUDA kernel; a CPU tensor through
    :func:`codebook_argmin_plain`.
    """
    if z.device.type == "cpu" and codebook.device.type == "cpu":
        return codebook_argmin_plain(z, codebook)
    if z.device.type != "cuda" or codebook.device != z.device:
        raise ValueError(f"z on {z.device} and codebook on {codebook.device}:"
                         " both must lie on one CUDA device")
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"float32 expected, got {z.dtype} and {codebook.dtype}")
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f"shapes (N, d) and (K, d) expected, got "
                         f"{tuple(z.shape)} and {tuple(codebook.shape)}")
    if not (z.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("z and codebook must be contiguous")
    if torch.is_grad_enabled() and (z.requires_grad or codebook.requires_grad):
        raise RuntimeError("codebook_argmin has no backward: call it under "
                           "torch.no_grad()")
    N, d = z.shape
    K = codebook.shape[0]
    out = torch.empty(N, dtype=torch.int32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_build.library().esc_codebook_argmin(
            z.data_ptr(), codebook.data_ptr(), out.data_ptr(), N, K, d,
            stream), "codebook_argmin")
    codebook_argmin.launches += 1
    return out


codebook_argmin.launches = 0
