"""esc_tpu_torch — the ESC speech codec in PyTorch, for NVIDIA Hopper GPUs.

A port of the JAX package ``esc_tpu``, which stays the reference: the same
weights (under the reference's torch key names) give the same codes. Plain
tensor code is PyTorch; the two TPU kernels of the serving path (the
codebook distance-argmin and the fused window attention) are CUDA C++
kernels for ``sm_90a`` under ``esc_tpu_torch/csrc``, built with ``nvcc`` at
first use.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, where every kernel runs its plain PyTorch version.
"""

import torch as _torch

__version__ = "0.1.0"

# Full-fp32 products, as esc_tpu pins jax_default_matmul_precision to
# "highest" (esc_tpu/__init__.py:50-53): TF32 would flip near-tie codebook
# assignments. cuDNN's default is TF32 on, which would reach the
# PatchEmbed / PatchDeEmbed convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
