"""The DAC (Descript Audio Codec) baseline on PyTorch (port of
``esc_tpu/baselines/dac``): a snake-activation 1-D convolution encoder, a
residual VQ of factorised cosine codebooks with per-sample quantizer
dropout, a transposed-convolution decoder, the windowed ``.dac`` file codec
and the DNS-style trainers. The codebook search is the port's argmin kernel
(:mod:`esc_tpu_torch.ops.kernels.codebook_argmin`)."""

from .model import DAC, DACFile
from .quantize import ResidualVectorQuantize, VectorQuantize

__all__ = ["DAC", "DACFile", "ResidualVectorQuantize", "VectorQuantize"]
