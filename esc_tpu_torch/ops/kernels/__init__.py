"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper launches its kernel for CUDA tensors and counts the
launch in its ``launches`` attribute; for CPU tensors it runs the plain
version."""

from .codebook_argmin import codebook_argmin, codebook_argmin_plain
from .window_attention import window_attention, window_attention_plain

__all__ = ["codebook_argmin", "codebook_argmin_plain", "window_attention",
           "window_attention_plain", "KERNELS"]

# name -> (wrapper, plain version); chip_smoke.py and the tests walk it
KERNELS = {
    "codebook_argmin": (codebook_argmin, codebook_argmin_plain),
    "window_attention": (window_attention, window_attention_plain),
}
