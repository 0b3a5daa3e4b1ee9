"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper launches its kernel for CUDA tensors and counts the
launch in its ``launches`` attribute; for CPU tensors it runs the plain
version. A replayed stage graph (:mod:`esc_tpu_torch.utils.graphs`) calls
no wrapper, so it counts nothing there: its chain counts its replays."""

from .codebook_argmin import codebook_argmin, codebook_argmin_plain
from .layer_norm import layer_norm, layer_norm_plain
from .snake import snake, snake_plain
from .window_attention import window_attention, window_attention_plain

__all__ = ["codebook_argmin", "codebook_argmin_plain", "layer_norm",
           "layer_norm_plain", "snake", "snake_plain", "window_attention",
           "window_attention_plain", "KERNELS"]

# name -> (wrapper, plain version); chip_smoke.py and the tests walk it
KERNELS = {
    "codebook_argmin": (codebook_argmin, codebook_argmin_plain),
    "window_attention": (window_attention, window_attention_plain),
    "layer_norm": (layer_norm, layer_norm_plain),
    "snake": (snake, snake_plain),
}
