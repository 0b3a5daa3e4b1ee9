"""Data-parallel training over ``torch.distributed`` (port of
``esc_tpu/parallel``)."""

from .mesh import DataParallel, init_distributed, process_is_main

__all__ = ["DataParallel", "init_distributed", "process_is_main"]
