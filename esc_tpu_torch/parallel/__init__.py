"""Several devices: data-parallel training over ``torch.distributed`` (one
rank per card) and local replicas for serving and evaluation (one process,
every card). Port of ``esc_tpu/parallel``."""

from .chunked import decode_chunked_dp, encode_chunked_dp
from .mesh import DataParallel, init_distributed, process_is_main
from .replicas import Replicas

__all__ = ["DataParallel", "init_distributed", "process_is_main", "Replicas",
           "encode_chunked_dp", "decode_chunked_dp"]
