"""The EnCodec 24 kHz baseline on PyTorch (port of
``esc_tpu/baselines/encodec``): the SEANet encoder and decoder with their
SLSTMs, a 32-stage Euclidean residual VQ, and the comparison wrapper that
resamples in and out. Its state dict has the released ``encodec_24khz``
keys (:func:`.convert.load_release` reads a released file); it runs no
kernel of the port."""

from .model import Encodec, EncodecModule, SEANetDecoder, SEANetEncoder
from .quantize import EncodecRVQ

__all__ = ["Encodec", "EncodecModule", "SEANetEncoder", "SEANetDecoder",
           "EncodecRVQ"]
