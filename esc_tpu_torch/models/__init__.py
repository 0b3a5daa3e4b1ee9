from .codecs import (ESC, Codec, ESCModule, RVQCodecs, RVQModule, make_model,
                     model_dict)
from .discriminator import Discriminator

__all__ = ["Codec", "ESC", "ESCModule", "RVQCodecs", "RVQModule",
           "make_model", "model_dict", "Discriminator"]
