"""Neural module library: the names of ``esc_tpu.modules``. Importing it
builds no kernel; a kernel is built at its first launch."""

from .convolution import Convolution2D, ConvolutionLayer
from .gan_loss import GANLoss, discriminator_loss, generator_loss
from .losses import ComplexSTFTLoss, MelSpectrogramLoss
from .scale import PatchDeEmbed, PatchEmbed, PatchMerge, PatchSplit
from .transformer import (FeedForward, SwinBlock, TransformerLayer,
                          WindowAttention)
from .vq import (Codebook, ProductResidualVectorQuantize,
                 ProductVectorQuantize, ResidualVectorQuantize)

__all__ = [
    "TransformerLayer", "SwinBlock", "WindowAttention", "FeedForward",
    "PatchEmbed", "PatchDeEmbed", "PatchMerge", "PatchSplit",
    "Codebook", "ProductVectorQuantize", "ResidualVectorQuantize",
    "ProductResidualVectorQuantize",
    "MelSpectrogramLoss", "ComplexSTFTLoss",
    "GANLoss", "discriminator_loss", "generator_loss",
    "ConvolutionLayer", "Convolution2D",
]
