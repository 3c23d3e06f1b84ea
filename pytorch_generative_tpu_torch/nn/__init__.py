"""Neural-network building blocks over NHWC tensors."""

from pytorch_generative_tpu_torch.nn.attention import (
    CausalAttention,
    image_positional_encoding,
)
from pytorch_generative_tpu_torch.nn.convolution import (
    CausalConv2d,
    ChannelLayerNorm,
    Conv2d,
    ConvTranspose2d,
    GatedActivation,
)
from pytorch_generative_tpu_torch.nn.utils import VectorQuantizer

__all__ = ["CausalAttention", "CausalConv2d", "ChannelLayerNorm", "Conv2d",
           "ConvTranspose2d", "GatedActivation", "VectorQuantizer",
           "image_positional_encoding"]
