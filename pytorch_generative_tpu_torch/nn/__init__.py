"""Neural-network building blocks over NHWC tensors."""

from pytorch_generative_tpu_torch.nn.attention import CausalAttention
from pytorch_generative_tpu_torch.nn.convolution import (
    CausalConv2d,
    ChannelLayerNorm,
    Conv2d,
)

__all__ = ["CausalAttention", "CausalConv2d", "ChannelLayerNorm", "Conv2d"]
