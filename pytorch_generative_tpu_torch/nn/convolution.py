"""Convolutional building blocks over NHWC tensors (counterpart of
``pytorch_generative_tpu/nn/convolution.py``).

Tensors stay NHWC, as in the JAX package. A 1x1 convolution keeps its weight
as an (in, out) matrix and runs as ``x @ W + b`` on the channel axis, as the
JAX package lowers it; other kernels keep OIHW weights and run ``F.conv2d`` on
an NCHW view of the input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_generative_tpu_torch.ops import init as init_ops
from pytorch_generative_tpu_torch.ops.masks import causal_conv_mask


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2d(nn.Module):
    """2-D convolution (stride 1) over NHWC inputs, torch default init."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 padding=0, use_bias: bool = True, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.padding = _pair(padding)
        fan_in = in_channels * kh * kw
        self.pointwise = (kh, kw) == (1, 1) and self.padding == (0, 0)
        shape = ((in_channels, out_channels) if self.pointwise
                 else (out_channels, in_channels, kh, kw))
        self.weight = nn.Parameter(
            init_ops.torch_default_weight(generator, shape, fan_in))
        self.bias = (nn.Parameter(init_ops.torch_default_bias(
            generator, (out_channels,), fan_in)) if use_bias else None)

    def _conv(self, x, weight):
        if self.pointwise:
            return x @ weight
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=self.padding)
        return y.permute(0, 2, 3, 1)

    def forward(self, x):
        y = self._conv(x, self.weight)
        if self.bias is not None:
            y = y + self.bias
        return y


class CausalConv2d(Conv2d):
    """Conv2d masked to respect the raster-scan autoregressive order.

    ``mask_center=True`` (type-A) also masks the current pixel. The mask is a
    constant buffer applied as ``conv(x, w * mask)``. No channel masking.
    """

    def __init__(self, mask_center: bool, in_channels: int, out_channels: int,
                 kernel_size, padding=0, use_bias: bool = True, generator=None):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=padding, use_bias=use_bias,
                         generator=generator)
        if self.pointwise:
            raise ValueError("a causal conv needs a kernel wider than 1x1")
        self.register_buffer(
            "mask", causal_conv_mask(_pair(kernel_size), mask_center))

    def forward(self, x):
        y = self._conv(x, self.weight * self.mask)
        if self.bias is not None:
            y = y + self.bias
        return y


def channel_layer_norm(x, scale, offset, eps: float = 1e-5):
    """LayerNorm over the last axis with biased variance, as the JAX package."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + offset


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis, with ``scale`` and ``offset``."""

    def __init__(self, n_channels: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n_channels))
        self.offset = nn.Parameter(torch.zeros(n_channels))
        self.eps = eps

    def forward(self, x):
        return channel_layer_norm(x, self.scale, self.offset, self.eps)
