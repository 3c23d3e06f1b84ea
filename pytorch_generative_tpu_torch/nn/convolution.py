"""Convolutional building blocks over NHWC tensors (counterpart of
``pytorch_generative_tpu/nn/convolution.py``).

Tensors stay NHWC, as in the JAX package. A 1x1 convolution keeps its weight
as an (in, out) matrix and runs as ``x @ W + b`` on the channel axis, as the
JAX package lowers it; other kernels keep OIHW weights and run ``F.conv2d`` on
an NCHW view of the input. ``ConvTranspose2d`` keeps torch's (in, out, kh,
kw) weight and runs ``F.conv_transpose2d`` the same way.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_generative_tpu_torch.ops import init as init_ops
from pytorch_generative_tpu_torch.ops import ln_cuda
from pytorch_generative_tpu_torch.ops.masks import causal_conv_mask


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv2d(nn.Module):
    """2-D convolution over NHWC inputs, torch default init."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, use_bias: bool = True, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        fan_in = in_channels * kh * kw
        self.pointwise = ((kh, kw) == (1, 1) and self.padding == (0, 0)
                          and self.stride == (1, 1))
        shape = ((in_channels, out_channels) if self.pointwise
                 else (out_channels, in_channels, kh, kw))
        self.weight = nn.Parameter(
            init_ops.torch_default_weight(generator, shape, fan_in))
        self.bias = (nn.Parameter(init_ops.torch_default_bias(
            generator, (out_channels,), fan_in)) if use_bias else None)

    def _conv(self, x, weight):
        if self.pointwise:
            return x @ weight
        y = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=self.stride,
                     padding=self.padding)
        return y.permute(0, 2, 3, 1)

    def forward(self, x):
        y = self._conv(x, self.weight)
        if self.bias is not None:
            y = y + self.bias
        return y


class ConvTranspose2d(nn.Module):
    """2-D transposed convolution over NHWC inputs, as
    ``torch.nn.ConvTranspose2d``: output size (in - 1) * stride - 2 *
    padding + kernel. The weight is torch's (in, out, kh, kw), which is the
    JAX package's (kh, kw, out, in) with its axes reversed; fan_in is
    out * kh * kw, as in torch and the JAX package."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding=0, use_bias: bool = True, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        fan_in = out_channels * kh * kw
        self.weight = nn.Parameter(init_ops.torch_default_weight(
            generator, (in_channels, out_channels, kh, kw), fan_in))
        self.bias = (nn.Parameter(init_ops.torch_default_bias(
            generator, (out_channels,), fan_in)) if use_bias else None)

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight,
                               stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 1)
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


class GatedActivation(nn.Module):
    """``activation_fn(top half of the channels) * sigmoid(bottom half)``,
    split on the last axis."""

    def __init__(self, activation_fn=torch.tanh):
        super().__init__()
        self.activation_fn = activation_fn

    def forward(self, x):
        c = x.shape[-1]
        if c % 2:
            raise ValueError(f"x must have an even number of channels, got {c}")
        top, gate = x[..., : c // 2], x[..., c // 2:]
        return self.activation_fn(top) * torch.sigmoid(gate)


def channel_layer_norm(x, scale, offset, eps: float = 1e-5):
    """LayerNorm over the last axis with biased variance, as the JAX package."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + offset


def _use_fused_ln(x, fused: bool) -> bool:
    """The JAX package's rule for the LayerNorm kernel (``ops/ln_cuda.py``),
    read at every call: asked for (``fused``, unless ``PGT_FUSED_LN``
    forces it: "1" on, any other value off), at least 1024 rows and C >= 8.
    Its TPU-backend term has no counterpart here: the kernel's wrapper
    dispatches on the device."""
    env = os.environ.get("PGT_FUSED_LN")
    want = fused if env is None else env == "1"
    c = x.shape[-1]
    return want and c >= 8 and x.numel() // c >= 1024


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel (last) axis, with ``scale`` and ``offset``.

    ``fused=True`` routes it through ``ops/ln_cuda.channel_layernorm`` (the
    CUDA kernel on the card, its plain version on the CPU) where
    ``_use_fused_ln`` allows.
    """

    def __init__(self, n_channels: int, eps: float = 1e-5, fused: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n_channels))
        self.offset = nn.Parameter(torch.zeros(n_channels))
        self.eps = eps
        self.fused = fused

    def forward(self, x):
        if _use_fused_ln(x, self.fused):
            return ln_cuda.channel_layernorm(x, self.scale, self.offset, self.eps)
        return channel_layer_norm(x, self.scale, self.offset, self.eps)
