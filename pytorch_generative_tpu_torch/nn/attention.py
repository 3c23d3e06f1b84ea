"""Causal multi-head attention over image pixels (counterpart of
``pytorch_generative_tpu/nn/attention.py::CausalAttention``, packed path)."""

from __future__ import annotations

import torch
from torch import nn

from pytorch_generative_tpu_torch.nn.convolution import Conv2d
from pytorch_generative_tpu_torch.ops.attention_cuda import causal_attention_packed


class CausalAttention(nn.Module):
    """Autoregressively-masked multihead self-attention over pixels.

    q is projected from ``x`` alone; k and v come from one 1x1 projection of
    ``concat(x, extra_x)``, so extra input channels condition the values
    without shaping the attention pattern. With ``mask_center=True`` pixel i
    attends to pixels < i only and pixel 0's output is exactly 0. The packed
    (N, L, features) projections go straight into the flash kernel, which
    carves out the heads itself.
    """

    def __init__(self, in_channels: int, n_heads: int = 1,
                 embed_channels: int | None = None,
                 out_channels: int | None = None, mask_center: bool = False,
                 extra_input_channels: int = 0, generator=None):
        super().__init__()
        self.n_heads = n_heads
        self.embed_channels = embed_channels or in_channels
        self.out_channels = out_channels or in_channels
        self.mask_center = mask_center
        self.q_proj = Conv2d(in_channels, self.embed_channels, 1,
                             generator=generator)
        self.kv_proj = Conv2d(in_channels + extra_input_channels,
                              self.embed_channels + self.out_channels, 1,
                              generator=generator)
        self.out_proj = Conv2d(self.out_channels, self.out_channels, 1,
                               generator=generator)

    def forward(self, x, extra_x=None):
        """Accepts NHWC images (N, H, W, C) or flat sequences (N, L, C)."""
        shape = x.shape
        q = self.q_proj(x)
        if extra_x is not None:
            x = torch.cat([x, extra_x], dim=-1)
        kv = self.kv_proj(x)
        flat = lambda t: t.reshape(shape[0], -1, t.shape[-1])
        kv = flat(kv)
        out = causal_attention_packed(
            flat(q), kv[..., : self.embed_channels],
            kv[..., self.embed_channels:], self.mask_center, self.n_heads)
        return self.out_proj(out.reshape(*shape[:-1], self.out_channels))
