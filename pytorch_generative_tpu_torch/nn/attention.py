"""Causal multi-head attention over image pixels and the image positional
encoding (counterpart of ``pytorch_generative_tpu/nn/attention.py``:
``CausalAttention``'s packed path, its fused-block gate and
``image_positional_encoding``)."""

from __future__ import annotations

import os

import torch
from torch import nn

from pytorch_generative_tpu_torch.nn.convolution import Conv2d
from pytorch_generative_tpu_torch.ops.attention_cuda import causal_attention_packed
from pytorch_generative_tpu_torch.ops.attn_block_cuda import attention_block_packed


def _use_fused_block():
    """PGT_FUSED_ATTN=1, read at every call as the JAX package reads it:
    the whole attention block in one kernel call (``ops/attn_block_cuda``)."""
    return os.environ.get("PGT_FUSED_ATTN") == "1"


def image_positional_encoding(shape, device=None, dtype=torch.float32):
    """(y, x) coordinate channels in [-0.5, 0.5), shape (N, H, W, 2), for
    an NHWC input of ``shape``: channel 0 varies along H, channel 1 along W."""
    n, h, w = shape[0], shape[1], shape[2]
    ys = torch.arange(h, device=device, dtype=dtype) / h - 0.5
    xs = torch.arange(w, device=device, dtype=dtype) / w - 0.5
    grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1)
    return grid.expand(n, h, w, 2)


class CausalAttention(nn.Module):
    """Autoregressively-masked multihead self-attention over pixels.

    q is projected from ``x`` alone; k and v come from one 1x1 projection of
    ``concat(x, extra_x)``, so extra input channels condition the values
    without shaping the attention pattern. With ``mask_center=True`` pixel i
    attends to pixels < i only and pixel 0's output is exactly 0. The packed
    (N, L, features) projections go straight into the flash kernel, which
    carves out the heads itself. With ``PGT_FUSED_ATTN=1``, a flat sequence
    and no ``extra_x``, the projections, the attention and the output
    projection run as one fused block (``attention_block_packed``) on the
    same parameters.
    """

    def __init__(self, in_channels: int, n_heads: int = 1,
                 embed_channels: int | None = None,
                 out_channels: int | None = None, mask_center: bool = False,
                 extra_input_channels: int = 0, generator=None):
        super().__init__()
        if os.environ.get("PGT_NO_FLASH") == "1":
            raise ValueError(
                "PGT_NO_FLASH=1: the port's attention runs on its flash kernels only; the "
                "plain attention route (the JAX package's use_flash=False) is not ported "
                "(ROADMAP.md A.3 and A.13)")
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
        if x.dim() == 3 and extra_x is None and _use_fused_block():
            return attention_block_packed(
                x, self.q_proj.weight, self.q_proj.bias, self.kv_proj.weight,
                self.kv_proj.bias, self.out_proj.weight, self.out_proj.bias,
                self.mask_center, self.n_heads)
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
