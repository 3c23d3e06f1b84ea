"""(Convolutional) ImageGPT: a decoder-only Transformer over pixels
(counterpart of ``pytorch_generative_tpu/models/autoregressive/image_gpt.py``).

As in the JAX package, the learnable positional embedding is added to the
input image, each TransformerBlock has pre-LN residuals, and the model adds
an extra skip around every block. The transformer middle runs on flat
(N, L, C) sequences.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_generative_tpu_torch.models import base
from pytorch_generative_tpu_torch.nn import (
    CausalAttention,
    CausalConv2d,
    ChannelLayerNorm,
    Conv2d,
)

# The configuration of the JAX package's ``image_gpt.reproduce()``.
REPRODUCE_CONFIG = dict(
    in_channels=1, out_channels=1, in_size=28, n_transformer_blocks=8,
    n_attention_heads=2, n_embedding_channels=64, in_shape=(28, 28, 1))


def reproduce_loss(x, preds):
    """``reproduce()``'s loss: sigmoid BCE summed per image, batch mean (nats)."""
    n = x.shape[0]
    loss = F.binary_cross_entropy_with_logits(
        preds.reshape(n, -1), x.reshape(n, -1), reduction="none")
    return loss.sum(dim=1).mean()


class TransformerBlock(nn.Module):
    """An ImageGPT Transformer block (pre-LN attention + 4x GELU MLP)."""

    def __init__(self, n_channels: int, n_attention_heads: int, generator=None):
        super().__init__()
        self.ln1 = ChannelLayerNorm(n_channels)
        self.ln2 = ChannelLayerNorm(n_channels)
        self.attn = CausalAttention(
            in_channels=n_channels, n_heads=n_attention_heads,
            embed_channels=n_channels, out_channels=n_channels,
            generator=generator)
        self.mlp_conv1 = Conv2d(n_channels, 4 * n_channels, 1, generator=generator)
        self.mlp_conv2 = Conv2d(4 * n_channels, n_channels, 1, generator=generator)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp_conv2(F.gelu(self.mlp_conv1(self.ln2(x))))


class ImageGPT(base.AutoregressiveModel):
    """The ImageGPT model (operating on NHWC images, with per-block skips)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 in_size: int = 28, n_transformer_blocks: int = 8,
                 n_attention_heads: int = 4, n_embedding_channels: int = 16,
                 in_shape=None, sample_fn=None, generator=None):
        """Builds the model on the CPU; move it with ``.to(device)``.

        Args:
            generator: ``torch.Generator`` that drives the weight init.
            Others: as in the JAX package's ImageGPT.
        """
        in_shape = tuple(in_shape) if in_shape else (in_size, in_size, in_channels)
        super().__init__(in_shape=in_shape, sample_fn=sample_fn)
        h, w, c = in_shape
        self.pos = nn.Parameter(torch.zeros((1, h, w, c)))
        self.input_conv = CausalConv2d(
            True, in_channels, n_embedding_channels, 3, padding=1,
            generator=generator)
        self.blocks = nn.ModuleList(
            TransformerBlock(n_embedding_channels, n_attention_heads,
                             generator=generator)
            for _ in range(n_transformer_blocks))
        self.ln = ChannelLayerNorm(n_embedding_channels)
        self.out_conv = Conv2d(n_embedding_channels, out_channels, 1,
                               generator=generator)

    def forward(self, x):
        x = self.input_conv(x + self.pos)
        n, h, w, c = x.shape
        x = x.reshape(n, h * w, c)
        for block in self.blocks:
            x = x + block(x)
        return self.out_conv(self.ln(x.reshape(n, h, w, c)))

    def sample(self, n_samples=None, conditioned_on=None, *, generator=None,
               uniforms=None):
        """KV-cache incremental decoding (see ops/sampling.py)."""
        from pytorch_generative_tpu_torch.ops.sampling import image_gpt_sample_fast

        return image_gpt_sample_fast(self, n_samples, conditioned_on,
                                     generator=generator, uniforms=uniforms)

    def sample_naive(self, n_samples=None, conditioned_on=None, *,
                     generator=None, uniforms=None):
        """The generic full-forward-per-pixel raster sampler (base class)."""
        return super().sample(n_samples, conditioned_on, generator=generator,
                              uniforms=uniforms)
