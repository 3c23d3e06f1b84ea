"""Building blocks of the VAE family over NHWC tensors (counterpart of the
parts of ``pytorch_generative_tpu/models/vae/vaes.py`` that ``vq_vae``
uses): residual blocks, the strided encoder and decoder, the quantizer.
Attribute names follow the JAX package, so ``convert.from_jax_params`` maps
its weights onto these modules' ``state_dict``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from pytorch_generative_tpu_torch.nn import Conv2d, ConvTranspose2d, VectorQuantizer


class ResidualBlock(nn.Module):
    """x + conv1x1(relu(conv3x3(relu(x))))."""

    def __init__(self, n_channels: int, hidden_channels: int, generator=None):
        super().__init__()
        self.conv1 = Conv2d(n_channels, hidden_channels, 3, padding=1,
                            generator=generator)
        self.conv2 = Conv2d(hidden_channels, n_channels, 1, generator=generator)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class ResidualStack(nn.Module):
    """A stack of ResidualBlocks followed by a ReLU."""

    def __init__(self, n_channels: int, hidden_channels: int,
                 n_residual_blocks: int = 1, generator=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            ResidualBlock(n_channels, hidden_channels, generator=generator)
            for _ in range(n_residual_blocks))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return F.relu(x)


class Encoder(nn.Module):
    """stride // 2 stages of 4x4 stride-2 convs (the first stages to
    hidden_channels // 2), each with a ReLU, then a ResidualStack and a
    3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 n_residual_blocks: int, residual_channels: int, stride: int,
                 generator=None):
        super().__init__()
        if stride % 2:
            raise ValueError('"stride" must be even.')
        n_stages = stride // 2
        convs = []
        for i in range(n_stages):
            in_c = in_channels if i == 0 else hidden_channels // 2
            out_c = hidden_channels // 2 if i < n_stages - 1 else hidden_channels
            convs.append(Conv2d(in_c, out_c, 4, stride=2, padding=1, generator=generator))
        self.down_convs = nn.ModuleList(convs)
        self.residual_stack = ResidualStack(hidden_channels, residual_channels,
                                            n_residual_blocks, generator=generator)
        self.out_conv = Conv2d(hidden_channels, out_channels, 3, padding=1,
                               generator=generator)

    def forward(self, x):
        for conv in self.down_convs:
            x = F.relu(conv(x))
        return self.out_conv(self.residual_stack(x))


class Decoder(nn.Module):
    """A 3x3 conv and a ResidualStack, then stride // 2 stages of 4x4
    stride-2 transposed convs with a ReLU between them."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 n_residual_blocks: int, residual_channels: int, stride: int,
                 generator=None):
        super().__init__()
        if stride % 2:
            raise ValueError('"stride" must be even.')
        n_stages = stride // 2
        self.in_conv = Conv2d(in_channels, hidden_channels, 3, padding=1,
                              generator=generator)
        self.residual_stack = ResidualStack(hidden_channels, residual_channels,
                                            n_residual_blocks, generator=generator)
        convs = []
        for i in range(n_stages):
            in_c = hidden_channels if i == 0 else hidden_channels // 2
            out_c = hidden_channels // 2 if i < n_stages - 1 else out_channels
            convs.append(ConvTranspose2d(in_c, out_c, 4, stride=2, padding=1,
                                         generator=generator))
        self.up_convs = nn.ModuleList(convs)

    def forward(self, x):
        x = self.residual_stack(self.in_conv(x))
        for i, conv in enumerate(self.up_convs):
            x = conv(x)
            if i < len(self.up_convs) - 1:
                x = F.relu(x)
        return x


class Quantizer(nn.Module):
    """A 1x1 conv into a VectorQuantizer; ``forward`` returns (quantized,
    loss)."""

    def __init__(self, in_channels: int, n_embeddings: int, embedding_dim: int,
                 use_fused=None, generator=None):
        super().__init__()
        self.conv = Conv2d(in_channels, embedding_dim, 1, generator=generator)
        self.vq = VectorQuantizer(n_embeddings, embedding_dim, use_fused=use_fused,
                                  generator=generator)

    def forward(self, x):
        return self.vq(self.conv(x))
