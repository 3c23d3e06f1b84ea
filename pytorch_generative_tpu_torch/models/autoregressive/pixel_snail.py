"""PixelSNAIL: masked convolutions and causal attention over all pixels
(counterpart of ``pytorch_generative_tpu/models/autoregressive/pixel_snail.py``).

As in the JAX package: 2x2 convolutions with padding 1, cropped back to the
input size; identity-gated residual blocks; attention over ``concat(2-channel
positional encoding, residual features)`` with the raw image as k/v-only
input and ``mask_center=True``, through the flash kernels at d_k != d_v; a
skip around every block; a head of two 1x1 convolutions with nothing between
them. Attribute names follow the JAX package, so ``convert.from_jax_params``
maps its weights onto this ``state_dict`` unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_generative_tpu_torch.models import base
from pytorch_generative_tpu_torch.models.autoregressive.image_gpt import reproduce_loss
from pytorch_generative_tpu_torch.nn import (
    CausalAttention,
    CausalConv2d,
    Conv2d,
    GatedActivation,
    image_positional_encoding,
)

# The configuration of the JAX package's ``pixel_snail.reproduce()`` (and of
# its ``bench.py`` PixelSNAIL cells).
REPRODUCE_CONFIG = dict(
    in_channels=1, out_channels=1, n_channels=64, n_pixel_snail_blocks=8,
    n_residual_blocks=2, attention_key_channels=4, attention_value_channels=32,
    in_shape=(28, 28, 1))


def _elu_conv_elu(conv, x):
    return F.elu(conv(F.elu(x)))


def _identity(x):
    return x


class ResidualBlock(nn.Module):
    """Residual block of 2x2 convs (pad 1, crop) with an identity-gated
    activation."""

    def __init__(self, n_channels: int, generator=None):
        super().__init__()
        self.input_conv = Conv2d(n_channels, n_channels, 2, padding=1,
                                 generator=generator)
        self.output_conv = Conv2d(n_channels, 2 * n_channels, 2, padding=1,
                                  generator=generator)
        self.activation = GatedActivation(activation_fn=_identity)

    def forward(self, x):
        _, h, w, _ = x.shape
        out = _elu_conv_elu(self.input_conv, x)[:, :h, :w, :]
        out = self.activation(self.output_conv(out)[:, :h, :w, :])
        return x + out


class PixelSNAILBlock(nn.Module):
    """A stack of residual blocks plus one causal attention block."""

    def __init__(self, n_channels: int, input_img_channels: int = 1,
                 n_residual_blocks: int = 2, attention_key_channels: int = 4,
                 attention_value_channels: int = 32, generator=None):
        super().__init__()
        self.residual_blocks = nn.ModuleList(
            ResidualBlock(n_channels, generator=generator)
            for _ in range(n_residual_blocks))
        self.attention = CausalAttention(
            in_channels=n_channels + 2, embed_channels=attention_key_channels,
            out_channels=attention_value_channels, mask_center=True,
            extra_input_channels=input_img_channels, generator=generator)
        self.residual_out = Conv2d(n_channels, n_channels, 1, generator=generator)
        self.attention_out = Conv2d(attention_value_channels, n_channels, 1,
                                    generator=generator)
        self.out = Conv2d(n_channels, n_channels, 1, generator=generator)

    def forward(self, x, input_img):
        res = x
        for block in self.residual_blocks:
            res = block(res)
        pos = image_positional_encoding(input_img.shape, res.device, res.dtype)
        attn = self.attention(torch.cat([pos, res], dim=-1), input_img)
        res = _elu_conv_elu(self.residual_out, res)
        attn = _elu_conv_elu(self.attention_out, attn)
        return _elu_conv_elu(self.out, res + attn)


class PixelSNAIL(base.AutoregressiveModel):
    """The PixelSNAIL model (with per-block output skips)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 n_channels: int = 64, n_pixel_snail_blocks: int = 8,
                 n_residual_blocks: int = 2, attention_key_channels: int = 4,
                 attention_value_channels: int = 32, in_shape=(28, 28, 1),
                 sample_fn=None, generator=None, device=None):
        """Builds the model and places it on ``device``.

        Args:
            generator: CPU ``torch.Generator`` that drives the weight init, so
                a seed gives the same weights on every device.
            device: Where the model runs; ``None`` means CUDA, and the
                constructor raises if CUDA is not available. Pass ``"cpu"``
                to run on the CPU.
            Others: as in the JAX package's PixelSNAIL.
        """
        device = base.resolve_device(device)
        super().__init__(in_shape=in_shape, sample_fn=sample_fn)
        self.input_conv = CausalConv2d(True, in_channels, n_channels, 3,
                                       padding=1, generator=generator)
        self.pixel_snail_blocks = nn.ModuleList(
            PixelSNAILBlock(
                n_channels, input_img_channels=in_channels,
                n_residual_blocks=n_residual_blocks,
                attention_key_channels=attention_key_channels,
                attention_value_channels=attention_value_channels,
                generator=generator)
            for _ in range(n_pixel_snail_blocks))
        self.output_conv1 = Conv2d(n_channels, n_channels // 2, 1,
                                   generator=generator)
        self.output_conv2 = Conv2d(n_channels // 2, out_channels, 1,
                                   generator=generator)
        self.to(device)

    def forward(self, x):
        input_img = x
        x = self.input_conv(x)
        for block in self.pixel_snail_blocks:
            x = x + block(x, input_img)
        return self.output_conv2(self.output_conv1(x))

    def sample(self, n_samples=None, conditioned_on=None, *, generator=None,
               uniforms=None):
        """Incremental decoding (``ops/sampling.py::pixel_snail_sample_route``):
        the whole-loop kernel for a 1-channel model with the default
        ``sample_fn``, the incremental sampler for any other."""
        from pytorch_generative_tpu_torch.ops.sampling import pixel_snail_sample

        return pixel_snail_sample(self, n_samples, conditioned_on,
                                  generator=generator, uniforms=uniforms)

    def sample_naive(self, n_samples=None, conditioned_on=None, *,
                     generator=None, uniforms=None):
        """The generic full-forward-per-pixel raster sampler (base class)."""
        return super().sample(n_samples, conditioned_on, generator=generator,
                              uniforms=uniforms)


def reproduce(n_epochs=457, batch_size=128, log_dir="/tmp/run",
              debug_loader=None, device=None):
    """Training script with the reference defaults (the JAX package's
    ``pixel_snail.reproduce``): the reproduce() config, Adam at 1e-3 decayed
    by 0.999977 per applied step, ``reproduce_loss``, dynamically binarized
    MNIST (or ``debug_loader`` for both train and eval). ``device=None``
    means CUDA. Returns the Trainer."""
    from pytorch_generative_tpu_torch import datasets, optim, trainer

    train_loader, test_loader = debug_loader, debug_loader
    if train_loader is None:
        train_loader, test_loader = datasets.get_mnist_loaders(
            batch_size, dynamically_binarize=True)
    model = PixelSNAIL(**REPRODUCE_CONFIG,
                       generator=torch.Generator().manual_seed(0), device=device)
    model_trainer = trainer.Trainer(
        model=model, loss_fn=reproduce_loss,
        optimizer=optim.adam_multiplicative(1e-3, 0.999977),
        train_loader=train_loader, eval_loader=test_loader, log_dir=log_dir,
        device=device)
    model_trainer.interleaved_train_and_eval(n_epochs)
    return model_trainer
