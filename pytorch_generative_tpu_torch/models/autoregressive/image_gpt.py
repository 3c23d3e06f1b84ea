"""(Convolutional) ImageGPT: a decoder-only Transformer over pixels
(counterpart of ``pytorch_generative_tpu/models/autoregressive/image_gpt.py``).

As in the JAX package, the learnable positional embedding is added to the
input image, each TransformerBlock has pre-LN residuals, and the model adds
an extra skip around every block. The transformer middle runs on flat
(N, L, C) sequences.
"""

from __future__ import annotations

import os

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
from pytorch_generative_tpu_torch.ops import ln_cuda, mlp_cuda

# The configuration of the JAX package's ``image_gpt.reproduce()``.
REPRODUCE_CONFIG = dict(
    in_channels=1, out_channels=1, in_size=28, n_transformer_blocks=8,
    n_attention_heads=2, n_embedding_channels=64, in_shape=(28, 28, 1))
# The JAX package's production-scale ImageGPT (``bench.py``'s
# ``_make_imagegpt(0, n_channels=512, n_heads=8)``): C = 512, d_k = 64, so
# every block takes the fused LayerNorm and MLP kernels.
LARGE_CONFIG = dict(REPRODUCE_CONFIG, n_attention_heads=8,
                    n_embedding_channels=512)


def reproduce_loss(x, _, preds):
    """``reproduce()``'s loss, with the Trainer's ``loss_fn(x, y, preds)``
    signature: sigmoid BCE summed per image, batch mean (nats)."""
    n = x.shape[0]
    loss = F.binary_cross_entropy_with_logits(
        preds.reshape(n, -1), x.reshape(n, -1), reduction="none")
    return loss.sum(dim=1).mean()


def _fused_kernels(n_channels: int) -> bool:
    """The JAX package's gate for the fused LayerNorm and MLP kernels, read
    when a block is built: full 128-lane rows (at C = 64, reproduce(), the
    blocks stay unfused), unless ``PGT_FUSED_MLP`` forces it ("1" on, any
    other value off). "1" at a width that the kernels do not take raises a
    ValueError naming it."""
    env = os.environ.get("PGT_FUSED_MLP")
    if env is None:
        return n_channels % 128 == 0
    if env == "1" and (n_channels % 4 or not 0 < n_channels <= ln_cuda.MAX_CHANNELS):
        raise ValueError(
            f"PGT_FUSED_MLP=1 at C = {n_channels}: the fused LayerNorm and MLP kernels take "
            f"a multiple of 4 up to {ln_cuda.MAX_CHANNELS}")
    return env == "1"


class TransformerBlock(nn.Module):
    """An ImageGPT Transformer block (pre-LN attention + 4x GELU MLP).

    With ``use_fused_mlp`` (C % 128 == 0), ``ln1`` takes the LayerNorm
    kernel and ``ln2 -> mlp_conv1 -> GELU -> mlp_conv2 -> + x`` is one
    ``ops/mlp_cuda.ln_mlp_residual`` call on the same parameters.
    """

    def __init__(self, n_channels: int, n_attention_heads: int, generator=None):
        super().__init__()
        self.use_fused_mlp = _fused_kernels(n_channels)
        self.ln1 = ChannelLayerNorm(n_channels, fused=self.use_fused_mlp)
        self.ln2 = ChannelLayerNorm(n_channels)
        self.attn = CausalAttention(
            in_channels=n_channels, n_heads=n_attention_heads,
            embed_channels=n_channels, out_channels=n_channels,
            generator=generator)
        self.mlp_conv1 = Conv2d(n_channels, 4 * n_channels, 1, generator=generator)
        self.mlp_conv2 = Conv2d(4 * n_channels, n_channels, 1, generator=generator)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        if self.use_fused_mlp:
            return mlp_cuda.ln_mlp_residual(
                x, self.ln2.scale, self.ln2.offset, self.mlp_conv1.weight,
                self.mlp_conv1.bias, self.mlp_conv2.weight, self.mlp_conv2.bias,
                self.ln2.eps)
        return x + self.mlp_conv2(F.gelu(self.mlp_conv1(self.ln2(x))))


class ImageGPT(base.AutoregressiveModel):
    """The ImageGPT model (operating on NHWC images, with per-block skips)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 in_size: int = 28, n_transformer_blocks: int = 8,
                 n_attention_heads: int = 4, n_embedding_channels: int = 16,
                 in_shape=None, sample_fn=None, generator=None, device=None):
        """Builds the model and places it on ``device``.

        Args:
            generator: CPU ``torch.Generator`` that drives the weight init, so
                a seed gives the same weights on every device.
            device: Where the model runs; ``None`` means CUDA, and the
                constructor raises if CUDA is not available. Pass ``"cpu"``
                to run on the CPU.
            Others: as in the JAX package's ImageGPT.
        """
        device = base.resolve_device(device)
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
        self.ln = ChannelLayerNorm(n_embedding_channels,
                                   fused=_fused_kernels(n_embedding_channels))
        self.out_conv = Conv2d(n_embedding_channels, out_channels, 1,
                               generator=generator)
        self.to(device)

    def forward(self, x):
        x = self.input_conv(x + self.pos)
        n, h, w, c = x.shape
        x = x.reshape(n, h * w, c)
        for block in self.blocks:
            x = x + block(x)
        return self.out_conv(self.ln(x.reshape(n, h, w, c)))

    def sample(self, n_samples=None, conditioned_on=None, *, generator=None,
               uniforms=None, cache_dtype=torch.float32):
        """KV-cache incremental decoding (``ops/sampling.py``): the
        whole-loop kernel where the JAX package takes it (1 channel, default
        ``sample_fn``, float32 cache, batch tile >= 8), else one step kernel
        per position. ``cache_dtype`` (float32 or bfloat16) is the K/V
        cache's type."""
        from pytorch_generative_tpu_torch.ops.sampling import image_gpt_sample_fast

        return image_gpt_sample_fast(self, n_samples, conditioned_on,
                                     generator=generator, uniforms=uniforms,
                                     cache_dtype=cache_dtype)

    def sample_naive(self, n_samples=None, conditioned_on=None, *,
                     generator=None, uniforms=None):
        """The generic full-forward-per-pixel raster sampler (base class)."""
        return super().sample(n_samples, conditioned_on, generator=generator,
                              uniforms=uniforms)


def reproduce(n_epochs=457, batch_size=64, log_dir="/tmp/run",
              debug_loader=None, device=None):
    """Training script with the reference defaults (the JAX package's
    ``image_gpt.reproduce``): the reproduce() config, Adam at 5e-3 decayed by
    0.999977 per applied step, ``reproduce_loss``, dynamically binarized
    MNIST (or ``debug_loader`` for both train and eval). ``device=None``
    means CUDA. Returns the Trainer."""
    from pytorch_generative_tpu_torch import datasets, optim, trainer

    train_loader, test_loader = debug_loader, debug_loader
    if train_loader is None:
        train_loader, test_loader = datasets.get_mnist_loaders(
            batch_size, dynamically_binarize=True)
    model = ImageGPT(**REPRODUCE_CONFIG,
                     generator=torch.Generator().manual_seed(0), device=device)
    model_trainer = trainer.Trainer(
        model=model, loss_fn=reproduce_loss,
        optimizer=optim.adam_multiplicative(5e-3, 0.999977),
        train_loader=train_loader, eval_loader=test_loader, log_dir=log_dir,
        device=device)
    model_trainer.interleaved_train_and_eval(n_epochs)
    return model_trainer
