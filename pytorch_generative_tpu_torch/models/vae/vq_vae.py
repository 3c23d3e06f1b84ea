"""VQ-VAE: a VAE with a discrete, vector-quantized latent space (counterpart
of ``pytorch_generative_tpu/models/vae/vq_vae.py``).

The encoder downsamples 4x with strided convolutions, a 1x1 conv and a
``VectorQuantizer`` (EMA codebook) quantize the latents, and the decoder
upsamples with transposed convolutions. ``forward(x)`` returns
``(reconstruction, vq_loss)``; in training mode it also updates the
quantizer's EMA buffers in place.
"""

from __future__ import annotations

import torch

from pytorch_generative_tpu_torch.models import base
from pytorch_generative_tpu_torch.models.vae import vaes

# The configuration of the JAX package's ``vq_vae.reproduce()`` (and of its
# ``bench.py`` ``vq_vae_train_throughput`` cell): CIFAR10, a 512 x 64
# codebook.
REPRODUCE_CONFIG = dict(
    in_channels=3, out_channels=3, hidden_channels=128, residual_channels=32,
    n_residual_blocks=2, n_embeddings=512, embedding_dim=64, in_shape=(32, 32, 3))


class VectorQuantizedVAE(base.VariationalAutoEncoder):
    """The Vector Quantized Variational Autoencoder (VQ-VAE) model."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 hidden_channels: int = 128, n_residual_blocks: int = 2,
                 residual_channels: int = 32, n_embeddings: int = 128,
                 embedding_dim: int = 16, in_shape=(32, 32, 3), sample_fn=None,
                 use_fused=None, generator=None, device=None):
        """Builds the model and places it on ``device``.

        Args:
            use_fused: The quantizer's route (``nn.VectorQuantizer``): None
                takes the fused kernel for CUDA inputs when PGT_FUSED_VQ=1.
            generator: CPU ``torch.Generator`` that drives the weight init, so
                a seed gives the same weights on every device.
            device: Where the model runs; ``None`` means CUDA, and the
                constructor raises if CUDA is not available. Pass ``"cpu"``
                to run on the CPU.
            Others: as in the JAX package's VectorQuantizedVAE.
        """
        device = base.resolve_device(device)
        super().__init__(in_shape=in_shape, sample_fn=sample_fn)
        self.encoder = vaes.Encoder(
            in_channels, hidden_channels, hidden_channels, n_residual_blocks,
            residual_channels, stride=4, generator=generator)
        self.quantizer = vaes.Quantizer(
            hidden_channels, n_embeddings, embedding_dim, use_fused=use_fused,
            generator=generator)
        self.decoder = vaes.Decoder(
            embedding_dim, out_channels, hidden_channels, n_residual_blocks,
            residual_channels, stride=4, generator=generator)
        self.to(device)

    def forward(self, x):
        """Returns (reconstruction, quantization loss)."""
        quantized, vq_loss = self.quantizer(self.encoder(x))
        return self.decoder(quantized), vq_loss

    def _sample(self, n_samples, generator):
        raise NotImplementedError("VQ-VAE does not support sampling.")


def reproduce_loss(x, _, preds):
    """``reproduce()``'s loss with the Trainer's ``loss_fn(x, y, preds)``
    signature: the metrics dict of mean squared reconstruction error plus
    the quantizer's loss."""
    preds, vq_loss = preds
    recon_loss = torch.mean((preds - x) ** 2)
    return {"vq_loss": vq_loss, "reconstruction_loss": recon_loss,
            "loss": recon_loss + vq_loss}


def reproduce(n_epochs=457, batch_size=128, log_dir="/tmp/run", debug_loader=None,
              device=None):
    """Training script with the reference defaults (the JAX package's
    ``vq_vae.reproduce``): the reproduce() config on normalized CIFAR10 (or
    ``debug_loader`` for both train and eval), Adam at 2e-4 decayed by
    0.999977 per applied step, ``reproduce_loss``. ``device=None`` means
    CUDA. Returns the Trainer."""
    from pytorch_generative_tpu_torch import datasets, optim, trainer

    train_loader, test_loader = debug_loader, debug_loader
    if train_loader is None:
        train_loader, test_loader = datasets.get_cifar10_loaders(
            batch_size, normalize=True)
    model = VectorQuantizedVAE(**REPRODUCE_CONFIG,
                               generator=torch.Generator().manual_seed(0), device=device)
    model_trainer = trainer.Trainer(
        model=model, loss_fn=reproduce_loss,
        optimizer=optim.adam_multiplicative(2e-4, 0.999977),
        train_loader=train_loader, eval_loader=test_loader, log_dir=log_dir,
        device=device)
    model_trainer.interleaved_train_and_eval(n_epochs)
    return model_trainer
