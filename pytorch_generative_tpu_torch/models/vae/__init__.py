"""Variational autoencoders (VQ-VAE so far)."""

from pytorch_generative_tpu_torch.models.vae import vaes, vq_vae  # noqa: F401
from pytorch_generative_tpu_torch.models.vae.vq_vae import (  # noqa: F401
    VectorQuantizedVAE,
)
