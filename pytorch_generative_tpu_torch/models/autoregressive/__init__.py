"""Autoregressive models."""

from pytorch_generative_tpu_torch.models.autoregressive import image_gpt  # noqa: F401
