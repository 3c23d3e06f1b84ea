"""Base classes for generative models (counterpart of
``pytorch_generative_tpu/models/base.py``).

Images are NHWC and ``in_shape`` is ``(h, w, c)``. Randomness is explicit:
samplers take a ``torch.Generator`` or the uniforms themselves, shape
(H*W, N, C), one row per raster position, so a test can feed the port the
same uniforms the JAX package draws.
"""

from __future__ import annotations

import torch
from torch import nn


def _default_sample_fn(u, logits):
    """Bernoulli(sigmoid(logits)) from uniforms: ``u < sigmoid(logits)``, which
    is how ``jax.random.bernoulli`` draws in the JAX package."""
    return (u < torch.sigmoid(logits)).to(logits.dtype)


class GenerativeModel(nn.Module):
    """Base for all generative models: ``forward`` and ``sample``."""

    def __init__(self, in_shape=None, sample_fn=None):
        super().__init__()
        self.in_shape = tuple(in_shape) if in_shape is not None else None
        self.sample_fn = sample_fn or _default_sample_fn

    def sample(self, n_samples=None, conditioned_on=None, *, generator=None,
               uniforms=None):
        raise NotImplementedError


class AutoregressiveModel(GenerativeModel):
    """Base class for autoregressive models: generic raster-scan sampling."""

    def _forward_logits(self, x):
        return self.forward(x)

    @property
    def device(self):
        return next(self.parameters()).device

    def _get_conditioned_on(self, n_samples, conditioned_on):
        if (n_samples is None) == (conditioned_on is None):
            raise ValueError(
                'Must provide one, and only one, of "n_samples" or "conditioned_on"')
        if conditioned_on is None:
            h, w, c = self.in_shape
            conditioned_on = -torch.ones((n_samples, h, w, c), device=self.device)
        return conditioned_on

    def _get_uniforms(self, shape, generator, uniforms):
        """(H*W, N, C) uniforms: the given ones, or drawn from ``generator``."""
        if uniforms is None:
            uniforms = torch.rand(shape, generator=generator)
        if tuple(uniforms.shape) != tuple(shape):
            raise ValueError(f"uniforms must be {tuple(shape)}, got "
                             f"{tuple(uniforms.shape)}")
        return uniforms.to(device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def sample(self, n_samples=None, conditioned_on=None, *, generator=None,
               uniforms=None):
        """Generates samples pixel by pixel in raster order, one full forward
        per pixel. Entries >= 0 of ``conditioned_on`` are kept; entries < 0
        are sampled."""
        canvas = self._get_conditioned_on(n_samples, conditioned_on).clone()
        n, h, w, c = canvas.shape
        uniforms = self._get_uniforms((h * w, n, c), generator, uniforms)
        for i in range(h * w):
            row, col = divmod(i, w)
            logits = self._forward_logits(canvas)[:, row, col, :]
            sampled = self.sample_fn(uniforms[i], logits)
            current = canvas[:, row, col, :]
            canvas[:, row, col, :] = torch.where(current < 0, sampled, current)
        return canvas
