"""Vector-quantization math (counterpart of
``pytorch_generative_tpu/ops/vq.py``): the nearest-codebook search as one
matrix product and an argmax."""

import torch


def nearest_codebook(flat_x, codebook):
    """The index of the closest codebook row for each input row: (M,) int64
    for (M, D) ``flat_x`` and a (K, D) ``codebook``.

    argmin |x - e|^2 == argmax (2 x.e - |e|^2), |x|^2 being constant per
    row; ``torch.argmax`` returns the first index on ties, as ``jnp.argmax``.
    Rows and codebook of two types meet in the wider one, as JAX promotes
    bf16 rows against an f32 codebook to an f32 product.
    """
    dtype = torch.promote_types(flat_x.dtype, codebook.dtype)
    flat_x, codebook = flat_x.to(dtype), codebook.to(dtype)
    scores = 2.0 * (flat_x @ codebook.T) - (codebook * codebook).sum(dim=1)
    return torch.argmax(scores, dim=1)
