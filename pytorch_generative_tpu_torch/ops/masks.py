"""Autoregressive masks for convolutions and attention
(counterpart of ``pytorch_generative_tpu/ops/masks.py``)."""

import torch


def causal_conv_mask(kernel_size, mask_center: bool, dtype=torch.float32):
    """Raster-scan causal mask for a conv kernel, shape (1, 1, kh, kw) (OIHW).

    Rows above the center are kept; on the center row, columns strictly left
    of center are kept, plus the center itself when ``mask_center=False``
    (type-B). The same per-tap pattern as the JAX (kh, kw, 1, 1) HWIO mask.
    """
    kh, kw = kernel_size
    mask = torch.zeros((kh, kw), dtype=dtype)
    mask[: kh // 2, :] = 1.0
    mask[kh // 2, : kw // 2 + int(not mask_center)] = 1.0
    return mask.reshape(1, 1, kh, kw)


def causal_attention_mask(size: int, mask_center: bool, device=None):
    """Lower-triangular bool mask of shape (size, size).

    ``mask_center=True`` excludes the diagonal, so row 0 is fully masked.
    """
    offset = -1 if mask_center else 0
    return torch.ones((size, size), dtype=torch.bool, device=device).tril(offset)
