"""Dense masked attention (counterpart of
``pytorch_generative_tpu/ops/attention.py``).

This is the semantics the flash kernel (``attention_cuda.py``) is held to:
with ``mask_center=True`` the first position attends to nothing and its
output is exactly 0; the softmax scale is 1/sqrt(d_k).
"""

import torch

from pytorch_generative_tpu_torch.ops.masks import causal_attention_mask


def causal_attention_with_lse(q, k, v, mask_center: bool = False):
    """Masked attention over (N, heads, L, d) tensors.

    Returns (out (N, heads, L, d_v), lse (N, heads, L)), lse being the
    natural-log logsumexp of each row's scaled scores, -inf on fully-masked
    rows, whose output is exactly 0.
    """
    seq_len = q.shape[-2]
    scale = 1.0 / (k.shape[-1] ** 0.5)
    mask = causal_attention_mask(seq_len, mask_center, device=q.device)
    logits = torch.einsum("nhqd,nhkd->nhqk", q, k) * scale
    logits = logits.masked_fill(~mask, float("-inf"))
    maxval = logits.amax(dim=-1, keepdim=True)
    maxval = torch.where(torch.isfinite(maxval), maxval, torch.zeros_like(maxval))
    unnorm = torch.where(mask, torch.exp(logits - maxval), torch.zeros_like(logits))
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / torch.where(denom == 0.0, torch.ones_like(denom), denom)
    lse = torch.where(denom == 0.0, torch.full_like(denom, float("-inf")),
                      maxval + torch.log(denom))
    return torch.einsum("nhqk,nhkd->nhqd", probs, v), lse[..., 0]


def causal_attention(q, k, v, mask_center: bool = False):
    """Masked multihead attention over (N, heads, L, d); returns (N, heads, L, d_v)."""
    return causal_attention_with_lse(q, k, v, mask_center)[0]
