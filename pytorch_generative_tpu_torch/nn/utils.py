"""Vector quantization (counterpart of the ``VectorQuantizer`` of
``pytorch_generative_tpu/nn/utils.py``).

The JAX module returns an updated copy of itself that carries the new EMA
codebook; here the EMA statistics are float32 buffers that the forward
updates in place, once per call in training mode. The port keeps no
zero-size ``embedding`` in EMA mode (the JAX module keeps one only for a
uniform pytree); ``convert.from_jax_params`` drops that leaf.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from pytorch_generative_tpu_torch.ops import init as init_ops
from pytorch_generative_tpu_torch.ops import vq_cuda
from pytorch_generative_tpu_torch.ops.vq import nearest_codebook


class VectorQuantizer(nn.Module):
    """Quantizes NHWC inputs (C == embedding_dim) to the nearest codebook
    row (Euclidean).

    ``forward(x)`` returns ``(quantized, loss)``: the straight-through output
    ``x + (q - x).detach()`` and the commitment loss ``mse(x, q.detach())``
    (weight 1), plus the embedding loss ``mse(q, x.detach())`` without EMA.
    With ``use_ema`` the codebook is the buffer ``ema_embedding``, and a
    forward in training mode updates ``ema_cluster_size``,
    ``ema_embedding_avg`` and then ``ema_embedding = avg / (size + 1e-5)``
    from the batch's counts and sums, after computing the loss from the old
    codebook. Without EMA the codebook is the parameter ``embedding``.

    Under a bf16 compute dtype the rows are bf16 beside the f32 EMA
    codebook (or the bf16 copy of ``embedding``), as in the JAX module: the
    search and the quantized rows in the promoted type, the quantized rows
    then cast to the input's type, and the batch counts and sums in f32
    from an f32 one-hot and the rows widened to f32 (a bf16 one-hot would
    round any count above 256).

    ``use_fused`` picks the fused kernel (``ops/vq_cuda.py``, EMA mode only):
    ``None`` takes it for CUDA inputs when ``PGT_FUSED_VQ=1`` was set at
    construction, the JAX package's opt-in rule with "on the accelerator"
    read as "the input is on the card"; ``True`` always takes it (its plain
    version for CPU inputs); ``use_ema=False`` never does.
    """

    # The EMA statistics accumulate over the whole run: the Trainer's
    # compute_dtype cast leaves them float32 (core.cast_floating), as the
    # JAX module's state_field declaration does.
    state_buffers = ("ema_embedding", "ema_cluster_size", "ema_embedding_avg")

    def __init__(self, n_embeddings: int, embedding_dim: int, use_ema: bool = True,
                 ema_decay: float = 0.99, axis_name=None, use_fused=None,
                 generator=None):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                "VectorQuantizer(axis_name=...): the all-reduce of the EMA "
                "statistics is not ported yet: ROADMAP.md A.11")
        self.n_embeddings = n_embeddings
        self.embedding_dim = embedding_dim
        self.use_ema = use_ema
        self.decay = ema_decay
        self.use_fused = use_fused
        self._fused_env = os.environ.get("PGT_FUSED_VQ") == "1"
        embedding = init_ops.kaiming_uniform(
            generator, (n_embeddings, embedding_dim), fan_in=embedding_dim)
        if use_ema:
            self.embedding = None
            self.register_buffer("ema_embedding", embedding)
            self.register_buffer("ema_cluster_size", torch.zeros(n_embeddings))
            self.register_buffer("ema_embedding_avg", embedding.clone())
        else:
            self.embedding = nn.Parameter(embedding)
            for name in ("ema_embedding", "ema_cluster_size", "ema_embedding_avg"):
                self.register_buffer(name, None)

    @property
    def codebook(self):
        return self.ema_embedding if self.use_ema else self.embedding

    def fused(self, x) -> bool:
        """Whether a call on ``x`` takes the fused kernel's route."""
        if not self.use_ema:
            return False
        if self.use_fused is None:
            return self._fused_env and x.is_cuda
        return bool(self.use_fused)

    def forward(self, x):
        n, h, w, c = x.shape
        if c != self.embedding_dim:
            raise ValueError(f"input channels {c} != embedding_dim {self.embedding_dim}")
        flat_x = x.reshape(-1, c)
        codebook = self.codebook
        update = self.use_ema and self.training
        if self.fused(x):
            quantized, counts, sums = vq_cuda.vq_quantize_fused(
                flat_x.detach().contiguous(), codebook.detach())
        else:
            dtype = torch.promote_types(flat_x.dtype, codebook.dtype)
            one_hot = F.one_hot(nearest_codebook(flat_x, codebook),
                                self.n_embeddings).to(dtype)
            quantized = one_hot @ codebook.to(dtype)
            if update:
                with torch.no_grad():  # in the statistics' own type (float32)
                    stat = self.ema_cluster_size.dtype
                    one_hot = one_hot.to(stat)
                    counts, sums = one_hot.sum(dim=0), one_hot.T @ flat_x.to(stat)
        quantized = quantized.to(x.dtype).reshape(n, h, w, c)

        loss = torch.mean((x - quantized.detach()) ** 2)
        if update:
            with torch.no_grad():
                d = self.decay
                self.ema_cluster_size.copy_(d * self.ema_cluster_size + (1 - d) * counts)
                self.ema_embedding_avg.copy_(d * self.ema_embedding_avg + (1 - d) * sums)
                self.ema_embedding.copy_(
                    self.ema_embedding_avg / (self.ema_cluster_size + 1e-5)[:, None])
        elif not self.use_ema:
            loss = loss + torch.mean((quantized - x.detach()) ** 2)

        # Straight-through estimator.
        return x + (quantized - x).detach(), loss
