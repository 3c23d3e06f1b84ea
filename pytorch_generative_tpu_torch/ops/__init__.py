"""Functional ops: masks, initializers, attention math, kernel wrappers and
samplers.

Plain PyTorch functions define semantics; ``attention_cuda``, ``ln_cuda``,
``mlp_cuda``, ``decode_cuda``, ``snail_decode_cuda`` and ``vq_cuda`` wrap
the hand-written Hopper kernels in ``csrc/`` and hold each kernel's plain
version beside it. Importing a wrapper builds nothing: a kernel is compiled
at its first launch.
"""

from pytorch_generative_tpu_torch.ops import (  # noqa: F401
    attention,
    attention_cuda,
    init,
    ln_cuda,
    masks,
    mlp_cuda,
    snail_decode_cuda,
    vq,
    vq_cuda,
)
