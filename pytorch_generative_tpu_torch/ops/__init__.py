"""Functional ops: masks, initializers, attention math, kernel wrappers and
samplers.

Plain PyTorch functions define semantics; ``attention_cuda`` and
``decode_cuda`` wrap the hand-written Hopper kernels in ``csrc/`` and hold
each kernel's plain version beside it. Like the JAX package's ``ops``, only
the plain modules are imported here.
"""

from pytorch_generative_tpu_torch.ops import attention, init, masks  # noqa: F401
