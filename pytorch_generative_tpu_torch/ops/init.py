"""PyTorch-default parameter initializers driven by an explicit
``torch.Generator`` (counterpart of ``pytorch_generative_tpu/ops/init.py``).

The distributions match the JAX package's; the numbers do not, since a
``torch.Generator`` and a ``jax.random`` key give different streams. Tests
that compare the two packages copy the JAX weights with ``convert``.
"""

import math

import torch


def _uniform(generator, shape, bound, dtype):
    u = torch.rand(shape, generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * bound


def torch_default_weight(generator, shape, fan_in, dtype=torch.float32):
    """The torch.nn.Linear/Conv2d default, kaiming_uniform with a=sqrt(5):
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return _uniform(generator, shape, 1.0 / math.sqrt(fan_in), dtype)


def torch_default_bias(generator, shape, fan_in, dtype=torch.float32):
    """The torch.nn.Linear/Conv2d default bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(generator, shape, bound, dtype)
