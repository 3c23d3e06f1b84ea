"""Mixed-precision compute (counterpart of ``cast_floating`` in
``pytorch_generative_tpu/core.py``).

The Trainer's ``compute_dtype`` keeps float32 master weights and runs each
step on copies cast to the compute type, as the JAX package does: every
floating parameter and constant buffer (masks, positional tables) is cast,
while state buffers, which accumulate over a whole run (the VQ-EMA
statistics), stay float32. A module declares its state buffers by name in a
class attribute ``state_buffers``, the counterpart of the JAX package's
``core.state_field``.
"""

from __future__ import annotations

import torch


def state_buffer_names(model: torch.nn.Module) -> set[str]:
    """The full names of the state buffers of ``model`` and its children."""
    return {f"{prefix}.{name}" if prefix else name
            for prefix, module in model.named_modules()
            for name in getattr(type(module), "state_buffers", ())
            if module._buffers.get(name) is not None}


def cast_floating(model: torch.nn.Module, dtype) -> dict[str, torch.Tensor]:
    """name -> tensor for ``torch.func.functional_call(model, ...)``: every
    floating parameter and buffer of ``model`` cast to ``dtype`` (a
    differentiable copy, so that gradients reach the float32 parameter
    through it), every other tensor and the state buffers as they are (the
    module's own tensors, so that in-place updates of a state buffer land
    on it)."""
    state = state_buffer_names(model)
    tensors = {}
    for name, t in [*model.named_parameters(), *model.named_buffers()]:
        cast = t.is_floating_point() and name not in state
        tensors[name] = t.to(dtype) if cast else t
    return tensors
