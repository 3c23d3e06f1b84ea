"""Weight bridge from the JAX package's module pytrees to this port.

The JAX side flattens a model with ``jax.tree_util.tree_flatten_with_path``
and names each leaf with ``jax.tree_util.keystr`` (``.blocks[0].attn.q_proj.
weight``); this module turns those leaves into the port's ``state_dict``
without importing JAX.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _key(path: str) -> str:
    """``.blocks[0].ln1.scale`` -> ``blocks.0.ln1.scale``."""
    return re.sub(r"\[(\d+)\]", r".\1", path).lstrip(".")


def _value(name: str, arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, dtype=np.float32)  # a writable copy
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight", "mask") and arr.ndim == 4:
        if leaf == "weight" and arr.shape[:2] == (1, 1):
            arr = arr[0, 0]                      # 1x1 conv: (in, out)
        else:
            arr = arr.transpose(3, 2, 0, 1)      # HWIO -> OIHW
    return torch.from_numpy(np.ascontiguousarray(arr))


def from_jax_params(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from ``{keystr(path): leaf}`` of a JAX model."""
    out = {}
    for path, arr in flat.items():
        name = _key(path)
        out[name] = _value(name, arr)
    return out
