"""Trainer checkpoints (counterpart of the unsharded half of
``pytorch_generative_tpu/utils/checkpoint.py``).

One file per saved epoch, ``trainer_state_{epoch}.ckpt``: a ``torch.save``
of a dict of state dicts and plain values (the model's and the optimizer's
``state_dict``, the sampling generator's state, the Trainer's counters as
metadata). It is loaded with ``weights_only=True``, so loading runs no
pickled code. Sharded (FSDP) checkpoints wait for the port's FSDP.
"""

from __future__ import annotations

import glob
import os
import re

import torch

CHECKPOINT_PATTERN = "trainer_state_[0-9]*.ckpt"


def checkpoint_path(log_dir: str, epoch: int) -> str:
    return os.path.join(log_dir, f"trainer_state_{epoch}.ckpt")


def save_checkpoint(path: str, state: dict, metadata: dict | None = None):
    """Writes ``state`` and ``metadata`` to ``path`` (tmp file + rename)."""
    tmp = path + ".tmp"
    torch.save({"state": state, "metadata": dict(metadata or {})}, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, map_location=None):
    """Reads a checkpoint written by :func:`save_checkpoint`; returns
    ``(state, metadata)`` with tensors on ``map_location``."""
    saved = torch.load(path, map_location=map_location, weights_only=True)
    return saved["state"], saved["metadata"]


def _epochs(log_dir: str):
    files = glob.glob(os.path.join(log_dir, CHECKPOINT_PATTERN))
    return sorted(int(re.findall(r"\d+", os.path.basename(f))[0]) for f in files)


def find_latest_epoch(log_dir: str) -> int:
    """Latest checkpoint epoch in log_dir, or raises FileNotFoundError."""
    epochs = _epochs(log_dir)
    if not epochs:
        raise FileNotFoundError(f"No checkpoints found in {log_dir}.")
    print(f"Found {len(epochs)} saved checkpoints.")
    return epochs[-1]


def prune_checkpoints(log_dir: str, keep: int):
    """Deletes all but the newest ``keep`` checkpoint files."""
    epochs = _epochs(log_dir)
    for epoch in epochs[: max(0, len(epochs) - keep)]:
        os.remove(checkpoint_path(log_dir, epoch))
