"""Metrics logging: JSONL always, TensorBoard when it imports (counterpart
of ``pytorch_generative_tpu/utils/metrics.py``, same records and files).

Scalar tags ``metrics/<key>`` (train/eval sub-tags), ``metrics/lr``,
``speed/*``; sample grids saved as ``<tag>_<step>.npy``; ``purge_step``
drops the records a restore made stale.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _tensorboard_writer(log_dir, purge_step):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:  # tensorboard is optional
        return None
    return SummaryWriter(log_dir, max_queue=100, purge_step=purge_step)


class MetricsWriter:
    """Writes scalars/images to metrics.jsonl and (optionally) TensorBoard."""

    def __init__(self, log_dir: str, purge_step: int | None = None,
                 use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        if purge_step is not None and os.path.exists(self._jsonl_path):
            self._purge(purge_step)
        self._jsonl = open(self._jsonl_path, "a")
        self._tb = (_tensorboard_writer(log_dir, purge_step)
                    if use_tensorboard else None)

    def _purge(self, purge_step: int):
        """Drops JSONL records with step >= purge_step (stale after a restore)."""
        with open(self._jsonl_path) as f:
            lines = f.readlines()
        kept = []
        for line in lines:
            try:
                if json.loads(line).get("step", 0) < purge_step:
                    kept.append(line)
            except json.JSONDecodeError:
                continue
        with open(self._jsonl_path, "w") as f:
            f.writelines(kept)

    def add_scalar(self, tag: str, value, step: int):
        record = {"tag": tag, "value": float(value), "step": int(step)}
        self._jsonl.write(json.dumps(record) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_scalars(self, tag: str, values: dict, step: int):
        record = {"tag": tag, "step": int(step)}
        record.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(tag, {k: float(v) for k, v in values.items()}, step)

    def add_images(self, tag: str, images, step: int):
        """Logs an NHWC batch of images; always saves it as ``.npy`` too."""
        images = np.asarray(images)
        if self._tb is not None:
            self._tb.add_images(tag, images, step, dataformats="NHWC")
        path = os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}.npy")
        np.save(path, images)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
