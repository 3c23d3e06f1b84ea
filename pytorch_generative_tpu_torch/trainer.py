"""Training and evaluation loop with the JAX package's Trainer contract
(counterpart of ``pytorch_generative_tpu/trainer.py``, one device).

  * ``loss_fn(inputs, targets, predictions)`` returns a scalar loss or a
    metrics dict that contains "loss"; every metric is logged per step,
    train and eval separately.
  * The global L2 grad norm is always logged as ``grad_norm``.
    ``clip_grad_norm`` scales the gradients by ``min(1, clip / (norm +
    1e-6))``; ``skip_grad_norm`` drops the step when the norm exceeds it and
    ``skip_nonfinite`` when the loss or the norm is not finite (counted by
    the ``nonfinite_steps`` metric). A dropped step moves neither the
    parameters, the optimizer's moments nor its learning rate.
  * ``grad_accumulation`` splits a batch into equal chunks and steps once on
    the mean of their gradients; a batch it does not divide is computed
    whole, with one warning.
  * The LR is logged per batch, indexed by applied steps.
  * Model state that is not a parameter (buffers, such as the VQ-VAE's EMA
    codebook) changes in place during each training forward, once per
    chunk. A step that ``skip_nonfinite`` drops also restores the buffers
    to what they were before it; ``skip_grad_norm`` alone keeps their
    update, as in the JAX package.
  * Eval metrics are example-weighted means over the eval set.
  * Checkpoints ``trainer_state_{epoch}.ckpt`` every
    ``save_checkpoint_epochs``, with auto-resume from the latest one and a
    purge of the metrics logged after it.
  * Every ``sample_epochs`` epochs, 16 samples are logged as an image grid;
    a sampling failure is printed, not raised.
  * Cumulative ``speed/examples_per_sec`` and ``speed/millis_per_example``.
  * ``compute_dtype=torch.bfloat16`` (or ``"bfloat16"``) trains in mixed
    precision by the JAX package's recipe, not ``torch.autocast``: the
    optimizer keeps the float32 parameters, each step runs the model
    through ``torch.func.functional_call`` on bf16 copies of its
    parameters and constant buffers (``core.cast_floating``; state buffers
    such as the VQ-EMA statistics stay float32) with a bf16 input, the
    predictions and the input go back to float32 before the loss, and the
    backward leaves float32 gradients on the parameters. Eval runs the same
    cast; checkpoints hold the float32 parameters.

The model runs on ``device``: ``None`` means CUDA, and the constructor
raises if CUDA is not available. Each batch is moved there; the host waits
for the device once per epoch, when it fetches the epoch's metrics, not at
every step.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

from pytorch_generative_tpu_torch import core
from pytorch_generative_tpu_torch.models.base import resolve_device
from pytorch_generative_tpu_torch.utils import checkpoint as ckpt_utils
from pytorch_generative_tpu_torch.utils.metrics import MetricsWriter


def _get_metrics_dict(loss_or_metrics):
    metrics = loss_or_metrics
    if not isinstance(metrics, dict):
        metrics = {"loss": metrics}
    if "loss" not in metrics:
        raise ValueError('Metrics dictionary does not contain "loss" key.')
    return metrics


# Trainer arguments a CLI can default-override: the signature declares them
# as the _UNSET sentinel, so an explicit argument at any call site wins over
# the override, even when it equals the documented default.
_UNSET = object()
_DEFAULT_OVERRIDES = {}
_OVERRIDABLE_DEFAULTS = {
    "fsdp": False,
    "grad_accumulation": 1,
    "compute_dtype": None,
    "async_checkpoint": False,
    "skip_nonfinite": False,
    "keep_checkpoints": None,
}


def set_default_overrides(**kwargs):
    """Sets Trainer-argument defaults for this process. Only arguments in
    ``_OVERRIDABLE_DEFAULTS`` are accepted; ``None`` values are ignored. An
    explicit argument at a Trainer call site always wins."""
    for k in kwargs:
        if k not in _OVERRIDABLE_DEFAULTS:
            raise ValueError(f"{k} is not an overridable Trainer default")
    _DEFAULT_OVERRIDES.clear()
    _DEFAULT_OVERRIDES.update(
        {k: v for k, v in kwargs.items() if v is not None})


def _not_ported(what, item):
    raise NotImplementedError(
        f"Trainer({what}) is not ported to PyTorch yet: ROADMAP.md {item}")


def _compute_dtype(value):
    """None or torch.bfloat16 for ``compute_dtype`` None, torch.bfloat16 or
    "bfloat16"; any other type raises."""
    if value is None:
        return None
    if value in (torch.bfloat16, "bfloat16"):
        return torch.bfloat16
    _not_ported(f"compute_dtype={value!r}", "A.5 (bf16 is the ported compute dtype)")


def _to_f32(tree):
    """Floating tensors of a prediction (a tensor, or a tuple, list or dict
    of them) as float32."""
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.is_floating_point() else tree
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_f32(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree


class Trainer:
    """Encapsulates the train/eval loop. Stateful: calling
    ``interleaved_train_and_eval`` twice resumes where it left off."""

    def __init__(
        self,
        model,
        loss_fn,
        optimizer,
        train_loader,
        eval_loader,
        lr_schedule=None,
        clip_grad_norm=None,
        skip_grad_norm=None,
        skip_nonfinite=_UNSET,
        grad_accumulation=_UNSET,
        log_dir=None,
        sample_epochs=3,
        save_checkpoint_epochs=1,
        keep_checkpoints=_UNSET,
        async_checkpoint=_UNSET,
        n_devices=1,
        mesh_shape=None,
        tp_rules=None,
        fsdp=_UNSET,
        fsdp_min_size=None,
        seed=0,
        use_tensorboard=True,
        profile_steps=None,
        compute_dtype=_UNSET,
        device=None,
    ):
        """Initializes a new Trainer.

        Args:
            model: A GenerativeModel (``nn.Module``) to train; it is moved to
                ``device`` and trained in place.
            loss_fn: fn(inputs, targets, predictions) -> loss or metrics dict
                containing a "loss" key.
            optimizer: A ``torch.optim.Optimizer`` over the model's
                parameters, a ``make_optimizer(params)`` callable, or the
                ``(make_optimizer, lr_schedule)`` tuple that the helpers of
                ``pytorch_generative_tpu_torch.optim`` return.
                ``skip_grad_norm`` and ``skip_nonfinite`` need the port's
                optimizers (their ``step(keep=...)``).
            train_loader / eval_loader: Iterables of (x, y) NumPy batches.
            lr_schedule: Optional fn(applied_steps) -> lr, for logging
                (filled in when ``optimizer`` is a tuple).
            clip_grad_norm: L2 norm to scale gradients to if exceeded.
            skip_grad_norm: Max L2 norm above which the whole step is skipped.
            skip_nonfinite: Skip any step whose loss or gradient norm is
                NaN/inf (a ``nonfinite_steps`` metric counts them).
            grad_accumulation: Chunks per batch, their gradients averaged
                before the one optimizer step.
            log_dir: Checkpoints + metrics directory (temp dir if None).
            sample_epochs: Epochs between 16-image sample grids (None
                disables sampling).
            save_checkpoint_epochs: Epochs between checkpoints.
            keep_checkpoints: If set, only the newest n checkpoint files are
                kept on disk.
            seed: Seed of the ``torch.Generator`` that draws the samples.
            use_tensorboard: Also log to TensorBoard when it imports.
            device: Where the model trains; ``None`` means CUDA.
            compute_dtype: None (float32), or torch.bfloat16 / "bfloat16"
                for mixed precision (module docstring); any other type
                raises NotImplementedError.
            n_devices, mesh_shape, tp_rules, fsdp, fsdp_min_size,
            async_checkpoint, profile_steps: the JAX package's options
                whose paths are not ported; anything but their defaults
                raises NotImplementedError.
        """
        def _resolve(name, value):
            if value is not _UNSET:
                return value
            return _DEFAULT_OVERRIDES.get(name, _OVERRIDABLE_DEFAULTS[name])

        if int(n_devices or 1) > 1 or mesh_shape is not None or tp_rules:
            _not_ported("n_devices > 1, mesh_shape, tp_rules",
                        "A.11 (parallelism on torch.distributed)")
        if _resolve("fsdp", fsdp) or fsdp_min_size is not None:
            _not_ported("fsdp", "A.11 (parallelism on torch.distributed)")
        self.compute_dtype = _compute_dtype(_resolve("compute_dtype", compute_dtype))
        if _resolve("async_checkpoint", async_checkpoint):
            _not_ported("async_checkpoint", "A.5")
        if profile_steps is not None:
            _not_ported("profile_steps", "A.5")

        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if isinstance(optimizer, tuple):
            optimizer, lr_schedule = optimizer
        if not isinstance(optimizer, torch.optim.Optimizer):
            optimizer = optimizer(self.model.parameters())
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.lr_schedule = lr_schedule
        self.clip_grad_norm = clip_grad_norm
        self.skip_grad_norm = skip_grad_norm
        self.skip_nonfinite = bool(_resolve("skip_nonfinite", skip_nonfinite))
        self.grad_accumulation = max(
            int(_resolve("grad_accumulation", grad_accumulation) or 1), 1)
        self.log_dir = log_dir or tempfile.mkdtemp()
        self.sample_epochs = sample_epochs
        self.save_checkpoint_epochs = save_checkpoint_epochs
        self.keep_checkpoints = _resolve("keep_checkpoints", keep_checkpoints)
        self._warned_ragged_accum = False

        self._generator = torch.Generator().manual_seed(seed)
        self._step = 0
        self._applied_steps = 0  # optimizer steps actually taken (not skipped)
        self._epoch = 0
        self._examples_processed = 0
        self._time_taken = 0.0

        os.makedirs(self.log_dir, exist_ok=True)
        self._use_tensorboard = use_tensorboard
        self._writer = MetricsWriter(self.log_dir, use_tensorboard=use_tensorboard)

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------
    def compute_metrics(self, x, y, training):
        """One batch's metrics dict; the overridable seam, as in the JAX
        package (``training`` says which loop calls it). Under a compute
        dtype the model runs on cast copies of its tensors and a cast input;
        the loss sees float32 predictions and input."""
        del training
        if self.compute_dtype is None:
            return dict(_get_metrics_dict(self.loss_fn(x, y, self.model(x))))
        tensors = core.cast_floating(self.model, self.compute_dtype)
        x = x.to(self.compute_dtype)
        preds = torch.func.functional_call(self.model, tensors, (x,))
        return dict(_get_metrics_dict(self.loss_fn(x.float(), y, _to_f32(preds))))

    def _to_device(self, x, y):
        x = torch.from_numpy(np.asarray(x, np.float32))
        y = None if y is None else torch.as_tensor(np.asarray(y))
        if self.device.type != "cuda":
            return x, y
        # Pinned memory lets the copy run without waiting for the device.
        move = lambda t: t.pin_memory().to(self.device, non_blocking=True)
        return move(x), None if y is None else move(y)

    def _microbatches(self, x, y):
        accum = self.grad_accumulation
        n = x.shape[0]
        if accum <= 1:
            return [(x, y)]
        if n < accum or n % accum:
            if not self._warned_ragged_accum:
                self._warned_ragged_accum = True
                warnings.warn(
                    f"grad_accumulation={accum}: batch of {n} is not divisible "
                    "by it; computing this batch in ONE backward (all "
                    "activations live).", stacklevel=3)
            return [(x, y)]
        ys = [None] * accum if y is None else y.chunk(accum)
        return list(zip(x.chunk(accum), ys))

    def train_one_step(self, x, y):
        """Runs one optimizer step; returns (on-device metrics, batch size)."""
        x, y = self._to_device(x, y)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        buffers = list(self.model.buffers()) if self.skip_nonfinite else []
        saved = [b.clone() for b in buffers]
        chunks = self._microbatches(x, y)
        metrics = {}
        for xb, yb in chunks:
            chunk_metrics = self.compute_metrics(xb, yb, training=True)
            (chunk_metrics["loss"] / len(chunks)).backward()
            for k, v in chunk_metrics.items():
                v = torch.as_tensor(v).detach() / len(chunks)
                metrics[k] = metrics[k] + v if k in metrics else v

        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        metrics["grad_norm"] = norm
        if self.clip_grad_norm is not None:
            torch._foreach_mul_(grads, torch.clamp(
                self.clip_grad_norm / (norm + 1e-6), max=1.0))
        keep = None
        if self.skip_grad_norm is not None:
            keep = norm <= self.skip_grad_norm
        if self.skip_nonfinite:
            finite = torch.isfinite(norm) & torch.isfinite(metrics["loss"])
            metrics["nonfinite_steps"] = (~finite).float()
            keep = finite if keep is None else keep & finite
            with torch.no_grad():
                for b, old in zip(buffers, saved):
                    b.copy_(torch.where(finite, b, old))
        if keep is None:
            self.optimizer.step()
        else:
            self.optimizer.step(keep=keep)
        return metrics, x.shape[0]

    @torch.no_grad()
    def sample_one_batch(self):
        """Generates 16 samples and logs them; a failure is printed with its
        traceback, not raised, so that training goes on."""
        try:
            self.model.eval()
            samples = self.model.sample(n_samples=16, generator=self._generator)
            self._writer.add_images("sample", np.clip(samples.cpu().numpy(), 0, 1),
                                    self._step)
        except Exception as e:  # noqa: BLE001 - sampling must not stop training
            traceback.print_exc()
            print(f"Failed to sample from the model: {e}")

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------
    def _save_checkpoint(self):
        if self._epoch % self.save_checkpoint_epochs != 0:
            return
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "generator": self._generator.get_state()}
        metadata = {
            "step": self._step,
            "applied_steps": self._applied_steps,
            "epoch": self._epoch,
            "examples_processed": self._examples_processed,
            "time_taken": self._time_taken,
        }
        ckpt_utils.save_checkpoint(
            ckpt_utils.checkpoint_path(self.log_dir, self._epoch), state, metadata)
        if self.keep_checkpoints is not None:
            ckpt_utils.prune_checkpoints(self.log_dir, self.keep_checkpoints)

    def restore_checkpoint(self, epoch=None):
        """Restores Trainer state from self.log_dir (latest epoch by default)."""
        epoch = epoch or ckpt_utils.find_latest_epoch(self.log_dir)
        path = ckpt_utils.checkpoint_path(self.log_dir, epoch)
        print(f"Restoring trainer state from checkpoint {os.path.basename(path)}.")
        state, metadata = ckpt_utils.restore_checkpoint(path, map_location=self.device)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._generator.set_state(state["generator"].cpu())
        self._step = metadata["step"]
        self._applied_steps = metadata["applied_steps"]
        self._epoch = metadata["epoch"]
        self._examples_processed = metadata["examples_processed"]
        self._time_taken = metadata["time_taken"]
        # Purge any metrics logged after the restored step.
        self._writer.close()
        self._writer = MetricsWriter(self.log_dir, purge_step=self._step,
                                     use_tensorboard=self._use_tensorboard)

    # ------------------------------------------------------------------
    # Train / eval loop
    # ------------------------------------------------------------------
    def interleaved_train_and_eval(self, max_epochs, restore=True):
        """Trains, evaluating after each epoch. Auto-resumes when restore=True."""
        if restore:
            try:
                self.restore_checkpoint()
            except FileNotFoundError:
                print(f"No checkpoint found in {self.log_dir}. "
                      "Training from scratch.")

        for _ in range(max_epochs - self._epoch):
            start_time = time.time()
            pending = []  # (step, n_examples, on-device metrics)
            for x, y in self.train_loader:
                metrics, n = self.train_one_step(x, y)
                pending.append((self._step, n, metrics))
                self._step += 1
            # The epoch's one wait for the device: fetch all its metrics.
            values = ({k: torch.stack([m[k] for _, _, m in pending]).tolist()
                       for k in pending[0][2]} if pending else {})
            epoch_time = time.time() - start_time
            self._log_train_epoch(pending, values, epoch_time)
            self._evaluate()
            self._epoch += 1
            self._save_checkpoint()
            if self.sample_epochs and self._epoch % self.sample_epochs == 0:
                self.sample_one_batch()
        self._writer.flush()

    def _log_train_epoch(self, pending, values, epoch_time):
        # The epoch's wall time is spread evenly over its steps.
        per_step_time = epoch_time / max(len(pending), 1)
        for i, (step, n, _) in enumerate(pending):
            metrics = {k: v[i] for k, v in values.items()}
            if self.lr_schedule is not None:
                # The LR this step applied: the schedule advances only on
                # steps that were not skipped.
                lr = float(self.lr_schedule(self._applied_steps))
                self._writer.add_scalars("metrics/lr", {"group_0": lr}, step)
            applied = True
            if self.skip_grad_norm is not None:
                applied = metrics["grad_norm"] <= self.skip_grad_norm
            if applied and metrics.get("nonfinite_steps", 0.0):
                applied = False
            if applied:
                self._applied_steps += 1
            self._log_metrics(metrics, training=True, step=step)
            self._examples_processed += n
            self._time_taken += per_step_time
            self._writer.add_scalar(
                "speed/examples_per_sec",
                self._examples_processed / max(self._time_taken, 1e-12), step)
            self._writer.add_scalar(
                "speed/millis_per_example",
                self._time_taken / max(self._examples_processed, 1) * 1000, step)
            self._writer.add_scalar("speed/epoch", self._epoch, step)
            self._writer.add_scalar("speed/step", step, step)

    @torch.no_grad()
    def _evaluate(self):
        """Logs example-weighted means of the eval metrics."""
        self.model.eval()
        n_examples, sums = 0, {}
        for x, y in self.eval_loader:
            x, y = self._to_device(x, y)
            n = x.shape[0]
            if not n:
                continue
            for k, v in self.compute_metrics(x, y, training=False).items():
                v = torch.as_tensor(v).detach().double() * n
                sums[k] = sums[k] + v if k in sums else v
            n_examples += n
        if n_examples:
            self._log_metrics({k: float(v) / n_examples for k, v in sums.items()},
                              training=False, step=self._step)

    def _log_metrics(self, metrics, training, step):
        for key, metric in metrics.items():
            self._writer.add_scalars(
                f"metrics/{key}", {"train" if training else "eval": float(metric)},
                step)
