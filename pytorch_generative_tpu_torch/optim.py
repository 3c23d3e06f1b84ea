"""Optimizers with optax's semantics (counterpart of
``pytorch_generative_tpu/optim.py``).

``Adam`` computes what ``optax.adam`` computes and ``AdaBelief`` what the JAX
package's ``adabelief`` computes: bias-corrected moments, eps outside the
square root, and the learning rate of step t taken from a schedule at the
count of steps applied before it. That count is a 0-d tensor on the
parameters' device, so neither the schedule nor the bias corrections ever
wait for the host, and ``step(keep=...)`` can drop a step on the device: a
dropped step moves neither the parameters, the moments nor the count, so it
ticks no learning rate (the Trainer's ``skip_grad_norm`` and
``skip_nonfinite``).

Like the JAX package's helpers, ``adam`` and ``adam_multiplicative`` return
``(make_optimizer, lr_schedule)``: ``make_optimizer(params)`` builds the
optimizer and ``lr_schedule(t)`` is the learning rate after t applied steps,
for logging. ``adabelief`` returns ``make_optimizer`` alone.
"""

from __future__ import annotations

import functools

import torch


class _Adaptive(torch.optim.Optimizer):
    """Adam-style updates over one shared count of applied steps.

    ``lr`` is a float or a schedule ``lr(count)`` that takes an int or a 0-d
    tensor. Subclasses say how the second moment moves.
    """

    def __init__(self, params, lr=1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps))
        # Kept out of the param groups, so that state_dict holds no function.
        self.lr_schedule = lr if callable(lr) else lambda _: lr
        if len(self.param_groups) != 1:
            raise ValueError("one parameter group only: the schedule and the "
                             "count of applied steps are shared")
        first = self.param_groups[0]["params"][0]
        self.count = torch.zeros((), dtype=torch.int64, device=first.device)

    def _second_moment(self, nus, grads, mus, group):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, keep=None):
        """Applies one update from the parameters' ``.grad``. ``keep``, a
        0-d bool tensor, commits the step only where it is true."""
        group = self.param_groups[0]
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            return
        grads = [p.grad for p in params]
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p)
                self.state[p]["nu"] = torch.zeros_like(p)
        mus = [self.state[p]["mu"] for p in params]
        nus = [self.state[p]["nu"] for p in params]
        state = params + mus + nus
        before = None if keep is None else [t.clone() for t in state]

        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        t = self.count + 1
        lr_t = self.lr_schedule(self.count)
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1 - b1)
        self._second_moment(nus, grads, mus, group)
        denom = torch._foreach_mul(nus, 1.0 / (1 - b2 ** t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_mul(mus, lr_t / (1 - b1 ** t))
        torch._foreach_div_(updates, denom)
        torch._foreach_sub_(params, updates)

        if keep is None:
            self.count += 1
        else:
            for cur, old in zip(state, before):
                cur.copy_(torch.where(keep, cur, old))
            self.count += keep

    def state_dict(self):
        out = super().state_dict()
        out["count"] = self.count
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = state_dict.pop("count").to(self.count.device)
        super().load_state_dict(state_dict)


class Adam(_Adaptive):
    """``optax.adam``: nu = b2 * nu + (1 - b2) * g^2."""

    def _second_moment(self, nus, grads, mus, group):
        torch._foreach_mul_(nus, group["b2"])
        torch._foreach_addcmul_(nus, grads, grads, value=1 - group["b2"])


class AdaBelief(_Adaptive):
    """AdaBelief (Zhuang et al. 2020) as the JAX package computes it: the
    second moment tracks (g - mu)^2 and takes eps inside at every step."""

    def __init__(self, params, lr=1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-10):
        super().__init__(params, lr, b1, b2, eps)

    def _second_moment(self, nus, grads, mus, group):
        diff = torch._foreach_sub(grads, mus)
        torch._foreach_mul_(nus, group["b2"])
        torch._foreach_addcmul_(nus, diff, diff, value=1 - group["b2"])
        torch._foreach_add_(nus, group["eps"])


def adabelief(learning_rate, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-10):
    """AdaBelief; ``learning_rate`` is a float or a schedule. Returns
    ``make_optimizer``."""
    return functools.partial(AdaBelief, lr=learning_rate, b1=b1, b2=b2, eps=eps)


def adam(learning_rate=1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    """``optax.adam``. Returns ``(make_optimizer, lr_schedule)``."""
    schedule = (learning_rate if callable(learning_rate)
                else lambda _: learning_rate)
    return (functools.partial(Adam, lr=learning_rate, b1=b1, b2=b2, eps=eps),
            schedule)


def adam_multiplicative(learning_rate: float, lr_multiplier: float = 1.0,
                        b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam with per-step multiplicative decay, lr_t = lr * multiplier^t (t
    counts applied steps). Returns ``(make_optimizer, lr_schedule)``."""
    if lr_multiplier == 1.0:
        return adam(learning_rate, b1=b1, b2=b2, eps=eps)
    return adam(lambda t: learning_rate * lr_multiplier ** t, b1=b1, b2=b2,
                eps=eps)
