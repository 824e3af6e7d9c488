"""Optimizer and learning-rate law, as ``nerf_tpu.train.optim``:

  * Adam with b1 0.9, b2 0.999, eps 1e-8, written as optax's
    ``scale_by_adam`` writes it (moments, bias correction by the
    incremented count, ``mu_hat / (sqrt(nu_hat) + eps)``);
  * per-step exponential decay with a floor, in float32 log space:
    ``lr(step) = lr0 * max(exp(step * ln(gamma)), lr_min / lr0)`` with
    ``gamma = lr_decay_factor ** (1 / (lr_decay * 1000))``;
  * the update at count k uses lr(k), the count before it increments (as
    optax evaluates the schedule).

Parameters update in place (the port keeps one copy of the weights); the
moments are float32 tensors beside them, updated with multi-tensor
``torch._foreach_*`` ops.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lr_schedule(learning_rate: float, lr_decay: float, lr_decay_factor: float,
                lr_min: float):
    """``schedule(step) -> float`` (float32 arithmetic)."""
    log_gamma = np.float32(math.log(float(lr_decay_factor))
                           / (float(lr_decay) * 1000.0))
    floor = np.float32(lr_min / learning_rate)
    lr0 = np.float32(learning_rate)

    def schedule(step: int) -> float:
        decay = np.exp(np.float32(step) * log_gamma, dtype=np.float32)
        return float(lr0 * np.maximum(decay, floor))

    return schedule


class Adam:
    """Adam over a fixed list of parameters, optax's update rule."""

    def __init__(self, params, schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads=None) -> None:
        """One update from ``grads`` (default: each parameter's ``.grad``;
        a missing grad counts as zero, as a zero cotangent does in JAX)."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        b1, b2 = self.b1, self.b2
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        # mu = (1 - b1) g + b1 mu ; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(sq, 1.0 - b2))
        # update = -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": [m.detach().to("cpu", copy=True) for m in self.mu],
                "nu": [n.detach().to("cpu", copy=True) for n in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.mu):
            raise ValueError(f"optimizer state has {len(state['mu'])} moments, "
                             f"the parameters {len(self.mu)}")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)


def make_optimizer(cfg, params) -> Adam:
    schedule = lr_schedule(cfg.learning_rate, cfg.lr_decay,
                           cfg.lr_decay_factor, cfg.lr_min)
    return Adam(params, schedule, b1=0.9, b2=0.999, eps=1e-8)
