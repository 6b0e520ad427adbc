"""Optimizer of the training step (counterpart of
``mm_masking_tpu.train.trainer.make_optimizer``, an optax chain).

The chain, in order: optax's elementwise ``clip`` of the gradients (when
``clip_value > 0``); Adam, or SGD with Nesterov momentum 1.0, at the
learning rate of the schedule (constant, or optax's
``warmup_cosine_decay_schedule`` step for step); all of it wrapped in
optax's ``apply_if_finite``: a step whose gradients hold any non-finite
value changes nothing, not even the optimizer's moments or the schedule's
step, and is counted. Unlike optax's default, a run never gives up and
applies a non-finite update (the JAX package sets the limit to 10⁸ for that
reason). The update itself is ``torch.optim``'s, applied to the parameters
in place.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from mm_masking_tpu_torch.config import TrainConfig


def make_schedule(t: TrainConfig) -> Callable[[int], float]:
    """Learning rate as a function of the number of updates applied so far."""
    if t.lr_schedule == "constant":
        return lambda count: t.learning_rate
    if t.lr_schedule != "cosine":
        raise ValueError(t.lr_schedule)
    if t.lr_decay_steps <= 0:
        raise ValueError(
            "lr_schedule='cosine' needs lr_decay_steps > 0 "
            "(num_epochs * ceil(samples / batch_size_train))")
    peak, warmup = t.learning_rate, t.lr_warmup_steps
    decay = t.lr_decay_steps - warmup
    if decay <= 0:
        raise ValueError("lr_decay_steps must exceed lr_warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup:  # linear from 0 to the peak
            return peak * count / warmup
        c = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return schedule


class Optimizer:
    """Clip → Adam/SGD at the scheduled rate, skipped whole on a non-finite
    gradient. ``count`` is the number of updates applied (the schedule's
    step); ``total_notfinite`` the number dropped."""

    def __init__(self, params: Sequence[torch.Tensor], t: TrainConfig):
        self.params = list(params)
        self.schedule = make_schedule(t)
        self.clip_value = t.clip_value
        lr = self.schedule(0)
        if t.optimizer == "adam":
            self.inner = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        elif t.optimizer == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=lr, momentum=1.0, nesterov=True)
        else:
            raise ValueError(t.optimizer)
        self.count = 0
        self.total_notfinite = 0

    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Apply one update from ``grads`` (in the order of ``params``);
        returns False, and changes nothing, if any gradient is not finite."""
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        if not finite:
            self.total_notfinite += 1
            return False
        for p, g in zip(self.params, grads):
            p.grad = g.clamp(-self.clip_value, self.clip_value) if self.clip_value > 0 else g
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "total_notfinite": self.total_notfinite}

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = state["count"]
        self.total_notfinite = state["total_notfinite"]


def make_optimizer(t: TrainConfig, params: Sequence[torch.Tensor]) -> Optimizer:
    return Optimizer(params, t)
