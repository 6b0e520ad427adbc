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
reason).

The whole update runs on the parameters' device, as the reference's does:
the finiteness flag, the schedule's step ``count`` and ``total_notfinite``
are device tensors, the learning rate is computed from ``count`` there, and
a dropped step is a select. A step reads nothing back to the host, so it
can be captured in a CUDA graph. The update is written with
``torch._foreach_*`` ops, in optax's order of operations, and applied to the
parameters in place.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from mm_masking_tpu_torch.config import TrainConfig

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_schedule(t: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Learning rate, a float32 tensor, as a function of the number of
    updates applied so far (an integer tensor, on the device the rate is
    wanted on, or an int)."""
    if t.lr_schedule == "constant":
        return lambda count: torch.full_like(torch.as_tensor(count), t.learning_rate,
                                             dtype=torch.float32)
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

    def schedule(count) -> torch.Tensor:
        c = torch.as_tensor(count).to(torch.float32)
        lr = peak * 0.5 * (1.0 + torch.cos(math.pi * (c - warmup).clamp(0.0, decay) / decay))
        if warmup:  # linear from 0 to the peak
            lr = torch.where(c < warmup, peak * c / warmup, lr)
        return lr

    return schedule


class Optimizer:
    """Clip → Adam/SGD at the scheduled rate, skipped whole on a non-finite
    gradient. ``count`` is the number of updates applied (the schedule's
    step, and Adam's), ``total_notfinite`` the number dropped: both int64
    tensors on the parameters' device, updated in place, as are the
    moments."""

    def __init__(self, params: Sequence[torch.Tensor], t: TrainConfig):
        if t.optimizer not in ("adam", "sgd"):
            raise ValueError(t.optimizer)
        self.params = list(params)
        self.kind = t.optimizer
        self.schedule = make_schedule(t)
        self.clip_value = t.clip_value
        device = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.total_notfinite = torch.zeros((), dtype=torch.int64, device=device)
        n_moments = 2 if self.kind == "adam" else 1  # (exp_avg, exp_avg_sq) or momentum
        self.moments = [[torch.zeros_like(p, requires_grad=False) for p in self.params]
                        for _ in range(n_moments)]

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor a step updates in place: parameters, moments, counters."""
        return [*self.params, *(m for ms in self.moments for m in ms), self.count,
                self.total_notfinite]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one update from ``grads`` (in the order of ``params``);
        returns the finiteness flag, a bool tensor: where it is False the
        step changed nothing but ``total_notfinite``."""
        grads = list(grads)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        # A dropped step's non-finite values must reach no state: its
        # gradients become zeros, and every update below is scaled to
        # nothing by `keep` (products of finite values with 0, added).
        grads = [torch.where(finite, g, 0.0) for g in grads]
        if self.clip_value > 0:
            torch._foreach_clamp_min_(grads, -self.clip_value)
            torch._foreach_clamp_max_(grads, self.clip_value)
        keep = finite.to(torch.float32)
        neg_lr = self.schedule(self.count) * -keep
        if self.kind == "adam":
            update = self._adam(grads, finite, keep)
        else:
            update = self._sgd(grads)
        torch._foreach_mul_(update, neg_lr)
        torch._foreach_add_(self.params, update)
        self.count.add_(finite)
        self.total_notfinite.add_(~finite)
        return finite

    def _adam(self, grads, finite, keep) -> list[torch.Tensor]:
        """optax's ``scale_by_adam``: mu ← b1·mu + (1 − b1)·g, nu ← b2·nu +
        (1 − b2)·g², both unchanged on a dropped step; the update
        mû / (√nû + eps) with the bias corrections at count + 1."""
        mu, nu = self.moments
        torch._foreach_mul_(mu, torch.where(finite, ADAM_B1, 1.0))
        torch._foreach_add_(mu, torch._foreach_mul(grads, (1.0 - ADAM_B1) * keep))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, (1.0 - ADAM_B2) * keep)
        torch._foreach_mul_(nu, torch.where(finite, ADAM_B2, 1.0))
        torch._foreach_add_(nu, g2)
        t = (self.count + 1).to(torch.float32)
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(ADAM_B1, t))
        den = torch._foreach_div(nu, 1.0 - torch.pow(ADAM_B2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        return torch._foreach_div(mu_hat, den)

    def _sgd(self, grads) -> list[torch.Tensor]:
        """optax's Nesterov ``trace`` at momentum 1: t ← g + t (unchanged on a
        dropped step, where g is 0), update g + t."""
        (trace,) = self.moments
        torch._foreach_add_(trace, grads)
        return torch._foreach_add(grads, trace)

    def state_dict(self) -> dict:
        """The format of the checkpoints: ``inner`` as ``torch.optim.Adam`` /
        ``SGD`` write it, the counters as ints."""
        count = int(self.count)
        if self.kind == "adam":
            mu, nu = self.moments
            state = {i: {"step": torch.tensor(float(count)), "exp_avg": m, "exp_avg_sq": v}
                     for i, (m, v) in enumerate(zip(mu, nu))}
            group = {"lr": float(self.schedule(count)), "betas": (ADAM_B1, ADAM_B2),
                     "eps": ADAM_EPS, "weight_decay": 0, "amsgrad": False}
        else:
            state = {i: {"momentum_buffer": m} for i, m in enumerate(self.moments[0])}
            group = {"lr": float(self.schedule(count)), "momentum": 1.0,
                     "dampening": 0, "weight_decay": 0, "nesterov": True}
        group.update(maximize=False, foreach=None, differentiable=False,
                     params=list(range(len(self.params))))
        return {"inner": {"state": state, "param_groups": [group]}, "count": count,
                "total_notfinite": int(self.total_notfinite)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Load :meth:`state_dict`'s format in place; a parameter without
        saved moments (a checkpoint taken before the first update) gets
        zeros."""
        saved = state["inner"]["state"]
        keys = ("exp_avg", "exp_avg_sq") if self.kind == "adam" else ("momentum_buffer",)
        for i in range(len(self.params)):
            for key, moments in zip(keys, self.moments):
                if i in saved:
                    moments[i].copy_(saved[i][key])
                else:
                    moments[i].zero_()
        self.count.fill_(int(state["count"]))
        self.total_notfinite.fill_(int(state["total_notfinite"]))


def make_optimizer(t: TrainConfig, params: Sequence[torch.Tensor]) -> Optimizer:
    return Optimizer(params, t)
