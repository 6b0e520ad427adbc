"""Faults planted in the program's timed path, for the tests and the
calibration that show the check failing them. Each is a context manager
that patches the program while it is open.

* ``unchanged``: the train step leaves its state as it was (the optimizer
  applies nothing);
* ``half_batch``: the steps see only the first half of each batch, so every
  mean is taken over the rest;
* ``altered``: one answer altered where it is produced: the first item's
  estimated pose moved by :data:`SHIFT_M` in x before the loss (train) or
  the error triple (eval) reads it.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

SHIFT_M = 0.5


@contextlib.contextmanager
def unchanged():
    from mm_masking_tpu_torch.train import optim

    def step(self, grads):
        return torch.ones((), dtype=torch.bool, device=self.count.device)

    with mock.patch.object(optim.Optimizer, "step", step):
        yield


def _half(batch):
    if isinstance(batch, dict):
        return {k: _half(v) for k, v in batch.items()}
    return batch[: max(1, batch.shape[0] // 2)]


@contextlib.contextmanager
def half_batch():
    from mm_masking_tpu_torch.train.trainer import Trainer

    real = Trainer.local_batch

    def local_batch(self, batch):
        batch, mesh, rows = real(self, batch)
        return _half(batch), mesh, rows

    with mock.patch.object(Trainer, "local_batch", local_batch):
        yield


def _moved(T):
    shift = torch.zeros_like(T)
    shift[0, 0, 3].fill_(SHIFT_M)  # a fill, not a copy from the host: it can be captured
    return T + shift


@contextlib.contextmanager
def altered():
    from mm_masking_tpu_torch.train import trainer

    train_loss, val_loss = trainer.eval_training_loss, trainer.eval_validation_loss

    def eval_training_loss(T_pred, *args, **kwargs):
        return train_loss(_moved(T_pred), *args, **kwargs)

    def eval_validation_loss(T_pred, *args, **kwargs):
        return val_loss(_moved(T_pred), *args, **kwargs)

    with mock.patch.object(trainer, "eval_training_loss", eval_training_loss), \
            mock.patch.object(trainer, "eval_validation_loss", eval_validation_loss):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
