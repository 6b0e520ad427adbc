"""Checkpoints of the whole training state with ``torch.save`` (counterpart
of ``mm_masking_tpu.train.checkpoint``, which uses orbax).

A checkpoint ``<dir>/<name>.pt`` holds the UNet parameters, the optimizer's
state, the step and epoch counters, the best validation norm and the state
of the dropout generator, so a resumed run continues exactly.
"""
from __future__ import annotations

import os
import re

import torch

_EPOCH = re.compile(r"^epoch_(\d+)\.pt$")


def _path(directory: str, name: str) -> str:
    return os.path.join(os.path.abspath(directory), f"{name}.pt")


def save_checkpoint(directory: str, name: str, state: dict) -> str:
    """Write ``state`` (tensors, ints, floats, nested dicts) atomically."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, name)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(directory: str, name: str, map_location=None) -> dict:
    return torch.load(_path(directory, name), map_location=map_location,
                      weights_only=True)


def latest_epoch(directory: str) -> int | None:
    """Highest N among the ``epoch_N`` checkpoints in the directory, if any."""
    if not os.path.isdir(directory):
        return None
    found = [int(m.group(1)) for m in map(_EPOCH.match, os.listdir(directory)) if m]
    return max(found, default=None)
