"""Checkpoints of the whole training state with ``torch.save`` (counterpart
of ``mm_masking_tpu.train.checkpoint``, which uses orbax).

A checkpoint ``<dir>/<name>.pt`` holds the UNet parameters (with the batch
norm's running statistics, when the UNet has batch norm), the optimizer's
state, the step and epoch counters, the best validation norm and the state
of the dropout generator, so a resumed run continues exactly. Under a mesh
rank 0 writes it and every rank restores it.
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
    path = _path(directory, name)
    orbax_dir = os.path.join(os.path.abspath(directory), name)
    if not os.path.exists(path) and os.path.isdir(orbax_dir):
        raise FileNotFoundError(
            f"{path} not found, but {orbax_dir} is: a JAX (orbax) checkpoint. Convert it "
            f"with `python scripts/convert_jax_checkpoint.py {directory} --name {name}`, "
            "where the JAX package is installed")
    return torch.load(path, map_location=map_location, weights_only=True)


def load_policy_variables(directory: str, name: str = "best_policy",
                          map_location=None) -> dict:
    """The UNet parameters of checkpoint ``name`` (as ``Trainer.save`` wrote
    it), without the optimizer's state: what an inference-only consumer,
    such as the localization CLI's ``--checkpoint``, needs."""
    return load_checkpoint(directory, name, map_location=map_location)["params"]


def latest_epoch(directory: str) -> int | None:
    """Highest N among the ``epoch_N`` checkpoints in the directory, if any."""
    if not os.path.isdir(directory):
        return None
    found = [int(m.group(1)) for m in map(_EPOCH.match, os.listdir(directory)) if m]
    return max(found, default=None)
