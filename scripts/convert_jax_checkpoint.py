#!/usr/bin/env python
"""Convert a JAX run's orbax checkpoint into the PyTorch port's format.

    python scripts/convert_jax_checkpoint.py <run dir> [--name best_policy | epoch_N]
        [--out <dir>]

Reads the orbax directory ``<run dir>/<name>`` that ``mm_masking_tpu``'s
``Trainer`` writes (``best_policy`` by default, ``epoch_N`` on request) and the
run's ``config.json``, and writes ``<out>/<name>.pt`` in the layout that
``mm_masking_tpu_torch.train.checkpoint`` reads, with ``config.json`` copied
beside it (``--out`` defaults to the run directory). The port's
``localize --checkpoint <out>`` then runs on the JAX run's mask, and
``Trainer.resume`` continues the run from an ``epoch_N``:

- the UNet's flax params (and ``batch_stats``) through the port's
  ``models.convert.params_from_flax``;
- optax's Adam ``mu`` / ``nu`` (SGD's ``trace``) into the port's moments,
  one to one, and the count of applied updates into the port's ``count``
  (Adam's own count; for SGD the schedule's, else the steps taken less the
  dropped ones); ``apply_if_finite``'s ``total_notfinite``; the step, epoch
  and best validation norm;
- not the dropout stream: JAX's PRNG key has no torch counterpart, so a
  resumed port run draws its dropout masks from ``train.seed``.

An optimizer state of another shape is not carried: the parameters are
written with a fresh optimizer, and the script says so on stderr.

The script reads orbax, so it runs where the JAX package is installed; the
``.pt`` is then carried to the machine with the card. The port itself
imports neither JAX nor orbax.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import orbax.checkpoint as ocp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mm_masking_tpu_torch.config import Config  # noqa: E402
from mm_masking_tpu_torch.models.convert import params_from_flax  # noqa: E402
from mm_masking_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from mm_masking_tpu_torch.train.trainer import Trainer  # noqa: E402


def read_orbax(run_dir: str, name: str) -> dict:
    """The raw tree of a saved JAX ``TrainState``: a dict with ``variables``,
    ``opt_state``, ``step``, ``epoch``, ``best_norm`` and ``rng``."""
    path = os.path.abspath(os.path.join(run_dir, name))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no orbax checkpoint of that name")
    raw = ocp.StandardCheckpointer().restore(path)
    if not isinstance(raw, dict) or "variables" not in raw:
        raise ValueError(f"{path} does not hold a mm_masking_tpu TrainState")
    return raw


def _find(tree, keys: set[str]):
    """The first dict in ``tree`` (nested dicts and lists) whose keys are
    ``keys``, or None."""
    if isinstance(tree, dict):
        if set(tree) == keys:
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find(child, keys)
        if found is not None:
            return found
    return None


def optimizer_state(opt_state: dict, kind: str, step: int) -> tuple[list, int] | None:
    """(moment trees in the port's order, applied updates) of optax's
    ``apply_if_finite`` state, or None where it does not map one to one."""
    inner = opt_state.get("inner_state")
    schedule = _find(inner, {"count"})
    if kind == "adam":
        adam = _find(inner, {"count", "mu", "nu"})
        if adam is None:
            return None
        count = int(adam["count"])
        if schedule is not None and int(schedule["count"]) != count:
            return None
        return [adam["mu"], adam["nu"]], count
    trace = _find(inner, {"trace"})
    if trace is None:
        return None
    if schedule is not None:
        count = int(schedule["count"])
    else:
        count = step - int(opt_state["total_notfinite"])
    return [trace["trace"]], count


def convert(run_dir: str, name: str = "best_policy", out: str | None = None) -> str:
    """Write ``<out>/<name>.pt`` from the JAX run's ``<run_dir>/<name>``;
    returns its path."""
    out = out or run_dir
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    raw = read_orbax(run_dir, name)
    variables = raw["variables"]
    batch_stats = variables.get("batch_stats")

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=out))
    trainer = Trainer(cfg, "cpu")
    state = trainer.init_state()
    step = int(raw["step"])
    with torch.no_grad():
        for k, v in params_from_flax(variables["params"], batch_stats).items():
            state.params[k].copy_(v)
        carried = optimizer_state(raw["opt_state"], cfg.train.optimizer, step)
        if carried is None:
            print(f"convert_jax_checkpoint: the optimizer state of {name} does not map one to "
                  "one onto the port's; parameters written with a fresh optimizer",
                  file=sys.stderr)
        else:
            trees, count = carried
            for tree, moments in zip(trees, state.opt.moments):
                sd = params_from_flax(tree, batch_stats)
                for i, pname in enumerate(trainer._trained):
                    moments[i].copy_(sd[pname])
            state.opt.count.fill_(count)
            state.opt.total_notfinite.fill_(int(raw["opt_state"]["total_notfinite"]))
    # Trainer.save's layout, with no dropout stream (Trainer.restore keeps
    # the one init_state seeded from train.seed).
    path = save_checkpoint(out, name, {
        "params": {k: v.detach() for k, v in state.params.items()},
        "opt": state.opt.state_dict(),
        "step": step,
        "epoch": int(raw["epoch"]),
        "best_norm": float(np.asarray(raw["best_norm"])),
        "generator": None,
    })
    if os.path.abspath(out) != os.path.abspath(run_dir):
        shutil.copy(os.path.join(run_dir, "config.json"), os.path.join(out, "config.json"))
    return path


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("run_dir", help="the JAX run's checkpoint directory (config.json and "
                        "the orbax checkpoints)")
    parser.add_argument("--name", default="best_policy", help="best_policy | epoch_N")
    parser.add_argument("--out", default=None, help="where the .pt and config.json go "
                        "(default: the run directory)")
    args = parser.parse_args(argv)
    print(convert(args.run_dir, args.name, args.out))


if __name__ == "__main__":
    main()
