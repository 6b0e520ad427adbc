"""Convert the JAX package's flax UNet parameters to the port's ``state_dict``.

Names map ``ConvBlock_{i}/Conv_{0,1}/{kernel,bias}`` → ``blocks.{i}.conv{0,1}.
{weight,bias}``, ``ConvBlock_{i}/BatchNorm_{0,1}`` → ``blocks.{i}.bn{0,1}``
and the top-level 1×1 ``Conv_0`` → ``final``. Kernels go from HWIO to OIHW.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _hwio_to_oihw(k) -> torch.Tensor:
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def params_from_flax(
    params: Mapping, batch_stats: Mapping | None = None
) -> dict[str, torch.Tensor]:
    """flax ``variables["params"]`` (nested dicts of arrays) → state_dict.

    ``batch_stats``: ``variables["batch_stats"]`` when the UNet has batch norm.
    """
    sd: dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name == "Conv_0":
            sd["final.weight"] = _hwio_to_oihw(sub["kernel"])
            sd["final.bias"] = _t(sub["bias"])
            continue
        if not name.startswith("ConvBlock_"):
            raise KeyError(f"unexpected flax parameter group '{name}'")
        i = int(name.split("_")[1])
        for j in (0, 1):
            conv = sub[f"Conv_{j}"]
            sd[f"blocks.{i}.conv{j}.weight"] = _hwio_to_oihw(conv["kernel"])
            sd[f"blocks.{i}.conv{j}.bias"] = _t(conv["bias"])
            bn = sub.get(f"BatchNorm_{j}")
            if bn is None:
                continue
            if batch_stats is None:
                raise ValueError("batch-norm parameters need batch_stats")
            stats = batch_stats[name][f"BatchNorm_{j}"]
            sd[f"blocks.{i}.bn{j}.weight"] = _t(bn["scale"])
            sd[f"blocks.{i}.bn{j}.bias"] = _t(bn["bias"])
            sd[f"blocks.{i}.bn{j}.running_mean"] = _t(stats["mean"])
            sd[f"blocks.{i}.bn{j}.running_var"] = _t(stats["var"])
            sd[f"blocks.{i}.bn{j}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd
