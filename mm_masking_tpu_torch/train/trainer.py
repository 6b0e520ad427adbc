"""Evaluation driver (counterpart of ``mm_masking_tpu.train.trainer``).

This slice ports the inference half: parameter init, the eval step and the
validation pass. The optimizer, the train step and checkpoints come with the
training path (ROADMAP.md queue 1).
"""
from __future__ import annotations

from typing import Iterable

import torch

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.models.policy import LearnICPWeightPolicy
from mm_masking_tpu_torch.train.loss import eval_validation_loss


class Trainer:
    def __init__(self, cfg: Config, device: torch.device | str):
        self.cfg = cfg
        self.device = torch.device(device)
        self.policy = LearnICPWeightPolicy(cfg, self.device)

    def init_state(self, seed: int | None = None) -> dict[str, torch.Tensor]:
        """Xavier-initialised UNet parameters from a seeded CPU generator
        (the same values on any device)."""
        seed = self.cfg.train.seed if seed is None else seed
        return self.policy.init(torch.Generator().manual_seed(seed))

    @torch.inference_mode()
    def eval_step(self, params: dict, batch: dict, binary: bool = False):
        """One inference step → (err (3,), WeightStats, weight_mask (B, H, W))."""
        out = self.policy.apply(
            params,
            batch["loc_data"],
            batch["map_data"],
            batch["transforms"]["T_ml_init"],
            train=False,
            binary=binary,
        )
        err = eval_validation_loss(
            out.T_pred, batch["transforms"]["T_ml_gt"], gt_eye=self.cfg.model.gt_eye)
        return err, out.stats, out.weight_mask

    def validate(self, params: dict, batches: Iterable, binary: bool = False):
        """Mean error triple over the batches, and the weight statistics:
        (err (3,), mean_num_pc, mean_w, max_w, min_w). One host readback at
        the end."""
        errs, num_pc, ws, max_ws, min_ws = [], [], [], [], []
        for batch in batches:
            err, stats, _ = self.eval_step(params, batch, binary=binary)
            errs.append(err)
            num_pc.append(stats.mean_num_non0)
            ws.append(stats.mean_w)
            max_ws.append(stats.max_w)
            min_ws.append(stats.min_w)
        return (
            torch.stack(errs).mean(0),
            float(torch.stack(num_pc).float().mean()),
            float(torch.stack(ws).mean()),
            float(torch.stack(max_ws).max()),
            float(torch.stack(min_ws).min()),
        )
