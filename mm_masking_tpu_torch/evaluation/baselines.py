"""The five benchmark configurations of ``BASELINE.json`` as named entries
(counterpart of ``mm_masking_tpu.evaluation.baselines``):

  1. unweighted pt2pl ICP on scan pairs
  2. CA-CFAR peak extraction + constant-weight ICP over a sequence
  3. UNet mask + learned-weight ICP, end to end
  4. one batched backprop-through-ICP training step
  5. multi-sequence radar → lidar localization eval

Each runs on its inputs' device; the JAX package's ``jax.jit`` wrappers have
no counterpart (the eval solve replays its own CUDA graphs on the card).
"""
from __future__ import annotations

import torch

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.dicp import ICPConfig, icp
from mm_masking_tpu_torch.evaluation.localization import _valid
from mm_masking_tpu_torch.ops import cfar_mask, extract_pc


def config1_unweighted_pt2pl(cfg: Config, batch: dict) -> torch.Tensor:
    """Unweighted point-to-plane ICP on scan pairs → T (B, 4, 4)."""
    icp_cfg = ICPConfig(icp_type="pt2pl", max_iterations=50, differentiable=False)
    scan = batch["loc_data"]["filtered_pc"]
    return icp(scan, batch["map_data"]["pc"], batch["transforms"]["T_ml_init"],
               weight=_valid(scan), cfg=icp_cfg)["T"]


def config2_cacfar_constant_icp(cfg: Config, batch: dict, max_points: int = 4096):
    """CFAR peak extraction from the raw polar scan, then constant-weight
    ICP → (T, pc): the capability the reference holds in ``extract_pc`` but
    never wires into training (SURVEY.md §2.2)."""
    m = cfg.model
    loc = batch["loc_data"]
    fft = loc["fft_polar"] if "fft_polar" in loc else loc["fft_data"]
    with torch.no_grad():
        mask = cfar_mask(fft, m.res, a_thresh=m.a_thresh, b_thresh=m.b_thresh, diff=False)
        pc = extract_pc(mask, m.res, loc["azimuths"], loc["az_times"],
                        max_points=max_points, diff=False)
        out = icp(pc, batch["map_data"]["pc"], batch["transforms"]["T_ml_init"],
                  weight=_valid(pc), cfg=ICPConfig(icp_type=m.icp_type, max_iterations=50,
                                                   differentiable=False))
    return out["T"], pc


def config3_learned_mask_icp(policy, params: dict, batch: dict):
    """Learned UNet mask + weighted 50-iteration ICP, end to end →
    (T_pred, weight_mask)."""
    with torch.inference_mode():
        out = policy.apply(params, batch["loc_data"], batch["map_data"],
                           batch["transforms"]["T_ml_init"], train=False)
    return out.T_pred, out.weight_mask


def config4_train_step(trainer, state, batch):
    """One batched backprop-through-ICP training step."""
    return trainer.train_step(state, batch, mask_losses_active=True)


def config5_multi_sequence(trainer, state, sequences):
    """Multi-sequence localization eval."""
    from mm_masking_tpu_torch.evaluation.localization import evaluate_policy_on_sequences

    return evaluate_policy_on_sequences(trainer, state, sequences)
