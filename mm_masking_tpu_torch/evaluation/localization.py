"""Sequence localization evaluation harness (counterpart of
``mm_masking_tpu.evaluation.localization``).

Every frame of every sequence is an independent scan → map localization
problem, so a sequence's batches are solved one after another on one
device, or, through a trainer with a mesh, each batch sharded over the
mesh's cards, every rank gathering the per-frame errors. Error statistics
mirror ``eval_validation_loss`` (``train_icp_weights.py:255-273``) plus the
RMSE and per-frame breakdown of the reference's offline
``utils/extract_*_gt.py`` scripts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

import numpy as np
import torch

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.dicp import ICPConfig, icp
from mm_masking_tpu_torch.geom import planar_xi_first_order, se3_inv
from mm_masking_tpu_torch.ops import extract_weights


@dataclasses.dataclass
class SequenceErrors:
    """Per-sequence localization error summary."""

    n_frames: int
    rot_mean: float
    rot_rmse: float
    rot_max: float
    trans_mean: float
    trans_rmse: float
    trans_max: float
    norm_mean: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def frame_errors(T_pred: torch.Tensor, T_gt: torch.Tensor, gt_eye: bool = True):
    """Per-frame (rot, trans) errors under the reference's convention."""
    T = T_pred if gt_eye else T_pred @ se3_inv(T_gt)
    xi_theta, xi_r = planar_xi_first_order(T)
    return xi_theta[..., 0].abs(), torch.linalg.vector_norm(xi_r, dim=-1)


def summarize(rot: np.ndarray, trans: np.ndarray) -> SequenceErrors:
    norm = np.sqrt(rot**2 + trans**2)
    return SequenceErrors(
        n_frames=int(rot.shape[0]),
        rot_mean=float(rot.mean()),
        rot_rmse=float(np.sqrt((rot**2).mean())),
        rot_max=float(rot.max()),
        trans_mean=float(trans.mean()),
        trans_rmse=float(np.sqrt((trans**2).mean())),
        trans_max=float(trans.max()),
        norm_mean=float(norm.mean()),
    )


def _inference_icp(cfg: Config, max_iterations: int) -> ICPConfig:
    return ICPConfig(icp_type=cfg.model.icp_type, max_iterations=max_iterations,
                     tolerance=1e-5, differentiable=False)


def _valid(scan_pc: torch.Tensor) -> torch.Tensor:
    """1 on a scan's real points, 0 on its (0, 0, ·) pad rows."""
    return (~((scan_pc[..., 0] == 0.0) & (scan_pc[..., 1] == 0.0))).to(scan_pc.dtype)


def make_constant_weight_localizer(cfg: Config, max_iterations: int = 50):
    """Batched localizer with all-ones weights on the scan's real points
    (baseline configs 1-2); runs on the inputs' device."""
    icp_cfg = _inference_icp(cfg, max_iterations)

    def localize(scan_pc, map_pc, T_init):
        return icp(scan_pc, map_pc, T_init, weight=_valid(scan_pc), cfg=icp_cfg)["T"]

    return localize


def make_masked_localizer(cfg: Config, max_iterations: int = 50):
    """Batched localizer sampling its weights from a mask image (baseline
    config 2 with a CFAR mask, or a learned mask)."""
    icp_cfg = _inference_icp(cfg, max_iterations)
    m = cfg.model

    def localize(mask, scan_pc, map_pc, T_init):
        weights, _ = extract_weights(mask, scan_pc, cart_resolution=m.cart_resolution,
                                     cart_pixel_width=m.cart_pixel_width)
        return icp(scan_pc, map_pc, T_init, weight=weights, cfg=icp_cfg)["T"]

    return localize


def evaluate_sequence(
    batches: Iterable[dict],
    localize_fn: Callable[[dict], torch.Tensor],
    gt_eye: bool = True,
) -> SequenceErrors:
    """Run a localizer over a sequence's batches and summarize the errors.

    ``localize_fn`` maps a batch dict → (B, 4, 4) predicted transforms.
    """
    rots, trans = [], []
    for batch in batches:
        T_pred = localize_fn(batch)
        r, t = frame_errors(T_pred, batch["transforms"]["T_ml_gt"].to(T_pred.device),
                            gt_eye=gt_eye)
        rots.append(r.cpu().numpy())
        trans.append(t.cpu().numpy())
    return summarize(np.concatenate(rots), np.concatenate(trans))


def evaluate_policy_on_sequences(
    trainer,
    state,
    sequences: dict[str, Callable[[], Iterable[dict]]],
    binary: bool = False,
) -> dict[str, SequenceErrors]:
    """Config-5 entry: learned-mask localization over several sequences,
    streamed one batch at a time through the trainer's policy on its
    device (``state``: a ``TrainState``). Under the trainer's mesh each
    batch is sharded over it (the JAX package's sharded sweep) and every
    rank returns the whole sequences' errors."""
    results = {}
    for name, batches_fn in sequences.items():
        rots, trans = [], []
        for batch in batches_fn():
            batch, mesh, _ = trainer.local_batch(batch)
            with torch.inference_mode():
                out = trainer.policy.apply(
                    state.params, batch["loc_data"], batch["map_data"],
                    batch["transforms"]["T_ml_init"], train=False, binary=binary, mesh=mesh)
                r, t = frame_errors(out.T_pred, batch["transforms"]["T_ml_gt"],
                                    gt_eye=trainer.cfg.model.gt_eye)
                if mesh is not None:
                    r, t = mesh.gather(r), mesh.gather(t)
            rots.append(r.cpu().numpy())
            trans.append(t.cpu().numpy())
        results[name] = summarize(np.concatenate(rots), np.concatenate(trans))
    return results
