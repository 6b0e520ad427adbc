"""Pose error metrics (counterpart of ``mm_masking_tpu.train.loss``; reference
``train_icp_weights.py:255-273``): the first-order planar twist read from
``T − I`` (or ``T·T_gt⁻¹ − I``), reproduced as-is."""
from __future__ import annotations

import torch

from mm_masking_tpu_torch.geom import planar_xi_first_order, se3_inv


def _relative(T_pred: torch.Tensor, T_gt: torch.Tensor, gt_eye: bool) -> torch.Tensor:
    return T_pred if gt_eye else T_pred @ se3_inv(T_gt)


def pose_errors(T_pred: torch.Tensor, T_gt: torch.Tensor, gt_eye: bool = True):
    """(rot_err, trans_err): mean |sin θ| and mean ‖(x, y)‖."""
    xi_theta, xi_r = planar_xi_first_order(_relative(T_pred, T_gt, gt_eye))
    return (torch.linalg.vector_norm(xi_theta, dim=-1).mean(),
            torch.linalg.vector_norm(xi_r, dim=-1).mean())


def eval_validation_loss(T_pred: torch.Tensor, T_gt: torch.Tensor,
                         gt_eye: bool = True) -> torch.Tensor:
    """(norm, rot, trans) error triple, shape (3,)."""
    xi_theta, xi_r = planar_xi_first_order(_relative(T_pred, T_gt, gt_eye))
    xi_stack = torch.cat([xi_theta, xi_r], dim=-1)
    return torch.stack([
        torch.linalg.vector_norm(xi_stack, dim=-1).mean(),
        torch.linalg.vector_norm(xi_theta, dim=-1).mean(),
        torch.linalg.vector_norm(xi_r, dim=-1).mean(),
    ])
