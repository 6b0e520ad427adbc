"""Training loss and pose error metrics (counterpart of
``mm_masking_tpu.train.loss``; reference ``train_icp_weights.py:179-273``).

The ICP pose terms read the first-order planar twist from ``T − I`` (or
``T·T_gt⁻¹ − I``), reproduced as-is: rot = mean |sin θ|, trans = mean
‖(x, y)‖. The mask terms are BCEs of the mask against the FFT threshold
mask, the CFAR image and the map points' BEV occupancy; the point-count
term is ``mean_all_pts − diff_num_non0`` (or its hinge at a floor).

Under a mesh (``mesh=``, the batch this rank's rows of a sharded batch)
every batch mean is the global batch's: a mean over equal shards is the
mean of the ranks' means (:meth:`Mesh.mean`, whose backward leaves each
rank the gradient of its own rows), and the point-count hinge takes the
global means the policy gives it, so every rank computes the one-device
loss and components.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mm_masking_tpu_torch.config import LossWeights
from mm_masking_tpu_torch.geom import planar_xi_first_order, se3_inv
from mm_masking_tpu_torch.ops import extract_bev_from_pts


class LossComponents(NamedTuple):
    rot: torch.Tensor
    trans: torch.Tensor
    fft: torch.Tensor
    mask_pts: torch.Tensor
    cfar: torch.Tensor
    num_pts: torch.Tensor


def _bce_terms(pred: torch.Tensor):
    pred = pred.clamp(0.0, 1.0)
    return (pred, torch.log(pred).clamp(min=-100.0),
            torch.log1p(-pred).clamp(min=-100.0))


class _BCEElem(torch.autograd.Function):
    """Elementwise BCE with ``torch.nn.BCELoss``'s forward (logs clamped at
    −100) and its backward, (p − t) / max(p(1 − p), 1e-12): finite at
    p ∈ {0, 1}, where autograd through the clamped logs would give NaN.
    ``pred`` is clamped to [0, 1] first."""

    @staticmethod
    def forward(ctx, pred, target):
        ctx.save_for_backward(pred, target)
        _, log_p, log_1mp = _bce_terms(pred)
        return -(target * log_p + (1.0 - target) * log_1mp)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        p, log_p, log_1mp = _bce_terms(pred)
        d_pred = g * (p - target) / torch.clamp(p * (1.0 - p), min=1e-12)
        return d_pred, g * (log_1mp - log_p)


def bce(pred: torch.Tensor, target: torch.Tensor, mesh=None) -> torch.Tensor:
    """``torch.nn.BCELoss`` (mean) with the gradient of :class:`_BCEElem`."""
    loss = _BCEElem.apply(pred, target).mean()
    return loss if mesh is None else mesh.mean(loss)


def _relative(T_pred: torch.Tensor, T_gt: torch.Tensor, gt_eye: bool) -> torch.Tensor:
    return T_pred if gt_eye else T_pred @ se3_inv(T_gt)


def pose_errors(T_pred: torch.Tensor, T_gt: torch.Tensor, gt_eye: bool = True, mesh=None):
    """(rot_err, trans_err): mean |sin θ| and mean ‖(x, y)‖."""
    xi_theta, xi_r = planar_xi_first_order(_relative(T_pred, T_gt, gt_eye))
    rot = torch.linalg.vector_norm(xi_theta, dim=-1).mean()
    trans = torch.linalg.vector_norm(xi_r, dim=-1).mean()
    if mesh is not None:
        rot, trans = mesh.mean(rot), mesh.mean(trans)
    return rot, trans


def fft_threshold_mask(fft_data: torch.Tensor) -> torch.Tensor:
    """1 where a pixel exceeds 3× its scan's mean, else 0."""
    mean_scan = fft_data.mean(dim=(1, 2), keepdim=True)
    return (fft_data > 3.0 * mean_scan).to(fft_data.dtype)


def eval_training_loss(
    T_pred: torch.Tensor,
    mask: torch.Tensor,
    diff_num_non0: torch.Tensor,
    mean_all_pts: torch.Tensor,
    T_gt: torch.Tensor,
    batch_scan: dict,
    batch_map: dict,
    weights: LossWeights,
    *,
    mask_losses_active: bool = True,
    gt_eye: bool = True,
    cart_pixel_width: int = 640,
    cart_resolution: float = 0.2384,
    mesh=None,
) -> tuple[torch.Tensor, LossComponents]:
    """The weighted 6-term loss and its (detached, weighted) components.
    ``mean_all_pts`` and ``diff_num_non0`` are batch means (the global
    batch's under a ``mesh``).

    ``mask_losses_active`` is the reference's ``icp_loss_only_iter`` gate: the
    mask terms run while it is true, and always when both ICP terms are off.
    """
    zero = torch.zeros((), dtype=T_pred.dtype, device=T_pred.device)
    loss_rot = loss_trans = loss_fft = loss_mask_pts = loss_cfar = loss_num_pts = zero

    if weights.icp_rot > 0.0 or weights.icp_trans > 0.0:
        loss_rot, loss_trans = pose_errors(T_pred, T_gt, gt_eye=gt_eye, mesh=mesh)

    if mask_losses_active or (weights.icp_rot <= 0 and weights.icp_trans <= 0):
        if weights.fft > 0.0:
            loss_fft = bce(mask, fft_threshold_mask(batch_scan["fft_data"]), mesh)
        if weights.cfar > 0.0:
            loss_cfar = bce(mask, batch_scan["fft_cfar"], mesh)
        if weights.mask_pts > 0.0:
            if tuple(mask.shape[-2:]) != (cart_pixel_width, cart_pixel_width):
                # A polar mask against the cartesian BEV: the JAX package's
                # shapes do not broadcast there either (ROADMAP §3, Decisions).
                raise ValueError(
                    f"loss.mask_pts compares the mask {tuple(mask.shape)} with the map's "
                    f"cartesian BEV {(mask.shape[0], cart_pixel_width, cart_pixel_width)}; "
                    "a polar network output trains with loss.mask_pts=0")
            map_bev = extract_bev_from_pts(batch_map["pc"][..., :3],
                                           cart_pixel_width=cart_pixel_width,
                                           cart_resolution=cart_resolution)
            loss_mask_pts = bce(mask, map_bev, mesh)
        if weights.num_pts > 0.0:
            if weights.num_pts_floor > 0.0:
                # Hinge: the linear term's gradient below the floor, 0 above;
                # of the global means, so a mesh applies it once, globally.
                loss_num_pts = torch.maximum(
                    weights.num_pts_floor * mean_all_pts - diff_num_non0, zero)
            else:
                loss_num_pts = mean_all_pts - diff_num_non0

    loss = (weights.icp_rot * loss_rot + weights.icp_trans * loss_trans
            + weights.fft * loss_fft + weights.mask_pts * loss_mask_pts
            + weights.cfar * loss_cfar + weights.num_pts * loss_num_pts)
    comp = LossComponents(
        rot=(weights.icp_rot * loss_rot).detach(),
        trans=(weights.icp_trans * loss_trans).detach(),
        fft=(weights.fft * loss_fft).detach(),
        mask_pts=(weights.mask_pts * loss_mask_pts).detach(),
        cfar=(weights.cfar * loss_cfar).detach(),
        num_pts=(weights.num_pts * loss_num_pts).detach(),
    )
    return loss, comp


def eval_validation_loss(T_pred: torch.Tensor, T_gt: torch.Tensor,
                         gt_eye: bool = True, mesh=None) -> torch.Tensor:
    """(norm, rot, trans) error triple, shape (3,); under a ``mesh`` over
    every rank's items, gathered in rank order."""
    if mesh is not None:
        T_pred, T_gt = mesh.gather(T_pred), mesh.gather(T_gt)
    xi_theta, xi_r = planar_xi_first_order(_relative(T_pred, T_gt, gt_eye))
    xi_stack = torch.cat([xi_theta, xi_r], dim=-1)
    return torch.stack([
        torch.linalg.vector_norm(xi_stack, dim=-1).mean(),
        torch.linalg.vector_norm(xi_theta, dim=-1).mean(),
        torch.linalg.vector_norm(xi_r, dim=-1).mean(),
    ])
