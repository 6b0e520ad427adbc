"""Per-point weight lookup from the mask image, and the map points' BEV
occupancy (counterpart of ``mm_masking_tpu.ops.weights``; reference
``radar_utils.py:108-165``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from mm_masking_tpu_torch.ops.grid_sample import grid_sample_points
from mm_masking_tpu_torch.ops.radar import (
    CART_PIXEL_WIDTH,
    CART_RESOLUTION,
    point_to_cart_idx,
)


class WeightStats(NamedTuple):
    diff_mean_num_non0: torch.Tensor  # differentiable count, per-batch mean
    mean_num_non0: torch.Tensor  # hard count of weights > 0.05, per-batch mean
    mean_w: torch.Tensor
    max_w: torch.Tensor
    min_w: torch.Tensor


def extract_weights(
    mask: torch.Tensor,
    scan_pc: torch.Tensor,
    cart_resolution: float = CART_RESOLUTION,
    cart_pixel_width: int = CART_PIXEL_WIDTH,
) -> tuple[torch.Tensor, WeightStats]:
    """mask (B, H, W), scan_pc (B, N, 2/3) padded with (0, 0) rows →
    weights (B, N) and :class:`WeightStats` over the real points only.

    Pad points are routed to (−100, −100), so all four taps fall outside
    the image and their weight is exactly 0.
    """
    scan_pc = scan_pc.to(mask.dtype)
    grid_pc = point_to_cart_idx(
        scan_pc, cart_resolution, cart_pixel_width, min_to_plus_1=True
    )
    fake = (scan_pc[..., 0] == 0.0) & (scan_pc[..., 1] == 0.0)
    grid_pc = torch.where(fake[..., None], torch.full_like(grid_pc, -100.0), grid_pc)
    weights = grid_sample_points(mask, grid_pc, align_corners=True)

    B = weights.shape[0]
    real = ~fake
    n_real = real.sum().clamp(min=1)
    w = weights.detach()
    stats = WeightStats(
        diff_mean_num_non0=torch.where(
            real, 0.5 * torch.tanh(5.0 * weights) + 0.5, 0.0).sum() / B,
        mean_num_non0=((w > 0.05) & real).sum() / B,
        mean_w=torch.where(real, w, 0.0).sum() / n_real,
        max_w=torch.where(real, w, float("-inf")).max(),
        min_w=torch.where(real, w, float("inf")).min(),
    )
    return weights, stats


def extract_bev_from_pts(
    pc: torch.Tensor,
    cart_pixel_width: int = CART_PIXEL_WIDTH,
    cart_resolution: float = CART_RESOLUTION,
) -> torch.Tensor:
    """Points (B, N, 2/3) → binary BEV occupancy image (B, W, W), the target
    of the mask_pts loss term.

    Each point sets the 4 floor/ceil neighbour pixels of its fractional index
    to 1. Indices outside the image are first sent to the centre pixel,
    which is zeroed at the end; that also swallows the (0, 0) pad points.
    Not differentiable.
    """
    pc_idx = point_to_cart_idx(pc, cart_resolution, cart_pixel_width)  # (B, N, 2)
    mid = cart_pixel_width // 2
    pc_idx = torch.where((pc_idx < 0) | (pc_idx > cart_pixel_width - 1), float(mid), pc_idx)
    B = pc_idx.shape[0]
    lo = torch.floor(pc_idx).long()
    hi = torch.ceil(pc_idx).long()
    bev = torch.zeros((B, cart_pixel_width, cart_pixel_width), dtype=pc.dtype,
                      device=pc.device)
    b_idx = torch.arange(B, device=pc.device)[:, None].expand_as(lo[..., 0])
    one = bev.new_ones(())  # on the device: a Python 1.0 would be copied from the host
    for u in (lo[..., 0], hi[..., 0]):
        for v in (lo[..., 1], hi[..., 1]):
            bev.index_put_((b_idx, u, v), one)
    bev[:, mid, mid] = 0.0
    return bev
