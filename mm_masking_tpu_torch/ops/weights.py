"""Per-point weight lookup from the mask image (counterpart of
``mm_masking_tpu.ops.weights``; reference ``radar_utils.py:108-140``)."""
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
