"""Bilinear sampling with ``F.grid_sample`` conventions (zero padding).

Counterpart of ``mm_masking_tpu.ops.grid_sample``, which re-implements
exactly these semantics in JAX; here the native operator is the function.
``grid[..., 0]`` indexes the width (x) axis, ``grid[..., 1]`` the height.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(
    input_: torch.Tensor, grid: torch.Tensor, *, align_corners: bool = True
) -> torch.Tensor:
    """Sample ``input_`` (N, C, H, W) at ``grid`` (N, Ho, Wo, 2) → (N, C, Ho, Wo)."""
    return F.grid_sample(
        input_, grid.to(input_.dtype), mode="bilinear", padding_mode="zeros",
        align_corners=align_corners,
    )


def grid_sample_points(
    image: torch.Tensor, coords: torch.Tensor, *, align_corners: bool = True
) -> torch.Tensor:
    """Sample a batched single-channel image (N, H, W) at per-point
    normalised coordinates (N, P, 2) → (N, P)."""
    out = grid_sample_2d(image[:, None], coords[:, :, None, :],
                         align_corners=align_corners)
    return out[:, 0, :, 0]
