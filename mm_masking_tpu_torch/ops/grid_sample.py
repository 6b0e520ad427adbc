"""Bilinear sampling with ``F.grid_sample`` conventions (zero padding).

Counterpart of ``mm_masking_tpu.ops.grid_sample``, which re-implements
exactly these semantics in JAX; here the native operator is the function.
``grid[..., 0]`` indexes the width (x) axis, ``grid[..., 1]`` the height.
The per-point lookup, which the train step differentiates, takes the
image's gradient from the gather-form kernel of
:mod:`mm_masking_tpu_torch.ops.kernels.resample` on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mm_masking_tpu_torch.ops.kernels.resample import sample_points


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
    return sample_points(image, coords.to(image.dtype), align_corners)
