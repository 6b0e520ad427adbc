"""Navtech radar geometry: cartesian pixel grids and the polar→cartesian warp.

Counterpart of ``mm_masking_tpu.ops.radar`` (reference
``radar_utils.py:258-336,374-419``): half-bin range offset, the
searchsorted azimuth "wobble" fix, first/last-azimuth crossover padding and
bilinear, zero-padded, align-corners sampling.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from mm_masking_tpu_torch.ops.grid_sample import grid_sample_2d

POLAR_RESOLUTION = 0.0596  # m / range bin
CART_RESOLUTION = 0.2384  # m / cartesian pixel
CART_PIXEL_WIDTH = 640
POLAR_SHAPE = (400, 3360)  # (azimuths, range bins)


@functools.lru_cache(maxsize=8)
def _cart_range_angle_grid_np(cart_resolution: float, cart_pixel_width: int):
    if cart_pixel_width % 2 == 0:
        cart_min_range = (cart_pixel_width / 2 - 0.5) * cart_resolution
    else:
        cart_min_range = cart_pixel_width / 2 * cart_resolution
    coords = np.linspace(
        -cart_min_range, cart_min_range, cart_pixel_width, dtype=np.float32
    )
    Y, X = np.meshgrid(coords, -1 * coords, indexing="xy")
    sample_range = np.sqrt(Y * Y + X * X)
    sample_angle = np.arctan2(Y, X)
    sample_angle = sample_angle + (sample_angle < 0) * 2.0 * np.pi
    return sample_range.astype(np.float32), sample_angle.astype(np.float32)


def form_cart_range_angle_grid(
    cart_resolution: float = CART_RESOLUTION,
    cart_pixel_width: int = CART_PIXEL_WIDTH,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel (range m, angle rad ∈ [0, 2π)) of a centred BEV image."""
    r, a = _cart_range_angle_grid_np(float(cart_resolution), int(cart_pixel_width))
    return (torch.tensor(r, dtype=dtype, device=device),
            torch.tensor(a, dtype=dtype, device=device))


def _wobble_sample_v(azimuths: torch.Tensor, sample_angle: torch.Tensor) -> torch.Tensor:
    """Fractional azimuth index of each pixel against the measured, non-uniform
    encoder azimuths. azimuths (B, A) sorted; sample_angle (B, H, W)."""
    B, A = azimuths.shape
    flat = sample_angle.reshape(B, -1).contiguous()
    c3 = torch.searchsorted(azimuths.contiguous(), flat, side="left")
    c3 = torch.where(c3 == A, A - 1, c3)
    c2 = c3 - 1
    c2 = torch.where(c2 < 0, c2 + 1, c2)
    a3 = torch.gather(azimuths, 1, c3)
    a2 = torch.gather(azimuths, 1, c2)
    diff = flat - a3
    delta = diff * (diff < 0) * (c3 > 0) / (a3 - a2 + 1e-14)
    return (c3.to(sample_angle.dtype) + delta).reshape(sample_angle.shape)


def radar_polar_to_cartesian(
    fft_data: torch.Tensor,
    azimuths: torch.Tensor,
    radar_resolution: float = POLAR_RESOLUTION,
    cart_resolution: float = CART_RESOLUTION,
    cart_pixel_width: int = CART_PIXEL_WIDTH,
    interpolate_crossover: bool = True,
    fix_wobble: bool = True,
) -> torch.Tensor:
    """fft_data (B, A, R), azimuths (B, A) → (B, W, W) BEV image."""
    B, A, R = fft_data.shape
    sample_range, sample_angle = form_cart_range_angle_grid(
        cart_resolution, cart_pixel_width, fft_data.dtype, fft_data.device
    )
    sample_range = sample_range.expand(B, -1, -1)
    sample_angle = sample_angle.expand(B, -1, -1)

    sample_u = (sample_range - radar_resolution / 2) / radar_resolution
    if fix_wobble:
        sample_v = _wobble_sample_v(azimuths, sample_angle)
    else:
        azimuth_step = (azimuths[:, -1] - azimuths[:, 0]) / (A - 1)
        sample_v = (sample_angle - azimuths[:, 0, None, None]) / azimuth_step[
            :, None, None
        ]
    sample_u = torch.clamp(sample_u, min=0.0)

    if interpolate_crossover:
        fft_data = torch.cat([fft_data[:, -1:], fft_data, fft_data[:, :1]], dim=1)
        sample_v = sample_v + 1
    A_pad = fft_data.shape[1]

    sample_u = sample_u / (R - 1) * 2 - 1
    sample_v = sample_v / (A_pad - 1) * 2 - 1
    warp = torch.stack([sample_u, sample_v], dim=-1)
    return grid_sample_2d(fft_data[:, None], warp, align_corners=True)[:, 0]


def point_to_cart_idx(
    pc: torch.Tensor,
    cart_resolution: float = CART_RESOLUTION,
    cart_pixel_width: int = CART_PIXEL_WIDTH,
    min_to_plus_1: bool = False,
) -> torch.Tensor:
    """Metric points (B, N, 2/3) → BEV pixel coordinates (B, N, 2): the
    (v, u)-ordered [-1, 1] grid with ``min_to_plus_1``, else top-left-origin
    pixel indices."""
    grid_pc_u = -pc[..., 0] / cart_resolution
    grid_pc_v = pc[..., 1] / cart_resolution
    if min_to_plus_1:
        return torch.stack([grid_pc_v, grid_pc_u], dim=-1) / (cart_pixel_width - 1) * 2
    return torch.stack([grid_pc_u, grid_pc_v], dim=-1) + cart_pixel_width / 2
