"""Navtech radar decode, pixel grids and the polar↔cartesian warps.

Counterpart of ``mm_masking_tpu.ops.radar`` (reference
``radar_utils.py:20-27,187-195,258-437``): the host-side scan decode
(:func:`load_radar`, numpy), and on tensors the half-bin range offset, the
searchsorted azimuth "wobble" fix, first/last-azimuth crossover padding and
bilinear, zero-padded, align-corners sampling; the inverse warp and the
polar range grid of the polar network I/O.

:func:`polar_mask_to_cartesian` is the polar→cartesian warp of a mask that
the train step differentiates: the same sampling, taken as a lookup of the
W² pixels' coordinates, whose mask gradient is the gather-form kernel of
``ops/kernels/resample.py`` (``bilinear_points_bwd``) on the card.
``F.grid_sample``'s own backward adds with float atomics there, and the
train step is bitwise repeatable. The coordinates depend on the azimuths
alone; no gradient flows to them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from mm_masking_tpu_torch.ops.grid_sample import grid_sample_2d, grid_sample_points

POLAR_RESOLUTION = 0.0596  # m / range bin
CART_RESOLUTION = 0.2384  # m / cartesian pixel
CART_PIXEL_WIDTH = 640
POLAR_SHAPE = (400, 3360)  # (azimuths, range bins)
ENCODER_TICKS = 5600


def load_radar(raw_data: np.ndarray, normalize: bool = True):
    """Decode a raw Navtech scan image (host-side, numpy).

    Row layout (reference ``radar_utils.py:20-27``): bytes 0-7 little-endian
    int64 timestamp (×1000 → ns), bytes 8-9 uint16 encoder tick (× 2π/5600 →
    rad), byte 10 validity flag (unused), columns 11+ FFT power / 255.

    Returns (fft_data (A, R) float32, azimuths (A,) float64, timestamps (A,)
    int64). With ``normalize=False`` the FFT plane stays the on-disk uint8:
    the data loader divides it by 255 on the device.
    """
    raw_data = np.asarray(raw_data)
    timestamps = np.frombuffer(raw_data[:, :8].tobytes(), dtype=np.int64) * 1000
    azimuths = (
        np.frombuffer(raw_data[:, 8:10].tobytes(), dtype=np.uint16)
        * (2 * np.pi / ENCODER_TICKS)
    )
    if normalize:
        fft_data = np.divide(raw_data[:, 11:], 255.0, dtype=np.float32)
    else:
        fft_data = np.ascontiguousarray(raw_data[:, 11:])
    return fft_data, azimuths, timestamps


def pol_2_cart(pointcloud: torch.Tensor) -> torch.Tensor:
    """(…, N, ≥2) polar points (rho, phi, …) → (…, N, 3) cartesian, z = 0."""
    rho, phi = pointcloud[..., 0], pointcloud[..., 1]
    return torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), torch.zeros_like(rho)], -1)


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


def form_polar_range_grid(
    polar_resolution: float = CART_RESOLUTION,
    polar_pixel_shape: tuple[int, int] = POLAR_SHAPE,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """(A, R) grid whose rows hold each range bin's range in m, bin 0 at 0 m.
    The default resolution is the cartesian one, as in the reference; callers
    pass the polar one."""
    polar_range = (polar_pixel_shape[1] - 1) * polar_resolution
    coords = torch.linspace(0.0, polar_range, polar_pixel_shape[1], dtype=dtype, device=device)
    return coords[None, :].expand(polar_pixel_shape)


@functools.lru_cache(maxsize=16)
def _cart_grid_on(cart_resolution: float, cart_pixel_width: int, dtype: torch.dtype,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`form_cart_range_angle_grid` kept on ``device``: a captured step
    that warps finds it there and copies nothing from the host."""
    with torch.inference_mode(False):
        return form_cart_range_angle_grid(cart_resolution, cart_pixel_width, dtype, device)


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
    data, warp = _polar_warp(fft_data, azimuths, radar_resolution, *form_cart_range_angle_grid(
        cart_resolution, cart_pixel_width, fft_data.dtype, fft_data.device),
        interpolate_crossover, fix_wobble)
    return grid_sample_2d(data[:, None], warp, align_corners=True)[:, 0]


def polar_mask_to_cartesian(
    mask: torch.Tensor,
    azimuths: torch.Tensor,
    radar_resolution: float = POLAR_RESOLUTION,
    cart_resolution: float = CART_RESOLUTION,
    cart_pixel_width: int = CART_PIXEL_WIDTH,
) -> torch.Tensor:
    """:func:`radar_polar_to_cartesian` of a differentiated polar mask (B, A,
    R) → (B, W, W): the W² pixels sampled as points, so that the mask's
    gradient is the gather-form lookup backward (the same bilinear,
    zero-padded, align-corners taps)."""
    data, warp = _polar_warp(mask, azimuths, radar_resolution, *_cart_grid_on(
        float(cart_resolution), int(cart_pixel_width), mask.dtype, mask.device), True, True)
    B = mask.shape[0]
    return grid_sample_points(data, warp.detach().reshape(B, -1, 2)).reshape(
        B, cart_pixel_width, cart_pixel_width)


def _polar_warp(fft_data, azimuths, radar_resolution, sample_range, sample_angle,
                interpolate_crossover, fix_wobble):
    """(the polar data with its crossover rows, the warp (B, W, W, 2) in
    grid_sample's [-1, 1] coordinates) of the polar→cartesian warp."""
    B, A, R = fft_data.shape
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
    return fft_data, torch.stack([sample_u, sample_v], dim=-1)


def radar_cartesian_to_polar(
    cart: torch.Tensor,
    azimuths: torch.Tensor,
    radar_resolution: float = POLAR_RESOLUTION,
    cart_resolution: float = CART_RESOLUTION,
    polar_pixel_shape: tuple[int, int] = POLAR_SHAPE,
) -> torch.Tensor:
    """Inverse warp (reference ``radar_utils.py:338-372``): (B, W, W) BEV →
    (B, A, R) polar, each range bin projected along its measured azimuth to
    the centred pixel grid and sampled bilinearly."""
    B, H, W = cart.shape
    range_coords = form_polar_range_grid(radar_resolution, polar_pixel_shape, cart.dtype,
                                         cart.device)[0]
    sample_u = torch.sin(azimuths)[..., None] * range_coords / cart_resolution
    sample_v = -(torch.cos(azimuths)[..., None] * range_coords) / cart_resolution
    warp = torch.stack([sample_u / (W - 1) * 2, sample_v / (H - 1) * 2], dim=-1)
    return grid_sample_2d(cart[:, None], warp, align_corners=True)[:, 0]


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
