"""Inputs of a cell, made from its seed: the traffic pool and the weights.

The scene is the ``walls`` scene of the repository's synthetic data (line
segment walls with their normals, for point-to-plane ICP, and multipath
ghost clutter in one angular sector, rendered dim in the FFT image),
copied here so that a change to the program cannot move the traffic. Each
item has the dataset's structure: the scan's points (``raw_pc`` and
``filtered_pc``), the network's input image ``fft_data`` (the polar FFT
plane, or its warp to the cartesian grid), the azimuths, the map's points
with normals and the initial and ground-truth transforms. The configurations
read no CFAR channel, so the pool has none.

Each batch is drawn on the device, from a ``torch.Generator`` seeded from
the run's seed and the batch's place in the pool, in a few large calls:
the walls, the returns on them and the ghosts, the FFT plane's background
and the splat of the returns, the warp, the initial errors. The same seed
gives the same pool.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

TARGET_PAD_VAL = 1000.0  # map pad rows: beyond any real range, trimmed out
_MAX_WALLS = 14


def derive_seed(seed: int, *purpose: int) -> int:
    """A 63-bit seed for one purpose (numbers) of a run's ``seed``."""
    ss = np.random.SeedSequence([seed % 2**64, *purpose])
    return int(ss.generate_state(1, np.uint64)[0]) & (2**63 - 1)


def _walls(gen: torch.Generator, batch: int, n_scan: int, n_map: int, clutter_frac: float,
           noise: float, min_range: float, max_range: float, device):
    """A batch's (map points (B, n_map, 3), normals (B, n_map, 3), scan (B,
    n_scan, 3)), the map padded with TARGET_PAD_VAL rows and the scan with
    zero rows, its first ``n_clutter`` returns the ghosts; drawn in float64
    on the device, returned in float32."""
    n_real_scan, n_real_map = int(n_scan * 0.9), int(n_map * 0.9)
    n_clutter = int(clutter_frac * n_real_scan)
    n_true = n_real_scan - n_clutter
    f64 = dict(generator=gen, device=device, dtype=torch.float64)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, **f64)

    # 8 to 14 walls an item; anchors ring the sensor, orientations uniform so
    # that the normals jointly constrain x, y and yaw.
    n_walls = torch.floor(uniform(8.0, 15.0, batch, 1))
    anchor_r = uniform(min_range + 6.0, max_range - 8.0, batch, _MAX_WALLS)
    anchor_a = uniform(0.0, 2 * math.pi, batch, _MAX_WALLS)
    anchors = torch.stack([anchor_r * torch.cos(anchor_a), anchor_r * torch.sin(anchor_a)], -1)
    theta = uniform(0.0, math.pi, batch, _MAX_WALLS)
    tangents = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    normals = torch.stack([-torch.sin(theta), torch.cos(theta)], -1)
    lengths = uniform(10.0, 35.0, batch, _MAX_WALLS)

    def on_walls(n):
        w = torch.floor(uniform(0.0, 1.0, batch, n) * n_walls).long()
        t = uniform(-0.5, 0.5, batch, n)
        pick = w[..., None].expand(-1, -1, 2)
        pts = (torch.gather(anchors, 1, pick)
               + torch.gather(tangents, 1, pick) * (t * torch.gather(lengths, 1, w))[..., None])
        return pts, torch.gather(normals, 1, pick)

    map_pts = torch.full((batch, n_map, 3), TARGET_PAD_VAL, device=device)
    nrm = torch.full((batch, n_map, 3), TARGET_PAD_VAL, device=device)
    scan = torch.zeros((batch, n_scan, 3), device=device)
    mp, mn = on_walls(n_real_map)
    map_pts[:, :n_real_map, :2], map_pts[:, :n_real_map, 2] = mp.float(), 0.0
    nrm[:, :n_real_map, :2], nrm[:, :n_real_map, 2] = mn.float(), 0.0
    sp, _ = on_walls(n_true)
    sp = sp + noise * torch.randn(sp.shape, **f64)
    scan[:, n_clutter:n_real_scan, :2] = sp.float()
    if n_clutter:
        # Ghosts: real wall returns inside one sector, pushed radially
        # outward by 1.5-3.5 m (inside the ICP's trim, outside Cauchy's core).
        sector = uniform(0.0, 2 * math.pi, batch, 1)
        src, _ = on_walls(4 * n_clutter)
        ang = torch.atan2(src[..., 1], src[..., 0])
        d_ang = torch.abs(torch.remainder(ang - sector + math.pi, 2 * math.pi) - math.pi)
        order = torch.argsort(d_ang, dim=1, stable=True)[:, :n_clutter]
        src = torch.gather(src, 1, order[..., None].expand(-1, -1, 2))
        r = torch.linalg.vector_norm(src, dim=-1, keepdim=True)
        delta = uniform(1.5, 3.5, batch, n_clutter, 1)
        scan[:, :n_clutter, :2] = (src * (1.0 + delta / torch.clamp(r, min=1e-3))).float()
    return map_pts, nrm, scan, n_real_scan, n_clutter


def planar_transforms(xi: torch.Tensor) -> torch.Tensor:
    """(B, 3) float64 planar twists (x, y, yaw) → (B, 4, 4) float32 exp(ξ^)."""
    x, y, th = xi.unbind(-1)
    small = th.abs() < 1e-8
    ts = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th**2 / 6.0, torch.sin(ts) / ts)  # sin θ / θ
    b = torch.where(small, th / 2.0, (1.0 - torch.cos(ts)) / ts)  # (1 − cos θ) / θ
    T = torch.zeros((xi.shape[0], 4, 4), dtype=xi.dtype, device=xi.device)
    T[:, 0, 0], T[:, 0, 1] = torch.cos(th), -torch.sin(th)
    T[:, 1, 0], T[:, 1, 1] = torch.sin(th), torch.cos(th)
    T[:, 2, 2] = T[:, 3, 3] = 1.0
    T[:, 0, 3] = a * x - b * y
    T[:, 1, 3] = b * x + a * y
    return T.float()


def cart_range_angle_grid(cart_resolution: float, cart_pixel_width: int, device):
    """Per-pixel (range m, angle rad in [0, 2π)) of the centred cartesian grid."""
    if cart_pixel_width % 2 == 0:
        cart_min_range = (cart_pixel_width / 2 - 0.5) * cart_resolution
    else:
        cart_min_range = cart_pixel_width / 2 * cart_resolution
    coords = np.linspace(-cart_min_range, cart_min_range, cart_pixel_width, dtype=np.float32)
    Y, X = np.meshgrid(coords, -1 * coords, indexing="xy")
    sample_range = np.sqrt(Y * Y + X * X)
    sample_angle = np.arctan2(Y, X)
    sample_angle = sample_angle + (sample_angle < 0) * 2.0 * np.pi
    return (torch.tensor(sample_range.astype(np.float32), device=device),
            torch.tensor(sample_angle.astype(np.float32), device=device))


def polar_warp_grid(azimuths: torch.Tensor, n_range: int, radar_resolution: float,
                    cart_resolution: float, cart_pixel_width: int) -> torch.Tensor:
    """grid_sample's [-1, 1] coordinates (B, W, W, 2) of each cartesian pixel
    in a polar plane (B, A + 2, R) padded with its last and first azimuth
    rows (the crossover), the azimuth found against the measured azimuths
    (the wobble fix), align-corners convention."""
    sample_range, sample_angle = cart_range_angle_grid(cart_resolution, cart_pixel_width,
                                                       azimuths.device)
    B, A = azimuths.shape
    sample_range = sample_range.expand(B, -1, -1)
    sample_angle = sample_angle.expand(B, -1, -1)
    sample_u = torch.clamp((sample_range - radar_resolution / 2) / radar_resolution, min=0.0)
    flat = sample_angle.reshape(B, -1).contiguous()
    c3 = torch.searchsorted(azimuths.contiguous(), flat, side="left")
    c3 = torch.where(c3 == A, A - 1, c3)
    c2 = torch.where(c3 - 1 < 0, c3, c3 - 1)
    a3, a2 = torch.gather(azimuths, 1, c3), torch.gather(azimuths, 1, c2)
    diff = flat - a3
    delta = diff * (diff < 0) * (c3 > 0) / (a3 - a2 + 1e-14)
    sample_v = (c3.to(sample_angle.dtype) + delta).reshape(sample_angle.shape) + 1
    sample_u = sample_u / (n_range - 1) * 2 - 1
    sample_v = sample_v / (A + 2 - 1) * 2 - 1
    return torch.stack([sample_u, sample_v], dim=-1)


def pad_crossover(polar: torch.Tensor) -> torch.Tensor:
    """(B, A, R) → (B, A + 2, R): the last azimuth row before, the first after."""
    return torch.cat([polar[:, -1:], polar, polar[:, :1]], dim=1)


def polar_to_cartesian(polar: torch.Tensor, azimuths: torch.Tensor, radar_resolution: float,
                       cart_resolution: float, cart_pixel_width: int) -> torch.Tensor:
    """(B, A, R) polar plane → (B, W, W) cartesian image: bilinear,
    zero-padded, align-corners sampling."""
    grid = polar_warp_grid(azimuths, polar.shape[2], radar_resolution, cart_resolution,
                           cart_pixel_width)
    return F.grid_sample(pad_crossover(polar)[:, None], grid.to(polar.dtype), mode="bilinear",
                         padding_mode="zeros", align_corners=True)[:, 0]


def make_batch(seed: int, index: int, batch: int, model: dict, n_scan: int, n_map: int,
               traffic: dict, device) -> dict:
    """Batch ``index`` of the pool of ``seed``: ``batch`` items of the
    traffic's scene, at the configuration's input shapes."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 1, index))
    A, R = model["polar_shape"]
    res = model["res"]
    map_pts, nrm, scan, n_real_scan, n_clutter = _walls(
        gen, batch, n_scan, n_map, traffic["clutter_frac"], traffic["noise"],
        traffic["min_range"], traffic["max_range"], device)

    # The FFT plane: a dim background, each return splatted into two range
    # bins at its intensity (ghosts dimmer); where two returns share a bin,
    # the brighter one.
    real = scan[:, :n_real_scan, :2]
    a_idx = torch.clamp((torch.remainder(torch.atan2(real[..., 1], real[..., 0]), 2 * math.pi)
                         / (2 * math.pi / A)).long(), 0, A - 1)
    r_idx = torch.clamp((torch.linalg.vector_norm(real, dim=-1) / res).long(), 0, R - 2)
    intensity = 0.6 + 0.4 * torch.rand(a_idx.shape, generator=gen, device=device)
    if n_clutter:
        intensity[:, :n_clutter] = 0.2 + 0.2 * torch.rand((batch, n_clutter), generator=gen,
                                                          device=device)
    fft = 0.05 * torch.rand((batch, A, R), generator=gen, device=device) ** 2
    flat = (torch.arange(batch, device=device)[:, None] * A + a_idx) * R + r_idx
    fft = fft.reshape(-1).scatter_reduce(
        0, torch.cat([flat, flat + 1], 1).reshape(-1),
        torch.cat([intensity, intensity], 1).reshape(-1), "amax").reshape(batch, A, R)

    az = torch.linspace(0, 2 * math.pi * (A - 1) / A, A, dtype=torch.float32, device=device)
    azimuths = az[None].expand(batch, A).contiguous()
    if model["network_input_type"] == "cartesian":
        fft = polar_to_cartesian(fft, azimuths, res, model["cart_resolution"],
                                 model["cart_pixel_width"])

    u = (2 * torch.rand((batch, 3), generator=gen, device=device, dtype=torch.float64) - 1)
    xi = torch.stack([traffic["pos_std"] * u[:, 0], traffic["pos_std"] * u[:, 1],
                      traffic["rot_std"] * u[:, 2]], dim=-1)
    return {
        "loc_data": {"raw_pc": scan, "filtered_pc": scan.clone(), "fft_data": fft,
                     "azimuths": azimuths},
        "map_data": {"pc": torch.cat([map_pts, nrm], -1)},
        "transforms": {
            "T_ml_init": planar_transforms(xi),
            "T_ml_gt": torch.eye(4, device=device).expand(batch, 4, 4).clone(),
        },
    }


def make_pool(seed: int, model: dict, data: dict, batch: int, traffic: dict, device
              ) -> list[dict]:
    """The traffic's pool: ``traffic["batches"]`` batches of ``batch`` items."""
    return [make_batch(seed, i, batch, model, data["max_loc_pts"], data["max_map_pts"],
                       traffic, device) for i in range(traffic["batches"])]


def xavier_params(shapes: dict[str, Sequence[int]], seed: int, device) -> dict:
    """Xavier-uniform conv kernels (OIHW: fans ``ci·kh·kw`` and ``co·kh·kw``)
    and zero biases, drawn on ``device`` in one call from the seed."""
    kernels = {k: tuple(s) for k, s in shapes.items() if len(s) == 4}
    total = sum(math.prod(s) for s in kernels.values())
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 3))
    u = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, at = {}, 0
    for k, s in shapes.items():
        s = tuple(s)
        if k not in kernels:
            out[k] = torch.zeros(s, device=device)
            continue
        co, ci, kh, kw = s
        bound = math.sqrt(6.0 / (ci * kh * kw + co * kh * kw))
        n = math.prod(s)
        out[k] = (u[at:at + n] * bound).reshape(s)
        at += n
    return out
