"""Synthetic Boreas-like scan/map batches (counterpart of
``mm_masking_tpu.data.synthetic``).

The scene is drawn with numpy in the same ``default_rng(seed)`` call order
as the JAX package, so a seed gives the same scene in both; the CFAR mask,
the polar→cartesian warp and the initial transforms are computed with the
port's own ops on the requested device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mm_masking_tpu_torch.dicp import TARGET_PAD_VAL
from mm_masking_tpu_torch.geom import se3_exp
from mm_masking_tpu_torch.ops import cfar_mask, radar_polar_to_cartesian


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    n_scan: int = 768  # scan cloud pad size
    n_map: int = 2048  # map cloud pad size
    polar_shape: tuple[int, int] = (400, 3360)
    cart_pixel_width: int = 640
    res: float = 0.0596
    cart_resolution: float = 0.2384
    min_range: float = 4.0
    max_range: float = 70.0
    pos_std: float = 2.0
    rot_std: float = 0.6
    noise: float = 0.02
    network_input_type: str = "cartesian"
    # Fraction of scan returns that are clutter: present in the scan (and
    # bright in the FFT image) but absent from the map — the structured noise
    # the learned mask exists to suppress.
    clutter_frac: float = 0.0
    # Scene geometry: "scatter" (uniform random scatterers, round-1 behavior)
    # or "walls" (line-segment structures + multipath ghost clutter, the
    # learning-demo regime — see `_walls_scene`).
    scene: str = "scatter"


def _scatter_scene(rng, batch, spec):
    """Round-1 scene: uniform random scatterers + uniform random clutter."""
    n_real_scan = int(spec.n_scan * 0.9)
    n_real_map = int(spec.n_map * 0.9)

    ranges = rng.uniform(spec.min_range, spec.max_range, (batch, n_real_map))
    angles = rng.uniform(0, 2 * np.pi, (batch, n_real_map))
    map_xy = np.stack(
        [ranges * np.cos(angles), ranges * np.sin(angles)], axis=-1
    ).astype(np.float32)

    map_pts = np.full((batch, spec.n_map, 3), TARGET_PAD_VAL, np.float32)
    map_pts[:, :n_real_map, :2] = map_xy
    map_pts[:, :n_real_map, 2] = 0.0
    # Planar normals (unit, mostly horizontal) — required for pt2pl.
    nrm = rng.normal(size=(batch, spec.n_map, 3)).astype(np.float32)
    nrm[..., 2] *= 0.05
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[:, n_real_map:] = TARGET_PAD_VAL

    # Scan: subsample of map scatterers + noise; gt_eye convention (map already
    # aligned into the scan frame, T_gt = identity).
    sel = rng.permutation(n_real_map)[:n_real_scan]
    scan = np.zeros((batch, spec.n_scan, 3), np.float32)
    scan[:, :n_real_scan] = map_pts[:, sel] + rng.normal(
        0, spec.noise, (batch, n_real_scan, 3)
    ).astype(np.float32)
    scan[:, :n_real_scan, 2] = 0.0
    # Replace a fraction of returns with clutter (random positions with no map
    # counterpart) — what the learned weight mask should suppress.
    n_clutter = int(spec.clutter_frac * n_real_scan)
    if n_clutter:
        cr = rng.uniform(spec.min_range, spec.max_range, (batch, n_clutter))
        ca = rng.uniform(0, 2 * np.pi, (batch, n_clutter))
        scan[:, :n_clutter, 0] = (cr * np.cos(ca)).astype(np.float32)
        scan[:, :n_clutter, 1] = (cr * np.sin(ca)).astype(np.float32)
        scan[:, :n_clutter, 2] = 0.0
    clutter = np.zeros((batch, spec.n_scan), bool)
    clutter[:, :n_clutter] = True
    clutter[:, n_real_scan:] = False
    return map_pts, nrm, n_real_map, scan, n_real_scan, clutter


def _walls_scene(rng, batch, spec):
    """Learning-demo scene: line-segment walls + multipath ghost clutter.

    Why this regime makes the learned mask *matter* (unlike random scatter):

    * Walls give point-to-plane ICP a well-conditioned, convex-ish basin —
      with clean weights the solver recovers the pose to ~noise level, so
      the pose loss actually carries gradient signal.
    * Ghosts are radially displaced copies of real returns concentrated in
      one angular sector — the radar multipath signature. Unlike uniform
      clutter (which averages out), the coherent sector pulls the unweighted
      solution in one direction: a systematic bias Cauchy alone cannot
      remove (ghost residuals ~2-3.5 m sit inside trim_dist=5 where the
      robust weight is still ~0.1-0.3).
    * Ghosts render dim in the FFT image (0.15-0.35 vs 0.6-1.0) — the
      appearance cue the UNet can key on, as real saturated/multipath
      returns are distinguishable on Navtech scans.
    """
    n_real_scan = int(spec.n_scan * 0.9)
    n_real_map = int(spec.n_map * 0.9)
    n_clutter = int(spec.clutter_frac * n_real_scan)
    n_true = n_real_scan - n_clutter

    map_pts = np.full((batch, spec.n_map, 3), TARGET_PAD_VAL, np.float32)
    nrm = np.full((batch, spec.n_map, 3), TARGET_PAD_VAL, np.float32)
    scan = np.zeros((batch, spec.n_scan, 3), np.float32)
    clutter = np.zeros((batch, spec.n_scan), bool)
    clutter[:, :n_clutter] = True

    for b in range(batch):
        n_walls = rng.integers(8, 15)
        # Wall anchor points ring the sensor; orientations are uniform so the
        # normal directions jointly constrain x, y, and yaw.
        anchor_r = rng.uniform(spec.min_range + 6.0, spec.max_range - 8.0, n_walls)
        anchor_a = rng.uniform(0, 2 * np.pi, n_walls)
        anchors = np.stack(
            [anchor_r * np.cos(anchor_a), anchor_r * np.sin(anchor_a)], axis=-1
        )
        theta = rng.uniform(0, np.pi, n_walls)
        tangents = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
        normals2d = np.stack([-np.sin(theta), np.cos(theta)], axis=-1)
        lengths = rng.uniform(10.0, 35.0, n_walls)

        def sample_on_walls(n):
            w = rng.integers(0, n_walls, n)
            t = rng.uniform(-0.5, 0.5, n)
            pts = anchors[w] + tangents[w] * (t * lengths[w])[:, None]
            return pts.astype(np.float32), normals2d[w].astype(np.float32)

        mp, mn = sample_on_walls(n_real_map)
        map_pts[b, :n_real_map, :2] = mp
        map_pts[b, :n_real_map, 2] = 0.0
        nrm[b, :n_real_map, :2] = mn
        nrm[b, :n_real_map, 2] = 0.0

        sp, _ = sample_on_walls(n_true)
        sp = sp + rng.normal(0, spec.noise, sp.shape).astype(np.float32)
        scan[b, n_clutter:n_real_scan, :2] = sp

        if n_clutter:
            # Ghosts: real wall returns inside a ~120° sector, pushed
            # radially outward by 1.5-3.5 m (inside trim_dist, outside the
            # Cauchy core) — a coherent pull on the unweighted solution.
            sector = rng.uniform(0, 2 * np.pi)
            src, _ = sample_on_walls(4 * n_clutter)
            ang = np.arctan2(src[:, 1], src[:, 0])
            d_ang = np.abs((ang - sector + np.pi) % (2 * np.pi) - np.pi)
            order = np.argsort(d_ang)
            src = src[order[:n_clutter]]
            r = np.linalg.norm(src, axis=-1, keepdims=True)
            delta = rng.uniform(1.5, 3.5, (n_clutter, 1)).astype(np.float32)
            ghost = src * (1.0 + delta / np.maximum(r, 1e-3))
            scan[b, :n_clutter, :2] = ghost

    return map_pts, nrm, n_real_map, scan, n_real_scan, clutter


def synthetic_batch(
    seed: int,
    batch: int,
    spec: SyntheticSpec = SyntheticSpec(),
    with_oracle: bool = False,
    device: torch.device | str = "cpu",
) -> dict:
    """A batch dict mirroring the dataset item structure (T_gt = I), with
    torch tensors on ``device``. ``with_oracle`` adds ``oracle_weights``
    (1 for real returns, 0 for clutter and pads)."""
    rng = np.random.default_rng(seed)
    A, R = spec.polar_shape

    if spec.scene == "walls":
        map_pts, nrm, n_real_map, scan, n_real_scan, clutter = _walls_scene(
            rng, batch, spec
        )
    else:
        map_pts, nrm, n_real_map, scan, n_real_scan, clutter = _scatter_scene(
            rng, batch, spec
        )
    map_pc = np.concatenate([map_pts, nrm], axis=-1)

    # Polar FFT image: splat scan returns into (azimuth, range) bins.
    fft = (0.05 * rng.random((batch, A, R)) ** 2).astype(np.float32)
    az_grid = np.linspace(0, 2 * np.pi * (A - 1) / A, A).astype(np.float32)
    scan_r = np.linalg.norm(scan[:, :n_real_scan, :2], axis=-1)
    scan_a = np.mod(
        np.arctan2(scan[:, :n_real_scan, 1], scan[:, :n_real_scan, 0]), 2 * np.pi
    )
    a_idx = np.clip((scan_a / (2 * np.pi / A)).astype(int), 0, A - 1)
    r_idx = np.clip((scan_r / spec.res).astype(int), 0, R - 2)
    b_idx = np.broadcast_to(np.arange(batch)[:, None], a_idx.shape)
    intensity = rng.uniform(0.6, 1.0, size=a_idx.shape).astype(np.float32)
    n_clutter = int(spec.clutter_frac * n_real_scan)
    if n_clutter:
        intensity[:, :n_clutter] = rng.uniform(
            0.2, 0.4, size=(batch, n_clutter)
        ).astype(np.float32)
    for dr in (0, 1):
        fft[b_idx, a_idx, r_idx + dr] = intensity

    azimuths = np.broadcast_to(az_grid[None], (batch, A)).copy()
    az_times = np.broadcast_to(np.linspace(0, 0.25, A, dtype=np.float32)[None],
                               (batch, A)).copy()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    fft_t = dev(fft)
    az_t = dev(azimuths)
    cfar = cfar_mask(fft_t, spec.res, diff=False)
    if spec.network_input_type == "cartesian":
        fft_img = radar_polar_to_cartesian(
            fft_t, az_t, spec.res, spec.cart_resolution, spec.cart_pixel_width)
        cfar_img = radar_polar_to_cartesian(
            cfar, az_t, spec.res, spec.cart_resolution, spec.cart_pixel_width)
    else:
        fft_img, cfar_img = fft_t, cfar

    # Perturbed initial guess (reference train-style uniform sampling).
    xi = np.zeros((batch, 6), np.float32)
    u = 2 * rng.random((batch, 6)) - 1
    xi[:, 0:2] = (spec.pos_std * u[:, 0:2]).astype(np.float32)
    xi[:, 5] = (spec.rot_std * u[:, 5]).astype(np.float32)

    batch_dict = {
        "loc_data": {
            "raw_pc": dev(scan),
            "filtered_pc": dev(scan),
            "fft_data": fft_img,
            "fft_cfar": cfar_img,
            "azimuths": az_t,
            "az_times": dev(az_times),
        },
        "map_data": {"pc": dev(map_pc)},
        "transforms": {
            "T_ml_init": se3_exp(dev(xi)),
            "T_ml_gt": torch.eye(4, device=device).expand(batch, 4, 4).clone(),
        },
    }
    if with_oracle:
        real = np.zeros((batch, spec.n_scan), np.float32)
        real[:, :n_real_scan] = 1.0
        real[clutter] = 0.0
        batch_dict["loc_data"]["oracle_weights"] = dev(real)
    return batch_dict
