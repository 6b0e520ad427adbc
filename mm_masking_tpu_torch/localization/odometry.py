"""Frame-to-map ICP odometry and teach-pass map building.

Counterpart of ``mm_masking_tpu.localization.odometry``: drive a sequence
of scans through frame-to-local-map ICP, keyframe on motion thresholds, and
keep a voxelised local map in a fixed-size buffer (pad rows at the far
sentinel), enough to build the maps the localization pipeline consumes.

The state lives on the device of the scans. A frame reads one number pair
from the device, the keyframe test's; the trajectory stays on the device
until :attr:`TeachPass.trajectory` is read. The map merge sums each voxel's
points in a fixed order (:func:`~mm_masking_tpu_torch.ops.preprocessing.voxel_downsample`),
so two passes over the same scans on one card give the same bits.

With ``continuous_time`` a frame given per-point times is registered by
the joint (pose, within-scan twist) solve of :mod:`~mm_masking_tpu_torch.dicp.ct_icp`
and merged from its twist-undistorted points; :meth:`TeachPass.pose_at`
queries the trajectory between frames (:mod:`~mm_masking_tpu_torch.geom.gp_interp`).
With ``use_mcransac`` a RANSAC consensus over nearest-neighbour pairs
filters the scan before ICP (:mod:`~mm_masking_tpu_torch.ops.mcransac`);
:func:`descriptor_bootstrap` is its appearance-based flavour.

Stamps are referenced to the sequence's first stamp in int64 before they
become float32 seconds (:func:`seconds_since`): at epoch microseconds
(~1.6e15) float32 seconds have a 128 s ulp, and the JAX package's cast of the
absolute stamps puts every knot of a sequence on one time.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mm_masking_tpu_torch.dicp import TARGET_PAD_VAL, CTICPConfig, ICPConfig, ct_icp, icp
from mm_masking_tpu_torch.dicp.ct_icp import _planar_se3, planar_log, undistort_with_twist
from mm_masking_tpu_torch.dicp.icp import _gather_rows
from mm_masking_tpu_torch.geom import (
    interpolate_trajectory,
    planar_xi_first_order,
    se3_exp,
    se3_inv,
    transform_points,
)
from mm_masking_tpu_torch.ops.descriptors import (
    basd_descriptors,
    match_descriptors,
    orb_descriptors,
)
from mm_masking_tpu_torch.ops.kernels.nn_assoc import nn_argmin
from mm_masking_tpu_torch.ops.mcransac import RansacConfig, mcransac, ransac_filter_pc
from mm_masking_tpu_torch.ops.preprocessing import estimate_normals, voxel_downsample


def seconds_since(stamps_us, ref_us: int) -> torch.Tensor:
    """float32 seconds of integer microsecond stamps after ``ref_us``, the
    difference taken in int64 before the cast."""
    return torch.as_tensor(np.asarray(stamps_us, np.int64) - np.int64(ref_us)).to(
        torch.float32) * 1e-6


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """The odometry settings; fields and defaults as in the JAX package."""

    icp_type: str = "pt2pt"
    max_iterations: int = 30
    trim_dist: float = 5.0
    cauchy_k: float = 1.0
    max_step_m: float = 2.0  # GN trust region; 0 disables
    # vertex-test thresholds; 0 → every frame is a keyframe
    max_translation: float = 0.0
    max_rotation_deg: float = 0.0
    voxel_size: float = 0.5
    max_map_pts: int = 8192
    normals_k: int = 8
    motion_prior: str = "constant_velocity"  # | "constant_position"
    prior_weight: float = 0.0
    use_mcransac: bool = False
    mcransac_init_icp: bool = False
    mcransac_filter_pc: bool = True
    mcransac_tolerance: float = 0.1225
    mcransac_iterations: int = 100
    continuous_time: bool = False
    ct_twist_prior_weight: float = 1.0


def _icp_cfg(cfg: OdometryConfig) -> ICPConfig:
    return ICPConfig(icp_type=cfg.icp_type, max_iterations=cfg.max_iterations,
                     differentiable=False, trim_dist=cfg.trim_dist, loss_name="cauchy",
                     loss_metric=cfg.cauchy_k, dim=2, prior_weight=cfg.prior_weight,
                     max_step_m=cfg.max_step_m)


def register_frame(scan: torch.Tensor, map_pc: torch.Tensor, T_init: torch.Tensor,
                   cfg: OdometryConfig) -> torch.Tensor:
    """Align one scan (1, N, 3) against the local map (1, M, 3|6). With
    ``use_mcransac``, a RANSAC consensus over the warm start's dense
    nearest-neighbour pairs (K1 on the card) first drops the scan's
    outliers (``mcransac_filter_pc``) and may warm-start the ICP
    (``mcransac_init_icp``)."""
    valid = ~((scan[..., 0] == 0.0) & (scan[..., 1] == 0.0))
    if cfg.use_mcransac:
        p = transform_points(T_init, scan)
        idx, d2 = nn_argmin(p, map_pc[..., :3])
        tgt = _gather_rows(map_pc[..., :3], idx)
        res = mcransac(p, tgt, valid & (d2 < cfg.trim_dist ** 2),
                       RansacConfig(tolerance=cfg.mcransac_tolerance,
                                    iterations=cfg.mcransac_iterations))
        if cfg.mcransac_init_icp:
            T_init = res["T"].to(T_init.dtype) @ T_init
        if cfg.mcransac_filter_pc:
            scan = ransac_filter_pc(scan, res["inliers"])
            valid = valid & res["inliers"]
    out = icp(scan, map_pc, T_init, weight=valid.to(scan.dtype), cfg=_icp_cfg(cfg),
              T_prior=T_init if cfg.prior_weight > 0.0 else None)
    return out["T"]


def register_frame_ct(scan: torch.Tensor, times: torch.Tensor, map_pc: torch.Tensor,
                      T_init: torch.Tensor, xi_prior: torch.Tensor, cfg: OdometryConfig):
    """Continuous-time registration of one scan (1, N, 3) with per-point
    times (1, N) against the local map: the joint (pose, within-scan twist)
    solve. Returns (T_end (1, 4, 4), xi (1, 3))."""
    valid = ~((scan[..., 0] == 0.0) & (scan[..., 1] == 0.0))
    out = ct_icp(scan, times, map_pc, T_init, weight=valid.to(scan.dtype),
                 cfg=CTICPConfig(icp_type=cfg.icp_type, max_iterations=cfg.max_iterations,
                                 trim_dist=cfg.trim_dist, loss_name="cauchy",
                                 loss_metric=cfg.cauchy_k,
                                 twist_prior_weight=cfg.ct_twist_prior_weight,
                                 pose_prior_weight=cfg.prior_weight),
                 xi_prior=xi_prior, T_prior=T_init if cfg.prior_weight > 0.0 else None)
    return out["T_end"], out["xi"]


def orthonormalize_planar(T: torch.Tensor) -> torch.Tensor:
    """Project the planar rotation block of (…, 4, 4) poses back onto SO(2):
    the constant-velocity warm start ``T·(T_prev⁻¹·T)`` squares the float32
    drift of the determinant every frame; atan2 cancels any isotropic scale
    and recovers the angle."""
    th = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    c, s = torch.cos(th), torch.sin(th)
    T = T.clone()
    T[..., 0, 0], T[..., 0, 1] = c, -s
    T[..., 1, 0], T[..., 1, 1] = s, c
    return T


def is_keyframe(T_delta: torch.Tensor, cfg: OdometryConfig) -> bool:
    """Motion since the last keyframe reaches the vertex-test thresholds. One
    read from the device: the translation and the largest rotation."""
    th, r = planar_xi_first_order(T_delta)
    trans, rot = torch.stack([torch.linalg.vector_norm(r),
                              torch.arcsin(th.clamp(-1, 1)).abs().amax()]).tolist()
    return trans >= cfg.max_translation or rot * 180.0 / np.pi >= cfg.max_rotation_deg


def merge_into_map(map_pts: torch.Tensor, scan_world: torch.Tensor, cfg: OdometryConfig,
                   center: torch.Tensor | None = None, map_w: torch.Tensor | None = None):
    """Voxel-merge world-frame scan points into the fixed-size map buffer.

    map_pts (M, 3) with far-sentinel pads; scan_world (N, 3) with (0, 0, 0)
    pads (moved to the sentinel, so they stay out of cell (0, 0, 0)).
    ``center``: the robot's position; on overflow the cells nearest to it
    survive. ``map_w`` (M,): per-row observation weights, which makes the
    merge a persistent weighted mean (a new point weighs 1) and the result a
    (means, weights) pair.
    """
    pad = (scan_world[:, 0] == 0.0) & (scan_world[:, 1] == 0.0)
    scan_world = torch.where(pad[:, None], TARGET_PAD_VAL, scan_world)
    merged = torch.cat([map_pts, scan_world], dim=0)
    keep = merged[:, 0].abs() < TARGET_PAD_VAL / 2
    merged = torch.where(keep[:, None], merged, TARGET_PAD_VAL)
    weights = None
    if map_w is not None:
        scan_w = torch.where(pad, 0.0, 1.0).to(merged.dtype)
        weights = torch.cat([torch.where(keep[: map_pts.shape[0]], map_w, 0.0), scan_w])
    return voxel_downsample(merged, voxel=cfg.voxel_size, max_out=cfg.max_map_pts,
                            pad_val=TARGET_PAD_VAL, center=center, weights=weights)


class TeachPass:
    """Sequential odometry and map building over a stream of scans."""

    def __init__(self, cfg: OdometryConfig = OdometryConfig()):
        self.cfg = cfg
        self.map_pts: torch.Tensor | None = None  # (M, 3) world frame
        self.map_w: torch.Tensor | None = None  # (M,) per-cell observation mass
        self.T_world_robot = torch.eye(4)[None]  # (1, 4, 4), on the scans' device once fed
        self.T_prev: torch.Tensor | None = None
        self.T_last_key = torch.eye(4)[None]
        self._poses: list[torch.Tensor] = []
        self.stamps: list[int] = []
        self.n_keyframes = 0

    @property
    def trajectory(self) -> list[np.ndarray]:
        """The world pose (4, 4) of every processed frame, on the host."""
        if not self._poses:
            return []
        return list(torch.stack(self._poses).cpu().numpy())

    def _warm_start(self) -> torch.Tensor:
        """ICP initial guess from the motion prior."""
        if self.cfg.motion_prior != "constant_velocity" or self.T_prev is None:
            return self.T_world_robot
        # T_init = T_k · (T_{k-1}⁻¹ · T_k): replay the last inter-frame motion.
        return self.T_world_robot @ (se3_inv(self.T_prev) @ self.T_world_robot)

    def velocity_estimate(self, dt: float = 0.25) -> torch.Tensor:
        """Planar body-frame velocity (vx, vy) from the last inter-frame
        motion (for ``doppler_shift``)."""
        if self.T_prev is None:
            return torch.zeros(2, device=self.T_world_robot.device)
        return (se3_inv(self.T_prev) @ self.T_world_robot)[0, :2, 3] / dt

    def map_with_normals(self) -> torch.Tensor:
        """(1, M, 6) current map with estimated normals (for pt2pl)."""
        nrm, _ = estimate_normals(self.map_pts[None], k=self.cfg.normals_k)
        pad = self.map_pts[:, 0].abs() >= TARGET_PAD_VAL / 2
        nrm = torch.where(pad[None, :, None], TARGET_PAD_VAL, nrm)
        return torch.cat([self.map_pts[None], nrm], dim=-1)

    def _xi_prior(self) -> torch.Tensor:
        """The WNOA twist prior's mean: the planar log of the last
        inter-frame motion (1, 3)."""
        if self.T_prev is None:
            return torch.zeros((1, 3), device=self.T_world_robot.device)
        return planar_log(se3_inv(self.T_prev) @ self.T_world_robot)

    def pose_at(self, stamp_us: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The trajectory's WNOA Gauss-process query at ``stamp_us``, clamped
        to the processed span: (T_world_robot (4, 4), body twist (6,) a
        second). Every processed frame must have carried a stamp; the knots'
        twists are central differences of the poses."""
        if len(self.stamps) != len(self._poses):
            raise ValueError("pose_at needs a stamp for every processed frame "
                             f"({len(self.stamps)} stamps vs {len(self._poses)} poses)")
        Ts = torch.stack(self._poses)
        Tq, wq = interpolate_trajectory(
            Ts, seconds_since(self.stamps, self.stamps[0]).to(Ts.device),
            seconds_since([stamp_us], self.stamps[0]).to(Ts.device))
        return Tq[0], wq[0]

    def process(self, scan: torch.Tensor, stamp_us: int | None = None,
                times: torch.Tensor | None = None) -> torch.Tensor:
        """Feed one scan cloud (N, 3) or (1, N, 3); returns its world pose
        (4, 4). ``times`` (N,) per-point observation times: with
        ``continuous_time`` the frame is registered by the joint (pose,
        twist) solve and merged from its twist-undistorted points."""
        scan = scan[None] if scan.ndim == 2 else scan
        ct = self.cfg.continuous_time and times is not None
        if ct:
            times = torch.as_tensor(times, device=scan.device)
            times = times[None] if times.ndim == 1 else times
        if stamp_us is not None:
            self.stamps.append(int(stamp_us))
        if self.map_pts is None:
            # Bootstrap: the first frame seeds the map at the origin.
            dev, dt = scan.device, scan.dtype
            self.T_world_robot = self.T_world_robot.to(dev)
            self.T_last_key = self.T_last_key.to(dev)
            self.map_pts, self.map_w = merge_into_map(
                torch.full((self.cfg.max_map_pts, 3), TARGET_PAD_VAL, dtype=dt, device=dev),
                scan[0], self.cfg, center=torch.zeros(3, dtype=dt, device=dev),
                map_w=torch.zeros((self.cfg.max_map_pts,), dtype=dt, device=dev))
            self.n_keyframes = 1
            eye = torch.eye(4, device=dev)
            self._poses.append(eye)
            return eye

        if ct:
            # The scan-start pose is the previous scan-end pose (the sweep is
            # continuous), so the constant-velocity extrapolation lives in the
            # twist prior; the solve returns the scan-end pose.
            T_end, xi = register_frame_ct(scan, times, self.map_pts[None], self.T_world_robot,
                                          self._xi_prior(), self.cfg)
            T = orthonormalize_planar(T_end)
        else:
            T = orthonormalize_planar(register_frame(scan, self.map_pts[None],
                                                     self._warm_start(), self.cfg))
        self.T_prev = self.T_world_robot
        self.T_world_robot = T
        self._poses.append(T[0])
        if is_keyframe((se3_inv(self.T_last_key) @ T)[0][None], self.cfg):
            if ct:
                # The undistorted points, in the scan-start frame, through the
                # scan-start pose T·Exp(ξ)⁻¹.
                T_start = T @ se3_inv(se3_exp(_planar_se3(xi)))
                scan_world = transform_points(T_start, undistort_with_twist(scan, times, xi))[0]
            else:
                scan_world = transform_points(T, scan)[0]
            self.map_pts, self.map_w = merge_into_map(
                self.map_pts, scan_world, self.cfg, center=T[0, :3, 3], map_w=self.map_w)
            self.T_last_key = T
            self.n_keyframes += 1
        return T[0]


def descriptor_bootstrap(img_a: torch.Tensor, pts_a: torch.Tensor, img_b: torch.Tensor,
                         pts_b: torch.Tensor, cart_resolution: float, descriptor: str = "orb",
                         nndr: float = 1.0, ransac_cfg: RansacConfig | None = None,
                         generator: torch.Generator | None = None) -> dict:
    """Appearance-based relative pose between consecutive scans, needing no
    initial guess: descriptors at the keypoints on the cartesian images
    (``"orb"`` or BASD), Hamming matching with the ratio and mutual tests,
    then the RANSAC consensus (hypotheses from ``generator``, a CPU
    generator, seeded 0 when omitted).

    img_* (B, H, W) cartesian images; pts_* (B, N, 3) keypoints (x = y = 0
    pads). Returns {'T' (B, 4, 4) mapping a → b, 'inliers', 'inlier_frac',
    'ok', 'matches' (B, N) int32, 'match_ok' (B, N) bool}."""
    desc_fn = orb_descriptors if descriptor == "orb" else basd_descriptors
    idx, ok = [], []
    for ia, pa, ib, pb in zip(img_a, pts_a, img_b, pts_b):
        va = ~((pa[..., 0] == 0.0) & (pa[..., 1] == 0.0))
        vb = ~((pb[..., 0] == 0.0) & (pb[..., 1] == 0.0))
        i, o = match_descriptors(desc_fn(ia, pa, cart_resolution),
                                 desc_fn(ib, pb, cart_resolution), va, vb, nndr=nndr)
        idx.append(i)
        ok.append(o)
    idx, ok = torch.stack(idx), torch.stack(ok)
    tgt = _gather_rows(pts_b[..., :2], idx)
    res = mcransac(pts_a[..., :2], tgt, ok,
                   ransac_cfg if ransac_cfg is not None else RansacConfig(), generator)
    return {**res, "matches": idx, "match_ok": ok}
