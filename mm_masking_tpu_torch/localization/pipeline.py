"""Radar→map localization: raw Navtech scan → pose against a map.

Counterpart of ``mm_masking_tpu.localization.pipeline``. One frame runs:

  detector (any of the five) → peak extraction to a fixed-size cloud →
  optional Doppler correction and motion un-distortion → optional
  learned-mask weights → map projection filter (elevation, z-normal) →
  initial ICP (4 unrolled iterations) → refined ICP (tolerance-stopped) →
  matched-ratio check (dense nearest neighbours at the solution).

Both ICP phases run without gradients. The refined phase is the port's
tolerance-stopped solve: on the card chunks of ``STOP_TEST_EVERY``
iterations replayed from CUDA graphs, with one read of the stop test per
chunk. Whole sequences run in chunks of ``batch_size`` frames, padded with
the last frame; the results stay on the device until the one concatenation
at the end. Over a mesh of cards (``mesh=``) each rank localizes its rows
of every chunk and gathers the chunk's results, so every rank returns the
whole sequence's, as the call without a mesh does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from mm_masking_tpu_torch.dicp import ICPConfig, icp
from mm_masking_tpu_torch.geom import se3_inv, transform_points
from mm_masking_tpu_torch.localization.odometry import orthonormalize_planar
from mm_masking_tpu_torch.ops import extract_pc, extract_weights
from mm_masking_tpu_torch.ops.detectors import detect, doppler_shift, motion_undistort
from mm_masking_tpu_torch.ops.kernels.nn_assoc import nn_argmin
from mm_masking_tpu_torch.parallel.mesh import Mesh, shard_axis

_FRAME_KEYS = ("fft", "azimuths", "az_times")


@dataclasses.dataclass(frozen=True)
class LocalizationConfig:
    """The localization and front-end settings; fields and defaults as in
    the JAX package."""

    detector: str = "modified_cacfar"
    detector_kwargs: tuple = ()  # dict items, e.g. (("width", 101),)
    radar_resolution: float = 0.0596
    max_points: int = 4096
    beta: float = 0.049  # Doppler factor; 0 disables
    elevation_threshold: float = 0.05
    normal_threshold: float = 0.5
    icp_type: str = "pt2pl"
    initial_max_iter: int = 4
    initial_max_pairing_dist: float = 5.0
    refined_max_iter: int = 50
    refined_max_pairing_dist: float = 5.0
    cauchy_k: float = 1.0
    tolerance: float = 1e-5
    min_matched_ratio: float = 0.0
    motion_undistort: bool = False
    az_time_to_sec: float = 1e-9  # unit of az_times (ns)
    nn_refresh_dist: float = 0.0
    max_step_m: float = 0.0


def project_map(map_pc: torch.Tensor, cfg: LocalizationConfig) -> torch.Tensor:
    """Push map points outside the radar's view to the far pad value: points
    above the elevation threshold or with |z-normal| beyond the normal
    threshold. map_pc (B, M, 6) in the scan frame."""
    pts, nrm = map_pc[..., :3], map_pc[..., 3:6]
    elev = torch.atan2(pts[..., 2], torch.sqrt(pts[..., 0] ** 2 + pts[..., 1] ** 2) + 1e-30).abs()
    ok = (elev <= cfg.elevation_threshold) & (nrm[..., 2].abs() <= cfg.normal_threshold)
    return torch.where(ok[..., None], map_pc, 1000.0)


def _icp_configs(cfg: LocalizationConfig) -> tuple[ICPConfig, ICPConfig]:
    common = dict(icp_type=cfg.icp_type, loss_name="cauchy", loss_metric=cfg.cauchy_k, dim=2,
                  max_step_m=cfg.max_step_m)
    initial = ICPConfig(max_iterations=cfg.initial_max_iter, differentiable=True,
                        trim_dist=cfg.initial_max_pairing_dist, **common)
    refined = ICPConfig(max_iterations=cfg.refined_max_iter, differentiable=False,
                        tolerance=cfg.tolerance, trim_dist=cfg.refined_max_pairing_dist,
                        nn_refresh_dist=cfg.nn_refresh_dist, **common)
    return initial, refined


def localize_clouds(pc: torch.Tensor, map_pc: torch.Tensor, T_init: torch.Tensor,
                    cfg: LocalizationConfig = LocalizationConfig(),
                    pc_times: torch.Tensor | None = None,
                    velocity: torch.Tensor | None = None,
                    yaw_rate: torch.Tensor | None = None,
                    weights: torch.Tensor | None = None) -> dict[str, Any]:
    """Register extracted clouds against a map: the back half of
    :func:`localize_frame`.

    pc (B, N, 3) zero-padded; map_pc (B, M, 6) with normals (zero normals
    for pt2pt); T_init (B, 4, 4). Doppler and motion correction when
    ``velocity`` (and ``pc_times``) are given. Returns {'T', 'points',
    'weights', 'matched_ratio', 'ok'}.
    """
    with torch.no_grad():
        if cfg.beta > 0.0 and velocity is not None:
            pc = doppler_shift(pc, torch.atan2(pc[..., 1], pc[..., 0]), velocity, beta=cfg.beta)
        if cfg.motion_undistort and velocity is not None and pc_times is not None:
            wz = yaw_rate if yaw_rate is not None else pc.new_zeros(pc.shape[0])
            pc = motion_undistort(pc, pc_times, velocity, wz, time_to_sec=cfg.az_time_to_sec)
        valid = ~((pc[..., 0] == 0.0) & (pc[..., 1] == 0.0))
        if weights is None:
            weights = valid.to(pc.dtype)
        map_proj = project_map(map_pc, cfg)
        initial_cfg, refined_cfg = _icp_configs(cfg)
        initial = icp(pc, map_proj, T_init, weight=weights, cfg=initial_cfg)
        T = icp(pc, map_proj, initial["T"], weight=weights, cfg=refined_cfg)["T"]

        # Matched ratio: the share of real scan points whose nearest map point
        # lies within the refined pairing distance at the solution.
        _, d2 = nn_argmin(transform_points(T, pc).contiguous(), map_proj[..., :3])
        matched = (d2 < cfg.refined_max_pairing_dist ** 2) & valid
        ratio = matched.sum(1) / valid.sum(1).clamp(min=1)
    return {"T": T, "points": pc, "weights": weights, "matched_ratio": ratio,
            "ok": ratio >= cfg.min_matched_ratio}


def localize_frame(fft: torch.Tensor, azimuths: torch.Tensor, az_times: torch.Tensor,
                   map_pc: torch.Tensor, T_init: torch.Tensor,
                   cfg: LocalizationConfig = LocalizationConfig(),
                   velocity: torch.Tensor | None = None,
                   yaw_rate: torch.Tensor | None = None,
                   weight_mask: torch.Tensor | None = None,
                   mask_cart_resolution: float = 0.2384,
                   mask_cart_width: int = 640) -> dict[str, Any]:
    """Batched localization from raw polar scans: fft (B, A, R) power,
    azimuths and az_times (B, A), map_pc (B, M, 6) in (or near) the scan
    frame, T_init (B, 4, 4); ``weight_mask`` (B, W, W) weights the points.
    The detector and peak extraction, then :func:`localize_clouds`."""
    with torch.no_grad():
        mask = detect(cfg.detector, fft, cfg.radar_resolution, **dict(cfg.detector_kwargs))
        pc, pc_times = extract_pc(mask, cfg.radar_resolution, azimuths, az_times,
                                  max_points=cfg.max_points, diff=False, return_times=True)
        weights = None
        if weight_mask is not None:
            weights, _ = extract_weights(weight_mask, pc, cart_resolution=mask_cart_resolution,
                                         cart_pixel_width=mask_cart_width)
    return localize_clouds(pc, map_pc, T_init, cfg=cfg, pc_times=pc_times, velocity=velocity,
                           yaw_rate=yaw_rate, weights=weights)


def _chunk_mesh(mesh: Mesh | None, batch_size: int) -> Mesh | None:
    """The mesh a chunk of ``batch_size`` frames is sharded over: None (every
    rank localizes the whole chunk) without one, or where the chunk does not
    divide it."""
    if mesh is None or mesh.group is None or not mesh.divides(batch_size):
        return None
    return mesh


def _gather(out: dict, mesh: Mesh | None) -> dict:
    return out if mesh is None else {k: mesh.gather(v) for k, v in out.items()}


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _map_batch(map_pc: torch.Tensor, batch_size: int) -> torch.Tensor:
    """(M, C) or (1, M, C) → (batch_size, M, 6), zero normals appended to a
    map without them."""
    if map_pc.ndim == 2:
        map_pc = map_pc[None]
    if map_pc.shape[-1] < 6:
        map_pc = torch.cat([map_pc, map_pc.new_zeros(map_pc.shape[:-1] + (6 - map_pc.shape[-1],))],
                           dim=-1)
    return map_pc.expand(batch_size, -1, -1)


def _chunks(arrays, F: int, batch_size: int):
    """Chunks of ``batch_size`` frames of each (F, …) tensor, the last one
    padded by repeating the sequence's last frame."""
    for s in range(0, F, batch_size):
        out = []
        for x in arrays:
            c = x[s:s + batch_size]
            pad = batch_size - c.shape[0]
            out.append(torch.cat([c, x[-1:].expand((pad,) + x.shape[1:])]) if pad else c)
        yield out


def _concat(outs: list[dict], F: int) -> dict:
    return {k: torch.cat([o[k] for o in outs])[:F] for k in outs[0]}


def _eye_inits(F: int, device) -> torch.Tensor:
    return torch.eye(4, device=device).expand(F, 4, 4)


def _mask_kw(weight_policy) -> dict:
    """The mask image's geometry for :func:`localize_frame`, from the policy."""
    if weight_policy is None:
        return {}
    pm = weight_policy.cfg.model
    return dict(mask_cart_resolution=pm.cart_resolution, mask_cart_width=pm.cart_pixel_width)


def _stack_frames(frames, device) -> dict[str, torch.Tensor]:
    """A dict of stacked frames, or a list of per-frame dicts (each may hold
    several frames on a leading axis), as float32 tensors on ``device``."""
    if isinstance(frames, (list, tuple)):
        def batched(v, base_ndim):
            v = _tensor(v, device)
            return v if v.ndim > base_ndim else v[None]

        return {k: torch.cat([batched(fr[k], 2 if k == "fft" else 1) for fr in frames])
                for k in _FRAME_KEYS}
    return {k: _tensor(frames[k], device) for k in _FRAME_KEYS}


def localize_sequence(frames, map_pc: torch.Tensor,
                      cfg: LocalizationConfig = LocalizationConfig(), T_inits=None,
                      batch_size: int = 8, mesh=None, weight_policy=None,
                      policy_variables=None) -> dict[str, torch.Tensor]:
    """Localize a whole sequence against one map, in chunks of
    ``batch_size`` frames on the map's device.

    frames: {'fft' (F, A, R), 'azimuths' (F, A), 'az_times' (F, A)} or a
    list of per-frame dicts (numpy arrays or tensors). ``weight_policy``
    (a :class:`LearnICPWeightPolicy`) with ``policy_variables`` runs its
    :meth:`mask_for_scan` on each chunk (its batch-global normalisation sees
    the chunk's padding frames, as the JAX package's does) and weights the
    ICP with the mask. Returns the stacked results of :func:`localize_frame`
    over all F frames.

    ``mesh`` (a :class:`~mm_masking_tpu_torch.parallel.Mesh` on the map's
    device): each rank localizes its rows of every chunk (the mask's
    normalisation over the whole chunk) and every rank returns the whole
    result; a ``batch_size`` that does not divide the mesh runs every chunk
    whole on every rank.
    """
    dev = map_pc.device
    frames = _stack_frames(frames, dev)
    F = frames["fft"].shape[0]
    T_inits = _eye_inits(F, dev) if T_inits is None else _tensor(T_inits, dev)
    mesh = _chunk_mesh(mesh, batch_size)
    map_b = _map_batch(map_pc, batch_size // (mesh.size if mesh else 1))
    mask_kw = _mask_kw(weight_policy)
    outs = []
    with torch.no_grad():
        for chunk in _chunks([frames[k] for k in _FRAME_KEYS] + [T_inits], F, batch_size):
            fft, az, azt, T0 = (shard_axis(x, mesh, 0) for x in chunk) if mesh else chunk
            wm = None
            if weight_policy is not None:
                wm = weight_policy.mask_for_scan(policy_variables, fft, az, mesh=mesh)
            outs.append(_gather(localize_frame(fft, az, azt, map_b, T0, cfg=cfg,
                                               weight_mask=wm, **mask_kw), mesh))
    return _concat(outs, F)


def localize_cloud_sequence(clouds, map_pc: torch.Tensor,
                            cfg: LocalizationConfig = LocalizationConfig(), T_inits=None,
                            batch_size: int = 8, mesh=None) -> dict[str, torch.Tensor]:
    """Localize a sequence of extracted clouds (F, N, 3), zero-padded,
    against one map (M, 3|6) or (1, M, 3|6), in chunks as
    :func:`localize_sequence`; a 3-column map gets zero normals (pt2pt).
    ``mesh``: as in :func:`localize_sequence`."""
    dev = map_pc.device
    clouds = _tensor(clouds, dev)
    F = clouds.shape[0]
    T_inits = _eye_inits(F, dev) if T_inits is None else _tensor(T_inits, dev)
    mesh = _chunk_mesh(mesh, batch_size)
    map_b = _map_batch(map_pc, batch_size // (mesh.size if mesh else 1))
    outs = []
    for chunk in _chunks([clouds, T_inits], F, batch_size):
        pc, T0 = (shard_axis(x, mesh, 0) for x in chunk) if mesh else chunk
        outs.append(_gather(localize_clouds(pc, map_b, T0, cfg=cfg), mesh))
    return _concat(outs, F)


def localize_sequence_tracked(frames, map_pc: torch.Tensor,
                              cfg: LocalizationConfig = LocalizationConfig(), T0=None,
                              weight_policy=None, policy_variables=None,
                              clouds=None) -> dict[str, torch.Tensor]:
    """Sequential tracking against one map, one frame at a time: frame k
    starts from the constant-velocity extrapolation of the two previous
    solutions, re-orthonormalised (:func:`orthonormalize_planar`), so only
    the first frame needs a prior ``T0`` (default identity). A frame that
    fails the matched-ratio gate passes its warm start on instead of its
    pose. ``frames`` as in :func:`localize_sequence`, or ``clouds``
    (F, N, 3) instead; with ``weight_policy`` the mask is computed per frame
    (its normalisation over that frame alone)."""
    dev = map_pc.device
    if clouds is None:
        frames = _stack_frames(frames, dev)
        F = frames["fft"].shape[0]
    else:
        if weight_policy is not None:
            raise ValueError("localize_sequence_tracked: weight_policy needs raw frames (the "
                             "mask is computed from the scan image); got clouds")
        clouds = _tensor(clouds, dev)
        F = clouds.shape[0]
    if map_pc.ndim == 2:
        map_pc = map_pc[None]
    mask_kw = _mask_kw(weight_policy)
    T_prev2 = T_prev = torch.eye(4, device=dev) if T0 is None else _tensor(T0, dev)
    outs = []
    with torch.no_grad():
        for k in range(F):
            T_init = orthonormalize_planar(T_prev @ (se3_inv(T_prev2) @ T_prev))[None]
            if clouds is None:
                fft, az, azt = (frames[key][k:k + 1] for key in _FRAME_KEYS)
                wm = None
                if weight_policy is not None:
                    wm = weight_policy.mask_for_scan(policy_variables, fft, az)
                out = localize_frame(fft, az, azt, map_pc, T_init, cfg=cfg, weight_mask=wm,
                                     **mask_kw)
            else:
                out = localize_clouds(clouds[k:k + 1], map_pc, T_init, cfg=cfg)
            outs.append(out)
            T_sol = torch.where(out["ok"][0], out["T"][0], T_init[0])
            T_prev2, T_prev = T_prev, T_sol
    return _concat(outs, F)


def localize_sequence_to_traj(frames, map_pc: torch.Tensor, times_us, out_path: str,
                              cfg: LocalizationConfig = LocalizationConfig(), T_inits=None,
                              batch_size: int = 8, mesh=None, weight_policy=None,
                              policy_variables=None) -> dict[str, torch.Tensor]:
    """:func:`localize_sequence`, then a trajectory file for
    ``evaluation.gt_tools.eval_localization_run``: the solver's T maps scan
    to map (T_map_loc); the rows carry T_loc_map. Under a ``mesh`` rank 0
    writes the file."""
    from mm_masking_tpu_torch.evaluation.gt_tools import write_traj_file

    out = localize_sequence(frames, map_pc, cfg=cfg, T_inits=T_inits, batch_size=batch_size,
                            mesh=mesh, weight_policy=weight_policy,
                            policy_variables=policy_variables)
    if mesh is None or mesh.rank == 0:
        write_traj_file(out_path, list(se3_inv(out["T"]).cpu().numpy()),
                        [int(t) for t in times_us])
    return out
