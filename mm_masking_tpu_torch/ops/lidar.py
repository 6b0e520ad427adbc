"""Raw lidar ingestion: velodyne conversion and the lidar preprocessing chain.

Counterpart of ``mm_masking_tpu.ops.lidar``: an optional horizontal FOV
limit; then range crop → voxel subsample → normals from neighbourhoods in a
scaled log-polar metric (``r_scale``, ``h_scale``) → stage 1: up to
``num_sample1`` points with planarity ≥ ``min_norm_score1`` → stage 2: up to
``num_sample2`` by the incidence-corrected score ≥ ``min_norm_score2``, with
normals trusted only beyond ``min_normal_estimate_dist`` and under
``max_normal_estimate_angle``·π incidence.

Every output has a fixed shape: selection keeps the top scores (ties to the
lower index, as ``jax.lax.top_k``) and zeroes the dropped rows.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from mm_masking_tpu_torch.ops.preprocessing import (
    knn_indices,
    neighbourhood_pca,
    voxel_downsample,
)


@dataclasses.dataclass(frozen=True)
class LidarPreprocessConfig:
    """The lidar preprocessing parameters; fields and defaults as in the JAX
    package."""

    crop_range: float = 60.0
    frame_voxel_size: float = 0.3
    vertical_angle_res: float = 0.0017453292519943296
    polar_r_scale: float = 2.0
    r_scale: float = 4.0
    h_scale: float = 2.0
    num_sample1: int = 10000
    min_norm_score1: float = 0.95
    num_sample2: int = 20000
    min_norm_score2: float = 0.0
    min_normal_estimate_dist: float = 2.0
    max_normal_estimate_angle: float = 0.42  # × π
    knn_k: int = 10
    max_voxels: int = 32768


def velodyne_convert(raw: torch.Tensor, use_fov_limit: bool = False, fov_center: float = 45.0,
                     fov: float = 60.0) -> dict:
    """Raw returns (N, ≥3: x y z [intensity [t]]) → {'points' (N, 3), 'polar'
    (N, 3) = (rho, theta, phi), 'valid' (N,)}, theta the inclination and phi
    the azimuth. The FOV limit zeroes returns whose azimuth lies outside
    ``fov_center ± fov/2`` degrees."""
    pts = raw[..., :3]
    rho = torch.linalg.vector_norm(pts, dim=-1)
    phi = torch.atan2(pts[..., 1], pts[..., 0])
    theta = torch.arccos((pts[..., 2] / rho.clamp(min=1e-12)).clamp(-1.0, 1.0))
    valid = rho > 1e-6
    if use_fov_limit:
        center, half = math.radians(fov_center), math.radians(fov) / 2.0
        d = torch.remainder(phi - center + math.pi, 2 * math.pi).sub(math.pi).abs()
        valid = valid & (d <= half)
    return {"points": torch.where(valid[..., None], pts, 0.0),
            "polar": torch.stack([rho, theta, phi], dim=-1), "valid": valid}


def _scaled_polar_embedding(pts: torch.Tensor, cfg: LidarPreprocessConfig) -> torch.Tensor:
    """The metric of the neighbour search: log(rho)/r_scale, the inclination,
    and phi/h_scale."""
    rho = torch.linalg.vector_norm(pts, dim=-1).clamp(min=1e-6)
    phi = torch.atan2(pts[..., 1], pts[..., 0])
    theta = torch.arccos((pts[..., 2] / rho).clamp(-1.0, 1.0))
    return torch.stack([torch.log(rho) / cfg.r_scale, theta, phi / cfg.h_scale], dim=-1)


def _select_top(pts, nrm, score, ok, n_keep):
    """Keep up to n_keep rows by score among the ok rows; zero the rest."""
    masked = torch.where(ok, score, -math.inf)
    k = min(n_keep, score.shape[-1])
    top, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    keep = torch.isfinite(top)
    sel_pts = torch.where(keep[..., None], pts[idx], 0.0)
    sel_nrm = torch.where(keep[..., None], nrm[idx], 0.0)
    return sel_pts, sel_nrm, keep


def lidar_preprocess(points: torch.Tensor,
                     cfg: LidarPreprocessConfig = LidarPreprocessConfig()) -> dict:
    """The filtering chain on one frame (N, 3) → {'points', 'normals', 'valid'}
    of ``num_sample2`` rows and the stage-1 cloud ({'stage1_points', …}),
    pad rows zeroed."""
    rho = torch.linalg.vector_norm(points, dim=-1)
    pts = torch.where(((rho > 1e-6) & (rho <= cfg.crop_range))[..., None], points, 0.0)
    vox = voxel_downsample(pts, voxel=cfg.frame_voxel_size, max_out=cfg.max_voxels, pad_val=0.0)
    vvalid = (vox != 0.0).any(-1)

    # Neighbours in the embedding; the covariance on the euclidean points.
    emb = torch.where(vvalid[..., None], _scaled_polar_embedding(vox, cfg), 1e6)
    idx = knn_indices(emb[None], cfg.knn_k)
    vals, vecs = neighbourhood_pca(vox[None], idx)
    vals, normals = vals[0], vecs[0, ..., 0]
    normals = torch.where((normals * vox).sum(-1, keepdim=True) > 0, -normals, normals)
    e1, e2, e3 = vals.unbind(-1)
    planarity = (e2 - e1) / e3.clamp(min=1e-12)

    rho_v = torch.linalg.vector_norm(vox, dim=-1).clamp(min=1e-9)
    cos_inc = (normals * (-vox / rho_v[..., None])).sum(-1).abs()
    incidence = torch.arccos(cos_inc.clamp(0.0, 1.0))
    trust = ((rho_v >= cfg.min_normal_estimate_dist)
             & (incidence <= cfg.max_normal_estimate_angle * math.pi))

    ok1 = vvalid & trust & (planarity >= cfg.min_norm_score1)
    p1, n1, v1 = _select_top(vox, normals, planarity, ok1, cfg.num_sample1)
    score2 = planarity * cos_inc
    ok2 = vvalid & trust & (score2 >= cfg.min_norm_score2)
    p2, n2, v2 = _select_top(vox, normals, score2, ok2, cfg.num_sample2)
    return {"points": p2, "normals": n2, "valid": v2,
            "stage1_points": p1, "stage1_normals": n1, "stage1_valid": v1}


def lidar_frame_to_map_cloud(raw: torch.Tensor,
                             cfg: LidarPreprocessConfig = LidarPreprocessConfig(),
                             use_fov_limit: bool = False, fov_center: float = 45.0,
                             fov: float = 60.0) -> torch.Tensor:
    """Raw velodyne frame → (num_sample2, 6) [xyz, normal] cloud: conversion
    and filtering in one call."""
    conv = velodyne_convert(raw, use_fov_limit, fov_center, fov)
    out = lidar_preprocess(conv["points"], cfg)
    return torch.cat([out["points"], out["normals"]], dim=-1)
