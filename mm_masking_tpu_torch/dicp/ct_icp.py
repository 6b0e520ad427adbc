"""Continuous-time ICP: a joint Gauss-Newton solve over the scan-start pose
and the within-scan body twist.

Counterpart of ``mm_masking_tpu.dicp.ct_icp``. Point i, seen at normalised
time s_i ∈ [0, 1] of its sweep, sits at

    p'_i = T · Exp(s_i ξ) · p_i

with T the scan-start pose in the map and ξ = (ax, ay, aθ) the planar body
twist over the period. The GN state is (δx, δy, δθ, δax, δay, δaθ); the
twist's Jacobian rows are the pose rows scaled by s_i, first order in the
within-scan motion. A WNOA prior ties ξ to a prior mean (the last
inter-frame motion) and an optional pose prior ties T to T_prior.

Every iteration associates densely (K1, ``ops/kernels/nn_assoc.py::
nn_argmin`` on the card), as the JAX package's solve does: the sorted stripe
may pick another neighbour beyond the trim distance. The stop test is the
JAX ``while_loop``'s, global over the batch: every item steps until the
largest step norm falls under the tolerance, converged items included. The
loop runs in chunks of ``dicp.icp.STOP_TEST_EVERY`` iterations
(``dicp.icp.solve_in_chunks``: a CUDA graph on the card) and reads the test
once per chunk; the iterations after the stop change nothing, so
``iterations``, T and ξ are those of a test after every iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mm_masking_tpu_torch.dicp.icp import (
    _gather_rows,
    _planar,
    _prior_error6,
    robust_weight,
    solve_in_chunks,
)
from mm_masking_tpu_torch.geom import se3_exp
from mm_masking_tpu_torch.ops.kernels.nn_assoc import map_layout, nn_argmin


@dataclasses.dataclass(frozen=True)
class CTICPConfig:
    """Solver configuration; fields and defaults as in the JAX package."""

    icp_type: str = "pt2pt"  # "pt2pt" | "pt2pl"
    max_iterations: int = 30
    tolerance: float = 1e-6
    trim_dist: float = 5.0
    loss_name: str = "cauchy"
    loss_metric: float = 1.0
    damping: float = 1e-9
    twist_prior_weight: float = 1.0  # λ_w of ‖ξ − ξ_prior‖²
    pose_prior_weight: float = 0.0  # as ICPConfig.prior_weight
    use_pallas_nn: bool | None = None  # TPU kernel choice; ignored by the port


def _exp_planar_points(p: torch.Tensor, s: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """u_i = Exp(s_i ξ)·p_i, the exact planar exponential per point.
    p (B, N, 3), s (B, N), xi (B, 3) = (ax, ay, aθ); series-guarded at θ → 0."""
    th = s * xi[:, 2:3]
    c, si = torch.cos(th), torch.sin(th)
    x, y = p[..., 0], p[..., 1]
    small = th.abs() < 1e-6
    ssafe = torch.where(small, 1.0, xi[:, 2:3])
    A = torch.where(small, s * (1.0 - th * th / 6.0), si / ssafe)
    Bc = torch.where(small, s * th / 2.0, (1.0 - c) / ssafe)
    ax, ay = xi[:, 0:1], xi[:, 1:2]
    return torch.stack([c * x - si * y + (A * ax - Bc * ay),
                        si * x + c * y + (Bc * ax + A * ay), p[..., 2]], dim=-1)


def normalized_times(source: torch.Tensor, times: torch.Tensor,
                     time_to_sec: float = 1.0) -> torch.Tensor:
    """Per-point s ∈ [0, 1] over each item's real points; pad rows (x = y =
    0) get s = 0, the identity."""
    valid = ~((source[..., 0] == 0.0) & (source[..., 1] == 0.0))
    t = times.to(source.dtype) * time_to_sec
    t0 = torch.where(valid, t, float("inf")).amin(dim=1, keepdim=True)
    t1 = torch.where(valid, t, float("-inf")).amax(dim=1, keepdim=True)
    span = torch.clamp(t1 - t0, min=1e-12)
    return torch.where(valid, (t - t0) / span, 0.0)


def undistort_with_twist(source: torch.Tensor, times: torch.Tensor, xi: torch.Tensor,
                         time_to_sec: float = 1.0) -> torch.Tensor:
    """Each point in the scan-start frame under the twist ξ: Exp(s_i ξ)·p_i."""
    return _exp_planar_points(source[..., :3], normalized_times(source, times, time_to_sec), xi)


def planar_log(T: torch.Tensor) -> torch.Tensor:
    """Exact planar SE(2) log of (B, 4, 4) poses → (B, 3) = (ax, ay, aθ),
    the inverse of the planar exponential of :func:`_exp_planar_points`."""
    th = torch.atan2(T[:, 1, 0], T[:, 0, 0])
    tx, ty = T[:, 0, 3], T[:, 1, 3]
    half = th / 2.0
    small = th.abs() < 1e-6
    # V(θ)⁻¹ = (θ/2)·[[cot(θ/2), 1], [−1, cot(θ/2)]], series-guarded at 0.
    cot = torch.where(small, 1.0 - th * th / 12.0,
                      half * torch.cos(half) / torch.where(small, 1.0, torch.sin(half)))
    return torch.stack([cot * tx + half * ty, -half * tx + cot * ty, th], dim=-1)


def _planar_se3(v: torch.Tensor) -> torch.Tensor:
    """(B, 3) planar (x, y, θ) → (B, 6) twist with z, roll and pitch 0."""
    return torch.cat([v[:, :2], torch.zeros_like(v), v[:, 2:3]], dim=1)


def _gn_ct_step(T, xi, source, s_norm, target_pts, target_nrm, weight, source_valid,
                cfg: CTICPConfig, xi_prior, T_prior, q4=None):
    """One GN iteration over the joint (pose, twist) state: (T_new, xi_new,
    delta (B, 6))."""
    u = _exp_planar_points(source, s_norm, xi)  # scan-start frame
    R = T[:, :3, :3]
    p = u @ R.transpose(-1, -2) + T[:, None, :3, 3]

    idx, _ = nn_argmin(p.detach(), target_pts, q4)
    q = _gather_rows(target_pts, idx)
    diff = p - q
    dist = torch.linalg.vector_norm(diff + 1e-30, dim=-1)
    if cfg.icp_type == "pt2pl":
        n = _gather_rows(target_nrm, idx)
        r = (n * diff).sum(-1)
        r_norm = r.abs()
    else:
        r, r_norm = diff, dist
    active = torch.isfinite(dist) & (dist < cfg.trim_dist)
    w = robust_weight(torch.where(active, r_norm, 1.0), cfg.loss_name, cfg.loss_metric)
    w = torch.where(active, w, 0.0) * source_valid
    if weight is not None:
        w = w * weight
    r = torch.where(active if r.ndim == 2 else active[..., None], r, 0.0)
    p = torch.where(active[..., None], p, 0.0)
    u = torch.where(active[..., None], u, 0.0)

    # The 2×6 Jacobian rows (x, y, yaw, ax, ay, aθ): pose rows
    # [1 0 −p'_y; 0 1 p'_x], twist rows s · R₂ · [1 0 −u_y; 0 1 u_x].
    ones, zeros = torch.ones_like(w), torch.zeros_like(w)
    r00, r01 = R[:, 0:1, 0], R[:, 0:1, 1]
    r10, r11 = R[:, 1:2, 0], R[:, 1:2, 1]
    ux, uy = u[..., 0], u[..., 1]
    Jx = torch.stack([ones, zeros, -p[..., 1], s_norm * r00, s_norm * r01,
                      s_norm * (-r00 * uy + r01 * ux)], dim=-1)
    Jy = torch.stack([zeros, ones, p[..., 0], s_norm * r10, s_norm * r11,
                      s_norm * (-r10 * uy + r11 * ux)], dim=-1)
    if cfg.icp_type == "pt2pl":
        n = torch.where(active[..., None], n, 0.0)
        Jn = n[..., 0:1] * Jx + n[..., 1:2] * Jy
        A = torch.einsum("bni,bnj,bn->bij", Jn, Jn, w)
        b = -torch.einsum("bni,bn,bn->bi", Jn, r, w)
    else:
        A = (torch.einsum("bni,bnj,bn->bij", Jx, Jx, w)
             + torch.einsum("bni,bnj,bn->bij", Jy, Jy, w))
        b = -(torch.einsum("bni,bn,bn->bi", Jx, r[..., 0], w)
              + torch.einsum("bni,bn,bn->bi", Jy, r[..., 1], w))

    eye6 = torch.eye(6, dtype=A.dtype, device=A.device)
    zero3 = torch.zeros_like(xi)
    if cfg.twist_prior_weight > 0.0:
        lam_w = cfg.twist_prior_weight
        A = A + lam_w * eye6 * torch.cat([zero3[0], torch.ones_like(xi[0])])
        b = b - lam_w * torch.cat([zero3, xi - xi_prior], dim=1)
    if cfg.pose_prior_weight > 0.0 and T_prior is not None:
        lam_p = cfg.pose_prior_weight
        A = A + lam_p * eye6 * torch.cat([torch.ones_like(xi[0]), zero3[0]])
        b = b - lam_p * torch.cat([_planar(_prior_error6(T, T_prior), 1), zero3], dim=1)

    tr = A.diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0
    lam = cfg.damping + 1e-7 * tr
    A = A + lam[:, None, None] * eye6
    delta = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    return se3_exp(_planar_se3(delta[:, :3])) @ T, xi + delta[:, 3:], delta


def _iterate(st: dict, inp: dict, cfg: CTICPConfig, n: int) -> None:
    """n iterations of the solve, in place on its state ``st`` (T, xi, dn,
    iterations): while fewer than ``max_iterations`` have run and the
    largest dn is at least the tolerance, every item steps; after that an
    iteration changes nothing."""
    for _ in range(n):
        go = (st["iterations"] < cfg.max_iterations) & (st["dn"].amax() >= cfg.tolerance)
        T_new, xi_new, delta = _gn_ct_step(
            st["T"], st["xi"], inp["source"], inp["s_norm"], inp["target_pts"],
            inp.get("target_nrm"), inp.get("weight"), inp["source_valid"], cfg,
            inp["xi_prior"], inp.get("T_prior"), inp["q4"])
        st["T"].copy_(torch.where(go, T_new, st["T"]))
        st["xi"].copy_(torch.where(go, xi_new, st["xi"]))
        st["dn"].copy_(torch.where(go, torch.linalg.vector_norm(delta, dim=-1), st["dn"]))
        st["iterations"].add_(go)


def _start(st: dict, T_init: torch.Tensor, xi_init: torch.Tensor) -> None:
    st["T"].copy_(T_init)
    st["xi"].copy_(xi_init)
    st["dn"].fill_(float("inf"))
    st["iterations"].zero_()


def _new_state(T_init: torch.Tensor, xi_init: torch.Tensor) -> dict:
    st = {"T": torch.empty_like(T_init), "xi": torch.empty_like(xi_init),
          "dn": torch.empty((T_init.shape[0],), dtype=T_init.dtype, device=T_init.device),
          "iterations": torch.empty((), dtype=torch.int64, device=T_init.device)}
    _start(st, T_init, xi_init)
    return st


def ct_icp(
    source: torch.Tensor,
    times: torch.Tensor,
    target: torch.Tensor,
    T_init: torch.Tensor,
    xi_init: torch.Tensor | None = None,
    weight: torch.Tensor | None = None,
    cfg: CTICPConfig = CTICPConfig(),
    xi_prior: torch.Tensor | None = None,
    T_prior: torch.Tensor | None = None,
    time_to_sec: float = 1.0,
) -> dict[str, Any]:
    """Joint (pose, within-scan twist) registration.

    source (B, N, 3) with x = y = 0 pad rows; times (B, N) per-point
    observation times (any unit × ``time_to_sec``, normalised over each
    item's real points); target (B, M, 3|6) with far-sentinel pads (normals
    for pt2pl); T_init (B, 4, 4) the scan-start pose guess; xi_init (B, 3)
    defaults to xi_prior, which defaults to zero.

    Returns {'T' (scan-start pose), 'T_end' (T·Exp(ξ)), 'xi' (B, 3),
    'iterations' (int64 tensor), 'delta_norm' (B,), 'stop_tests' (int, the
    host's reads of the stop test)}. No gradient flows.
    """
    source = source[..., :3]
    B = source.shape[0]
    target_pts = target[..., :3]
    if cfg.icp_type == "pt2pl" and target.shape[-1] < 6:
        raise ValueError("pt2pl requires target with normals (B, M, 6)")
    if xi_prior is None:
        xi_prior = torch.zeros((B, 3), dtype=source.dtype, device=source.device)
    if xi_init is None:
        xi_init = xi_prior
    with torch.no_grad():
        inp = {"source": source, "s_norm": normalized_times(source, times, time_to_sec),
               "source_valid": (~((source[..., 0] == 0.0) & (source[..., 1] == 0.0))
                                ).to(source.dtype),
               "target_pts": target_pts, "q4": map_layout(target_pts), "xi_prior": xi_prior}
        for name, t in (("target_nrm", target[..., 3:6] if target.shape[-1] >= 6 else None),
                        ("weight", weight), ("T_prior", T_prior)):
            if t is not None:
                inp[name] = t
        st, stop_tests, graphs = solve_in_chunks(
            (cfg, T_init.shape, T_init.dtype), inp, T_init.device, cfg.max_iterations,
            cfg.tolerance, lambda: _new_state(T_init, xi_init),
            lambda st: _start(st, T_init, xi_init), lambda st, inp, n: _iterate(st, inp, cfg, n))
        out = {"T": st["T"], "xi": st["xi"], "iterations": st["iterations"],
               "delta_norm": st["dn"]}
        if graphs:  # the next solve of this shape overwrites the static state
            out = {name: t.clone() for name, t in out.items()}
        out["T_end"] = out["T"] @ se3_exp(_planar_se3(out["xi"]))
    return {**out, "stop_tests": stop_tests}
