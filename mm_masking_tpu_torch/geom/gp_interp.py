"""WNOA Gauss-process trajectory interpolation between keyframe states.

Counterpart of ``mm_masking_tpu.geom.gp_interp``. With the right
multiplication convention ``T(τ) = T1 · Exp(ξ(α))`` and kinematics
``dT/dt = T · hat(w)`` (w the body twist), the WNOA posterior mean in the
local coordinates is the cubic Hermite interpolant with the boundary values

    ξ(0) = 0,      dξ/dα(0) = w1 · dt,
    ξ(1) = ξ12,    dξ/dα(1) = Jr(ξ12)⁻¹ (w2 · dt),

with ξ12 = Log(T1⁻¹ T2); the twist at τ is ``Jr(ξ) dξ/dα / dt``. A constant
twist is reproduced exactly. The 6×6 SE(3) Jacobian is the adjoint series
``Σₙ ad(ξ)ⁿ / (n + 1)!`` at a fixed 20 terms, exact to float32 rounding for
rotations below π. Products and the 6×6 solve run in float32 with TF32 off
(the package turns it off at import).
"""
from __future__ import annotations

import torch

from mm_masking_tpu_torch.geom.se3 import hat3, se3_exp, se3_inv, se3_log

_JACOBIAN_TERMS = 20


def se3_curly_hat(xi: torch.Tensor) -> torch.Tensor:
    """Algebra adjoint ad(ξ): (…, 6) -> (…, 6, 6) = [[φ^, ρ^], [0, φ^]]."""
    rho_hat, phi_hat = hat3(xi[..., :3]), hat3(xi[..., 3:])
    top = torch.cat([phi_hat, rho_hat], dim=-1)
    bot = torch.cat([torch.zeros_like(phi_hat), phi_hat], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_left_jacobian6(xi: torch.Tensor, terms: int = _JACOBIAN_TERMS) -> torch.Tensor:
    """Full 6×6 left Jacobian of SE(3) by the adjoint series."""
    ad = se3_curly_hat(xi)
    total = term = torch.eye(6, dtype=xi.dtype, device=xi.device).expand(ad.shape)
    for n in range(1, terms):
        term = (term @ ad) / (n + 1.0)
        total = total + term
    return total


def se3_right_jacobian6(xi: torch.Tensor, terms: int = _JACOBIAN_TERMS) -> torch.Tensor:
    """Full 6×6 right Jacobian: Jr(ξ) = Jl(−ξ)."""
    return se3_left_jacobian6(-xi, terms)


def _hermite(alpha: torch.Tensor):
    """Cubic Hermite basis (h10, h01, h11) and its derivative in α; h00
    multiplies the zero boundary value ξ(0)."""
    a2 = alpha * alpha
    a3 = a2 * alpha
    return ((a3 - 2.0 * a2 + alpha, -2.0 * a3 + 3.0 * a2, a3 - a2),
            (3.0 * a2 - 4.0 * alpha + 1.0, -6.0 * a2 + 6.0 * alpha, 3.0 * a2 - 2.0 * alpha))


def wnoa_interpolate(T1: torch.Tensor, w1: torch.Tensor, T2: torch.Tensor, w2: torch.Tensor,
                     alpha, dt=1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """The WNOA posterior-mean state between two knots.

    T1, T2 (…, 4, 4) knot poses; w1, w2 (…, 6) body twists [v, ω] in units
    a second; alpha the normalised query time in [0, 1]; dt the knot
    spacing in seconds (scalars or batched against …). Returns the pose
    (…, 4, 4) and body twist (…, 6) at t1 + α·dt."""
    alpha = torch.as_tensor(alpha, dtype=T1.dtype, device=T1.device)
    dt = torch.as_tensor(dt, dtype=T1.dtype, device=T1.device)
    xi12 = se3_log(se3_inv(T1) @ T2)
    g1 = w1 * dt[..., None]
    g2 = torch.linalg.solve(se3_right_jacobian6(xi12), (w2 * dt[..., None])[..., None])[..., 0]
    (h10, h01, h11), (dh10, dh01, dh11) = _hermite(alpha)
    xi = h10[..., None] * g1 + h01[..., None] * xi12 + h11[..., None] * g2
    dxi = dh10[..., None] * g1 + dh01[..., None] * xi12 + dh11[..., None] * g2
    T = T1 @ se3_exp(xi)
    w = (se3_right_jacobian6(xi) @ dxi[..., None])[..., 0] / dt[..., None]
    return T, w


def body_twists_from_trajectory(Ts: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Per-knot body twists by central differences,
    w_k = Log(T_{k−1}⁻¹ T_{k+1}) / (t_{k+1} − t_{k−1}), one-sided at the ends.
    Ts (K, 4, 4), times (K,) seconds -> (K, 6)."""
    K = Ts.shape[0]
    if K == 1:
        return torch.zeros((1, 6), dtype=Ts.dtype, device=Ts.device)
    k = torch.arange(K, device=Ts.device)
    lo, hi = (k - 1).clamp(min=0), (k + 1).clamp(max=K - 1)
    xi = se3_log(se3_inv(Ts[lo]) @ Ts[hi])
    span = torch.clamp(times[hi] - times[lo], min=1e-12)
    return xi / span[:, None].to(Ts.dtype)


def interpolate_trajectory(Ts: torch.Tensor, times: torch.Tensor, query_times: torch.Tensor,
                           twists: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Query a knot trajectory at arbitrary times.

    Ts (K, 4, 4) knot poses; times (K,) strictly increasing knot times in
    seconds; query_times (Q,), clamped to the knots' span; twists optional
    (K, 6) knot body twists (central differences when omitted). Returns
    ((Q, 4, 4) poses, (Q, 6) body twists)."""
    Ts = torch.as_tensor(Ts)
    times = torch.as_tensor(times, device=Ts.device).to(Ts.dtype)
    query_times = torch.as_tensor(query_times, device=Ts.device).to(Ts.dtype)
    if twists is None:
        twists = body_twists_from_trajectory(Ts, times)
    K, Q = Ts.shape[0], query_times.shape[0]
    if K == 1:
        return Ts[0].expand(Q, 4, 4), twists[0].expand(Q, 6)
    seg = (torch.searchsorted(times.contiguous(), query_times.contiguous(), right=True) - 1
           ).clamp(0, K - 2)
    t1, t2 = times[seg], times[seg + 1]
    dt = torch.clamp(t2 - t1, min=1e-12)
    alpha = torch.clamp((query_times - t1) / dt, 0.0, 1.0)
    return wnoa_interpolate(Ts[seg], twists[seg], Ts[seg + 1], twists[seg + 1], alpha, dt)
