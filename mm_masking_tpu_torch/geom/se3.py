"""SE(3) / SO(3) operations (lgmath convention).

Counterpart of ``mm_masking_tpu.geom.se3``: a twist ``xi = [rho, phi]``
(translation first) maps to ``T = [[exp(phi^), J(phi) rho], [0, 1]]``. The
small-angle branches use the same Taylor guards and the half-angle form of
``(1 - cos t) / t^2`` that stays exact in float32.
"""
from __future__ import annotations

import torch


def hat3(phi: torch.Tensor) -> torch.Tensor:
    """(…, 3) axis-angle vector -> (…, 3, 3) skew-symmetric matrix."""
    x, y, z = phi.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee3(M: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) skew-symmetric matrix -> (…, 3) vector."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _theta_terms(phi: torch.Tensor):
    sq = (phi * phi).sum(-1)
    small = sq < 1e-8
    safe_sq = torch.where(small, torch.ones_like(sq), sq)
    return sq, safe_sq, torch.sqrt(safe_sq), small


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: (…, 3) -> (…, 3, 3)."""
    sq, safe_sq, theta, small = _theta_terms(phi)
    K = hat3(phi)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(theta) / theta)[..., None, None]
    half_sin = torch.sin(0.5 * theta)
    b = torch.where(small, 0.5 - sq / 24.0, 2.0 * half_sin * half_sin / safe_sq)[
        ..., None, None
    ]
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def so3_log(C: torch.Tensor) -> torch.Tensor:
    """(…, 3, 3) rotation matrix -> (…, 3) axis-angle vector, for |θ| < π.

    The small-angle guard is cos θ ≥ 1 − 1e-6, as in the JAX package: a
    tighter one (1 − 1e-8) rounds to 1 in float32, never fires, and gives
    0/0 at the identity."""
    trace = C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    small = cos_theta >= 1.0 - 1e-6
    # arccos has an infinite derivative at 1: the small branch feeds it 0.
    theta = torch.arccos(torch.where(small, torch.zeros_like(cos_theta), cos_theta))
    w = vee3(C - C.transpose(-1, -2)) * 0.5  # = sin(θ) · axis
    scale = torch.where(small, 1.0 + (1.0 - cos_theta) / 3.0, theta / torch.sin(theta))
    return w * scale[..., None]


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J(phi) of SO(3): (…, 3) -> (…, 3, 3)."""
    sq, safe_sq, theta, small = _theta_terms(phi)
    K = hat3(phi)
    half_sin = torch.sin(0.5 * theta)
    b = torch.where(small, 0.5 - sq / 24.0, 2.0 * half_sin * half_sin / safe_sq)[
        ..., None, None
    ]
    c = torch.where(
        small, 1.0 / 6.0 - sq / 120.0, (theta - torch.sin(theta)) / (safe_sq * theta)
    )[..., None, None]
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye + b * K + c * (K @ K)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3): (…, 3) -> (…, 3, 3). The trig form of
    the K² coefficient cancels catastrophically in float32 below θ ≈ 0.1, so
    the Taylor branch covers θ² < 0.01, as in the JAX package."""
    sq, safe_sq, theta, _ = _theta_terms(phi)
    K = hat3(phi)
    small = sq < 0.01
    one_minus_cos = 1.0 - torch.cos(theta)
    denom = torch.where(small, torch.ones_like(one_minus_cos), 2.0 * one_minus_cos)
    cot_term = torch.where(
        small, 1.0 / 12.0 + sq / 720.0 + sq * sq / 30240.0,
        (1.0 - theta * torch.sin(theta) / denom) / safe_sq,
    )[..., None, None]
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return eye - 0.5 * K + cot_term * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(…, 6) twist [rho, phi] -> (…, 4, 4) homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = so3_exp(phi)
    T[..., :3, 3] = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(…, 4, 4) transform -> (…, 6) twist [rho, phi] with T = exp(xi^)."""
    phi = so3_log(T[..., :3, :3])
    rho = (so3_left_jacobian_inv(phi) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a (…, 4, 4) rigid transform."""
    Ct = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Ct
    out[..., :3, 3] = -(Ct @ T[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (…, 4, 4) transforms to (…, N, 3) points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of (…, 4, 4) transforms to (…, N, 3) vectors."""
    return vecs @ T[..., :3, :3].transpose(-1, -2)


def planar_xi_first_order(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference loss's first-order planar twist read from ``T − I``:
    returns (xi_theta (…, 1) = sin θ, xi_r (…, 2))."""
    xi_wedge = T - torch.eye(4, dtype=T.dtype, device=T.device)
    return xi_wedge[..., 1, 0][..., None], xi_wedge[..., 0:2, 3]


def yaw_to_se3(x: torch.Tensor, y: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Planar pose (x, y, theta) -> (…, 4, 4) SE(3) matrix (exact, not exp)."""
    c, s = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, zero, x], dim=-1),
        torch.stack([s, c, zero, y], dim=-1),
        torch.stack([zero, zero, one, zero], dim=-1),
        torch.stack([zero, zero, zero, one], dim=-1),
    ], dim=-2)
