"""SE(3) / SO(3) operations used by the inference slice (lgmath convention).

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


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(…, 6) twist [rho, phi] -> (…, 4, 4) homogeneous transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = so3_exp(phi)
    T[..., :3, 3] = (so3_left_jacobian(phi) @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


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


def planar_xi_first_order(T: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference loss's first-order planar twist read from ``T − I``:
    returns (xi_theta (…, 1) = sin θ, xi_r (…, 2))."""
    xi_wedge = T - torch.eye(4, dtype=T.dtype, device=T.device)
    return xi_wedge[..., 1, 0][..., None], xi_wedge[..., 0:2, 3]
