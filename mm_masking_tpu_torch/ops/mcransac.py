"""Batched planar RANSAC rigid-motion estimator (vtr ``radar.mcransac``).

Counterpart of ``mm_masking_tpu.ops.mcransac``: every two-point hypothesis
is scored at once as a (B, R, N) residual matrix, the best (the first of the
largest inlier counts) seeds an iterated re-gate / closed-form Procrustes
refinement, and the result is the pose, the inliers and the inlier share.

The hypotheses' indices cannot be JAX's: ``jax.random`` bits have no torch
counterpart. :func:`mcransac` draws them with :func:`draw_hypotheses` from a
``torch.Generator`` (seeded 0 by default, as JAX's ``PRNGKey(0)``), on the
CPU, so that the card and the CPU draw the same pairs, and hands them to
:func:`mcransac_from_hypotheses`, which takes any indices; the parity tests
feed it JAX's draws. The refinement's stop is JAX's, global over the batch:
while any item's angle still moves more than ``epsilon_converge``, every
item re-gates. It runs its ``max_gn_iterations`` passes on the device, those
after the stop changing nothing, so no pass reads the device from the host.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Fields and defaults as in the JAX package."""

    tolerance: float = 0.1225  # squared inlier gate (m²)
    inlier_ratio: float = 0.9  # the `ok` flag's target
    iterations: int = 100  # hypothesis count
    max_gn_iterations: int = 10  # re-gate / re-solve passes
    epsilon_converge: float = 1e-4


def _rotation2(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _procrustes_2d(src, tgt, w):
    """Weighted planar rigid alignment: R, t, θ minimising Σ w‖R p + t − q‖²."""
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    mu_s = (src * w[..., None]).sum(-2) / wsum
    mu_t = (tgt * w[..., None]).sum(-2) / wsum
    ps = src - mu_s[..., None, :]
    pt = tgt - mu_t[..., None, :]
    a = (w * (ps[..., 0] * pt[..., 0] + ps[..., 1] * pt[..., 1])).sum(-1)
    b = (w * (ps[..., 0] * pt[..., 1] - ps[..., 1] * pt[..., 0])).sum(-1)
    theta = torch.atan2(b, a)
    R = _rotation2(torch.cos(theta), torch.sin(theta))
    t = mu_t - (R @ mu_s[..., None])[..., 0]
    return R, t, theta


def _to_se3(R2: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=R2.dtype, device=R2.device).repeat(*R2.shape[:-2], 1, 1)
    T[..., :2, :2] = R2
    T[..., :2, 3] = t2
    return T


def draw_hypotheses(B: int, N: int, iterations: int, generator: torch.Generator | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(i1, i2) (B, iterations) int64 on the CPU: two distinct indices in
    [0, N) a hypothesis, i2 = (i1 + off) mod N with off ∈ [1, N), the JAX
    package's construction. ``generator``: a CPU ``torch.Generator``, seeded 0
    when omitted."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    i1 = torch.randint(0, N, (B, iterations), generator=generator)
    off = torch.randint(1, max(N, 2), (B, iterations), generator=generator)
    return i1, (i1 + off) % N


def mcransac_from_hypotheses(src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor | None,
                             cfg: RansacConfig, i1: torch.Tensor, i2: torch.Tensor) -> dict:
    """The estimator on given hypotheses: i1, i2 (B, R) index pairs of
    matched points. src/tgt (B, N, 2|3) matched correspondences (pads where
    ``valid`` is False). Returns {'T' (B, 4, 4), 'inliers' (B, N) bool,
    'inlier_frac' (B,), 'ok' (B,)}."""
    B, N = src.shape[:2]
    s2, t2 = src[..., :2], tgt[..., :2]
    if valid is None:
        valid = torch.ones((B, N), dtype=torch.bool, device=src.device)
    vf = valid.to(s2.dtype)
    i1, i2 = i1.to(src.device), i2.to(src.device)

    def gather(pts, idx):
        return torch.gather(pts, 1, idx[..., None].expand(-1, -1, pts.shape[-1]))

    p1, p2, q1, q2 = gather(s2, i1), gather(s2, i2), gather(t2, i1), gather(t2, i2)
    v_hyp = torch.gather(vf, 1, i1) * torch.gather(vf, 1, i2)
    dp, dq = p2 - p1, q2 - q1
    theta = torch.atan2(dp[..., 0] * dq[..., 1] - dp[..., 1] * dq[..., 0],
                        dp[..., 0] * dq[..., 0] + dp[..., 1] * dq[..., 1])
    c, s = torch.cos(theta), torch.sin(theta)
    Rh = _rotation2(c, s)
    th = q1 - (Rh @ p1[..., None])[..., 0]

    # Every point under every hypothesis: (B, R, N).
    pred = torch.einsum("brij,bnj->brni", Rh, s2) + th[..., None, :]
    r2 = ((pred - t2[:, None]) ** 2).sum(-1)
    inl = (r2 < cfg.tolerance) & valid[:, None, :]
    counts = inl.sum(-1) * v_hyp.to(torch.int64)
    best = torch.argmax(counts, dim=-1)  # the first of the largest counts
    w = torch.gather(inl, 1, best[:, None, None].expand(-1, 1, N))[:, 0].to(s2.dtype)

    theta_prev = torch.zeros((B,), dtype=s2.dtype, device=src.device)
    dtheta = torch.full((B,), float("inf"), dtype=s2.dtype, device=src.device)
    for _ in range(cfg.max_gn_iterations):
        go = (dtheta > cfg.epsilon_converge).any()
        Rr, tr, theta = _procrustes_2d(s2, t2, w * vf)
        pred = (Rr[:, None] @ s2[..., None])[..., 0] + tr[:, None, :]
        w_new = ((((pred - t2) ** 2).sum(-1) < cfg.tolerance) & valid).to(s2.dtype)
        w = torch.where(go, w_new, w)
        dtheta = torch.where(go, (theta - theta_prev).abs(), dtheta)
        theta_prev = torch.where(go, theta, theta_prev)
    Rr, tr, _ = _procrustes_2d(s2, t2, w * vf)
    inliers = (w > 0.5) & valid
    frac = inliers.sum(-1) / torch.clamp(valid.sum(-1), min=1)
    return {"T": _to_se3(Rr, tr), "inliers": inliers, "inlier_frac": frac,
            "ok": frac >= cfg.inlier_ratio}


def mcransac(src: torch.Tensor, tgt: torch.Tensor, valid: torch.Tensor | None = None,
             cfg: RansacConfig = RansacConfig(),
             generator: torch.Generator | None = None) -> dict:
    """The planar rigid transform mapping matched ``src[i] → tgt[i]``, on
    ``cfg.iterations`` hypotheses drawn by :func:`draw_hypotheses` from
    ``generator`` (a CPU generator; seeded 0 when omitted)."""
    B, N = src.shape[:2]
    i1, i2 = draw_hypotheses(B, N, cfg.iterations, generator)
    return mcransac_from_hypotheses(src, tgt, valid, cfg, i1, i2)


def ransac_filter_pc(pc: torch.Tensor, inliers: torch.Tensor) -> torch.Tensor:
    """The ``filter_pc`` output: outlier rows zeroed (the (0, 0) pad rows
    that weighting and ICP drop)."""
    return torch.where(inliers[..., None], pc, torch.zeros_like(pc))
