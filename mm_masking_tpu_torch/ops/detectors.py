"""Navtech radar detectors (kstrongest, cen2018, cacfar, oscfar,
modified_cacfar), the Doppler range correction and the constant-velocity
motion un-distortion.

Counterpart of ``mm_masking_tpu.ops.detectors``. Every detector maps a
(B, A, R) polar power tensor to a {0, 1} detection mask of the same shape
that feeds :func:`mm_masking_tpu_torch.ops.cfar.extract_pc`. Window sums
come from one cumulative sum along range; OS-CFAR's k-th order statistic is
the k-th smallest value of the gathered train window.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mm_masking_tpu_torch.ops.cfar import cfar_mask


def _range_band_mask(R: int, res: float, minr: float, maxr: float, dtype,
                     device=None) -> torch.Tensor:
    rng = torch.arange(R, dtype=dtype, device=device) * res
    return ((rng >= minr) & (rng <= maxr)).to(dtype)


def _window_sums(x: torch.Tensor, w2: int, guard: int):
    """(left_sum, right_sum, n_left, n_right) of the train window around each
    bin: left [i − w2 − guard, i − guard), right (i + guard, i + w2 + guard];
    the parts outside the scan are clipped (partial windows at the edges)."""
    R = x.shape[-1]
    csum = torch.cat([x.new_zeros(x.shape[:-1] + (1,)), torch.cumsum(x, dim=-1)], dim=-1)
    idx = torch.arange(R, device=x.device)

    def seg(lo, hi):
        lo, hi = lo.clamp(0, R), hi.clamp(0, R)
        return csum[..., hi] - csum[..., lo], (hi - lo).to(x.dtype)

    left, n_left = seg(idx - w2 - guard, idx - guard)
    right, n_right = seg(idx + guard + 1, idx + w2 + guard + 1)
    return left, right, n_left, n_right


def kstrongest(raw: torch.Tensor, res: float, kstrong: int = 12, threshold2: float = 0.0,
               threshold3: float = 0.216, minr: float = 2.0, maxr: float = 80.0) -> torch.Tensor:
    """Keep the k strongest bins per azimuth above ``t2·mean + t3``."""
    band = _range_band_mask(raw.shape[-1], res, minr, maxr, raw.dtype, raw.device)
    x = raw * band
    mean = x.sum(-1, keepdim=True) / band.sum().clamp(min=1.0)
    thresh = threshold2 * mean + threshold3
    kth = torch.topk(x, kstrong, dim=-1).values[..., -1:]  # values only: ties do not matter
    return ((x >= torch.maximum(kth, thresh)) & (x > 0)).to(raw.dtype)


def cen2018(raw: torch.Tensor, res: float, zq: float = 2.5, sigma: int = 8,
            minr: float = 2.0, maxr: float = 80.0) -> torch.Tensor:
    """Cen & Newman (ICRA 2018): Gaussian-smooth each azimuth, subtract its
    mean, and mark bins whose deviation exceeds ``zq`` times the noise scale
    (the root mean square of the negative deviations)."""
    B, A, R = raw.shape
    half = 2 * sigma
    t = torch.arange(-half, half + 1, dtype=raw.dtype, device=raw.device)
    g = torch.exp(-0.5 * (t / sigma) ** 2)
    g = g / g.sum()
    # The kernel is symmetric, so the correlation equals np.convolve's "same".
    smoothed = F.conv1d(raw.reshape(B * A, 1, R), g.view(1, 1, -1),
                        padding=half).reshape(B, A, R)
    q = smoothed - smoothed.mean(-1, keepdim=True)
    neg = torch.where(q < 0, q, 0.0)
    n_neg = (q < 0).sum(-1, keepdim=True).clamp(min=1)
    sigma_q = torch.sqrt((neg * neg).sum(-1, keepdim=True) / n_neg)
    band = _range_band_mask(R, res, minr, maxr, raw.dtype, raw.device)
    return ((q > zq * sigma_q) & (band > 0)).to(raw.dtype)


def cacfar(raw: torch.Tensor, res: float, width: int = 41, guard: int = 2,
           threshold: float = 1.0, threshold2: float = 0.0, threshold3: float = 0.08,
           minr: float = 2.0, maxr: float = 80.0) -> torch.Tensor:
    """Cell-averaging CFAR: ``T = t1·Z + t2·mean + t3`` with Z the mean of the
    train cells on both sides of the guard band."""
    width = width + 1 if width % 2 == 0 else width
    left, right, n_l, n_r = _window_sums(raw, width // 2, guard)
    Z = (left + right) / (n_l + n_r).clamp(min=1.0)
    T = threshold * Z + threshold2 * raw.mean(-1, keepdim=True) + threshold3
    band = _range_band_mask(raw.shape[-1], res, minr, maxr, raw.dtype, raw.device)
    return ((raw > T) & (band > 0)).to(raw.dtype)


def oscfar(raw: torch.Tensor, res: float, width: int = 41, guard: int = 0, kstat: int = 20,
           threshold: float = 1.0, threshold2: float = 0.0, threshold3: float = 0.07,
           minr: float = 2.0, maxr: float = 80.0) -> torch.Tensor:
    """Ordered-statistics CFAR: Z = the k-th smallest value of the train
    window (cells outside the scan never enter it)."""
    width = width + 1 if width % 2 == 0 else width
    w2 = width // 2
    R = raw.shape[-1]
    dev = raw.device
    offs = torch.cat([torch.arange(-w2 - guard, -guard, device=dev),
                      torch.arange(guard + 1, w2 + guard + 1, device=dev)])
    idx = torch.arange(R, device=dev)[:, None] + offs[None, :]  # (R, W)
    valid = (idx >= 0) & (idx < R)
    win = torch.where(valid, raw[..., idx.clamp(0, R - 1)], float("inf"))  # (B, A, R, W)
    k = min(max(kstat, 1), offs.shape[0])
    kth = torch.kthvalue(win, k, dim=-1).values
    kth = torch.where(torch.isfinite(kth), kth, 0.0)
    T = threshold * kth + threshold2 * raw.mean(-1, keepdim=True) + threshold3
    band = _range_band_mask(R, res, minr, maxr, raw.dtype, dev)
    return ((raw > T) & (band > 0)).to(raw.dtype)


def modified_cacfar(raw: torch.Tensor, res: float, width: int = 101, guard: int = 5,
                    threshold: float = 1.0, threshold2: float = 0.0, threshold3: float = 0.09,
                    minr: float = 2.0, maxr: float = 80.0) -> torch.Tensor:
    """The greatest-of variant the training pipeline uses: :func:`cfar_mask`
    plus the mean term."""
    mask = cfar_mask(raw, res, width=width, minr=minr, maxr=maxr, guard=guard,
                     a_thresh=threshold, b_thresh=threshold3, diff=False)
    if threshold2 != 0.0:
        mask = mask * (raw > threshold2 * raw.mean(-1, keepdim=True)).to(raw.dtype)
    return mask


DETECTORS = {
    "kstrongest": kstrongest,
    "cen2018": cen2018,
    "cacfar": cacfar,
    "oscfar": oscfar,
    "modified_cacfar": modified_cacfar,
}


def detect(name: str, raw: torch.Tensor, res: float, **kwargs) -> torch.Tensor:
    """Dispatch by detector name."""
    return DETECTORS[name](raw, res, **kwargs)


def doppler_shift(points: torch.Tensor, azimuths: torch.Tensor, velocity: torch.Tensor,
                  beta: float = 0.049) -> torch.Tensor:
    """Doppler range correction for an FMCW radar moving at ``velocity``.

    points (B, N, 3); azimuths (B, N), the ray angle of each point;
    velocity (B, 2), the platform's (vx, vy) in the sensor frame. The range
    shifts by ``beta · v_radial``.
    """
    v_rad = (velocity[:, None, 0] * torch.cos(azimuths)
             + velocity[:, None, 1] * torch.sin(azimuths))
    r = torch.sqrt(((points[..., :2] + 1e-30) ** 2).sum(-1))
    scale = (r + beta * v_rad) / r.clamp(min=1e-9)
    return torch.cat([points[..., :2] * scale[..., None], points[..., 2:]], dim=-1)


def motion_undistort(points: torch.Tensor, times: torch.Tensor, velocity: torch.Tensor,
                     yaw_rate: torch.Tensor, t_ref: torch.Tensor | None = None,
                     time_to_sec: float = 1e-9) -> torch.Tensor:
    """Constant-velocity motion-during-scan un-distortion (planar, exact):
    each point seen at time tᵢ maps into the frame of the reference time by
    ``p₀ = R(ω·dtᵢ) pᵢ + V(ω·dtᵢ)·v·dtᵢ``.

    points (B, N, 3); times (B, N); velocity (B, 2) body (vx, vy);
    yaw_rate (B,) ω in rad/s; t_ref (B,) (default: the earliest time of the
    real points); ``time_to_sec`` scales ``times``. Pad rows (x = y = 0)
    are left as they are.
    """
    valid = ~((points[..., 0] == 0.0) & (points[..., 1] == 0.0))
    if t_ref is None:
        t_ref = torch.where(valid, times, float("inf")).amin(dim=1)
    dt = torch.where(valid, (times - t_ref[:, None]) * time_to_sec, 0.0)
    th = yaw_rate[:, None] * dt
    c, s = torch.cos(th), torch.sin(th)
    x, y = points[..., 0], points[..., 1]
    # V(θ)·v·dt with the SE(2) left Jacobian, series-guarded at ω → 0.
    w = yaw_rate[:, None]
    small = th.abs() < 1e-6
    one = torch.ones_like(w)
    a = torch.where(small, dt * (1.0 - th * th / 6.0), s / torch.where(small, one, w))
    b = torch.where(small, dt * th / 2.0, (1.0 - c) / torch.where(small, one, w))
    tx = a * velocity[:, None, 0] - b * velocity[:, None, 1]
    ty = b * velocity[:, None, 0] + a * velocity[:, None, 1]
    out = torch.stack([c * x - s * y + tx, s * x + c * y + ty, points[..., 2]], dim=-1)
    return torch.where(valid[..., None], out, points)
