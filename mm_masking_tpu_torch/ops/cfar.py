"""Greatest-of CFAR along range and peak → point-cloud extraction
(counterpart of ``mm_masking_tpu.ops.cfar``; reference ``radar_utils.py``
``cfar_mask:29-69``, ``extract_pc:71-106``,
``mean_peaks_parallel_fast:167-185``).

Every scan yields exactly ``max_points`` rows, zero-padded: the (0, 0)
padding convention the weight lookup and the ICP already treat as "no
point".
"""
from __future__ import annotations

import torch


def hardshrink(x: torch.Tensor, lambd: float = 0.5) -> torch.Tensor:
    """torch.hardshrink's rule as a select: zero out values with |x| <= lambd."""
    return torch.where(x.abs() > lambd, x, torch.zeros_like(x))


def cfar_mask(
    raw_scans: torch.Tensor,
    res: float,
    width: int = 101,
    minr: float = 2.0,
    maxr: float = 80.0,
    guard: int = 5,
    a_thresh: float = 1.0,
    b_thresh: float = 0.09,
    diff: bool = True,
    steep_fact: float = 10.0,
) -> torch.Tensor:
    """raw_scans (B, A, R) polar power → (B, A, R) mask, soft (tanh +
    hardshrink at 0.99) when ``diff`` else hard {0, 1}.

    Window sums come from one cumulative sum along range. A window reaching
    past the last bin reads NaN, as ``jnp.take`` does out of bounds in the
    reference, so such columns never fire.
    """
    if raw_scans.ndim != 3:
        raise ValueError(f"raw_scans must be (B, A, R), got {tuple(raw_scans.shape)}")
    R = raw_scans.shape[-1]
    width = width + 1 if width % 2 == 0 else width
    w2 = width // 2
    mincol = max(0, int(minr / res + w2 + guard + 1))
    maxcol = min(R, int(maxr / res - w2 - guard))

    csum = torch.cat(
        [raw_scans.new_zeros(raw_scans.shape[:-1] + (1,)), torch.cumsum(raw_scans, -1)],
        dim=-1,
    )
    cols = torch.arange(mincol, maxcol, device=raw_scans.device)

    def take(i):
        v = csum[..., i.clamp(max=R)]
        return torch.where(i <= R, v, torch.full_like(v, float("nan")))

    left = take(cols - guard) - take(cols - w2 - guard)
    right = take(cols + w2 + guard + 1) - take(cols + guard + 1)
    thres = a_thresh * (torch.maximum(left, right) / w2) + b_thresh

    thres_full = torch.full_like(raw_scans, 1000.0)
    thres_full[..., mincol:maxcol] = thres
    if diff:
        soft = 0.5 * torch.tanh(steep_fact * (raw_scans - thres_full) + 2.5) + 0.5
        return hardshrink(soft, 0.99)
    return (raw_scans > thres_full).to(raw_scans.dtype)


def mean_peaks(arr: torch.Tensor, diff: bool, steep_fact: float = 10.0) -> torch.Tensor:
    """Mark the first and last bin of each contiguous nonzero run along range.

    arr (B, A, R): a soft zero detector ``1 − tanh(steep·x)`` (diff) or the
    exact ``x == 0`` gates each bin by its neighbours; the last range bin is
    always zero, so runs never span azimuth rows after flattening.
    """
    if diff:
        zero_detect = 1.0 - torch.tanh(steep_fact * arr)
    else:
        zero_detect = (arr == 0).to(arr.dtype)
    res_forward = arr[..., :-1] * zero_detect[..., 1:]
    res_backward = arr[..., 1:] * zero_detect[..., :-1]
    return torch.cat([res_forward + res_backward, torch.zeros_like(arr[..., :1])], dim=-1)


def extract_pc(
    thres_mask: torch.Tensor,
    res: float,
    azimuth_angles: torch.Tensor,
    azimuth_times: torch.Tensor,
    max_points: int = 4096,
    T_ab: torch.Tensor | None = None,
    diff: bool = True,
    steep_fact: float = 10.0,
    return_times: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Thresholded polar scan (B, A, R) → cartesian point cloud (B,
    max_points, 3).

    Each detection blob contributes its (first, last) edge pair; the blob's
    point is the pair's mean in (range, azimuth, time), ranges being
    ``res · bin`` gated by the mask. Consecutive nonzero entries of the
    flattened (azimuth, range) peak array pair up, with the reference's
    quirk kept: a single-bin blob gives one merged entry and shifts the
    pairing. The entries are ranked by a cumulative sum and scattered into
    2·max_points slots; overflow drops, underflow leaves (0, 0, 0) rows.
    Each channel keeps its dtype through the scatter (integer azimuth
    times stay integers until the mean).
    """
    B, A, R = thres_mask.shape
    rng = torch.arange(R, dtype=thres_mask.dtype, device=thres_mask.device)
    thres_scan = res * rng[None, None, :] * thres_mask
    peak_points = mean_peaks(thres_scan, diff=diff, steep_fact=steep_fact)

    r_flat = peak_points.reshape(B, -1)
    valid = r_flat != 0
    rank = torch.cumsum(valid, dim=1) - 1  # 0-based order among the nonzeros
    slots = 2 * max_points
    idx = torch.where(valid & (rank < slots), rank, slots)  # the rest: a dropped slot

    def scatter_channel(ch: torch.Tensor) -> torch.Tensor:
        buf = torch.zeros((B, slots + 1), dtype=ch.dtype, device=ch.device)
        buf.scatter_(1, idx, torch.where(valid, ch, torch.zeros_like(ch)))
        return buf[:, :slots]

    # Reference pairing: ends = nonzero[0::2], starts = nonzero[1::2].
    chans = (r_flat, azimuth_angles[..., None].expand(B, A, R).reshape(B, -1),
             azimuth_times[..., None].expand(B, A, R).reshape(B, -1))
    bufs = [scatter_channel(ch) for ch in chans]
    avg = torch.stack([(b[:, 1::2] + b[:, 0::2]) / 2.0 for b in bufs], dim=-1)

    pc = pol_2_cart_batched(avg)
    if T_ab is not None:
        pc = torch.einsum("bij,bnj->bni", T_ab[:, :3, :3], pc) + T_ab[:, None, :3, 3]
    if return_times:
        return pc, avg[..., 2]
    return pc


def pol_2_cart_batched(pts: torch.Tensor) -> torch.Tensor:
    """(B, N, ≥2) polar (rho, phi, …) → (B, N, 3) cartesian with z = 0."""
    rho, phi = pts[..., 0], pts[..., 1]
    return torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), torch.zeros_like(rho)],
                       dim=-1)
