"""Greatest-of CFAR along range (counterpart of ``mm_masking_tpu.ops.cfar``)."""
from __future__ import annotations

import torch


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
        return torch.where(soft.abs() > 0.99, soft, torch.zeros_like(soft))
    return (raw_scans > thres_full).to(raw_scans.dtype)
