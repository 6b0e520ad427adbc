"""Nearest-neighbour association: the CUDA kernel ``csrc/nn_assoc.cu`` (dense
and sorted-stripe), its plain PyTorch versions, and the host-side stripe
logic around it.

Counterpart of ``mm_masking_tpu.ops.pallas.nn_assoc``. Both kernels there
(dense ``_nn_kernel`` and stripe ``_nn_stripe_kernel``) are one CUDA kernel
here, launched by :func:`nn_argmin` (dense) and :func:`nn_stripe`. Results
are first-occurrence argmins of the exact ``(p − q)²`` distance; no gradient
is taken through them.

The sorted stripe: the map is sorted once per solve along its widest planar
axis; a tile of scan rows grouped by that key only needs the contiguous run
of map points whose key lies within the tile's key span ± trim. Each tile
scans that run, rounded out to blocks of ``tm``; if any tile needs more
blocks than the static budget ``window // tm + 1``, every tile scans the
whole map, which gives the dense result. That choice is a select on the
device, so the dispatcher reads nothing back to the host. Within trim the
result equals the dense one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mm_masking_tpu_torch.ops.kernels._build import launch, use_kernel

NN_ROWS = 256  # scan rows per block of the dense launch
_PLAIN_ELEMS = 1 << 27  # distance-tile elements per step of the plain versions


def map_layout(q: torch.Tensor) -> torch.Tensor:
    """(B, M, ≥3) map → (B, M, 4) float32 rows (x, y, z, 0), the kernel's
    layout. Build it once for a map reused across ICP iterations."""
    return F.pad(q[..., :3].float(), (0, 1)).contiguous()


def _sq_dist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(…, R, 3) × (…, C, 3) → (…, R, C) as dx*dx + dy*dy + dz*dz, the kernel's
    order of operations (bit-identical d2)."""
    dx = p[..., :, None, 0] - q[..., None, :, 0]
    dy = p[..., :, None, 1] - q[..., None, :, 1]
    dz = p[..., :, None, 2] - q[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


def nn_argmin_plain(p: torch.Tensor, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain dense version: running (min, first argmin) over map chunks."""
    B, N, _ = p.shape
    M = q.shape[1]
    chunk = max(1, min(M, _PLAIN_ELEMS // max(1, B * N)))
    best = torch.full((B, N), float("inf"), dtype=torch.float32, device=p.device)
    best_idx = torch.zeros((B, N), dtype=torch.int64, device=p.device)
    for k0 in range(0, M, chunk):
        d = _sq_dist(p, q[:, k0:k0 + chunk, :3])
        d = torch.where(torch.isnan(d), float("inf"), d)
        arg = d.argmin(dim=2)
        local = d.gather(2, arg[..., None])[..., 0]
        better = local < best
        best = torch.where(better, local, best)
        best_idx = torch.where(better, arg + k0, best_idx)
    return best_idx.to(torch.int32), best


def _check_points(p: torch.Tensor, q4: torch.Tensor) -> None:
    if p.ndim != 3 or p.shape[-1] != 3 or p.dtype != torch.float32 or not p.is_contiguous():
        raise ValueError(f"p must be contiguous float32 (B, N, 3), got "
                         f"{tuple(p.shape)} {p.dtype}")
    if (q4.ndim != 3 or q4.shape[0] != p.shape[0] or q4.shape[-1] != 4
            or q4.dtype != torch.float32 or not q4.is_contiguous()):
        raise ValueError(f"q4 must be map_layout(q) of shape (B, M, 4), got "
                         f"{tuple(q4.shape)} {q4.dtype}")


def nn_argmin(p: torch.Tensor, q: torch.Tensor, q4: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense NN. p (B, N, 3), q (B, M, ≥3) → (idx (B, N) int32, d2 (B, N)).

    ``q4``: optional precomputed :func:`map_layout` of q (CUDA only).
    """
    if not use_kernel(p, q):
        return nn_argmin_plain(p, q[..., :3])
    q4 = map_layout(q) if q4 is None else q4
    _check_points(p, q4)
    B, N, _ = p.shape
    M = q4.shape[1]
    idx = torch.empty((B, N), dtype=torch.int32, device=p.device)
    d2 = torch.empty((B, N), dtype=torch.float32, device=p.device)
    launch("mm_nn_argmin", p.device, p.data_ptr(), q4.data_ptr(), None, None,
           B, N, M, NN_ROWS, M, idx.data_ptr(), d2.data_ptr())
    nn_argmin.launches += 1
    return idx, d2


nn_argmin.launches = 0


def nn_stripe_plain(p: torch.Tensor, q: torch.Tensor, start_blk: torch.Tensor,
                    nblk: torch.Tensor, tm: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain stripe version: each (item, tile) scans map points
    [start·tm, (start + nblk)·tm) ∩ [0, M). Items of tiles with nblk = 0
    get idx = start·tm, d2 = inf (the kernel leaves them unwritten)."""
    B, N, _ = p.shape
    T = start_blk.shape[1]
    rows = N // T
    M = q.shape[1]
    width = max(1, int(nblk.max())) * tm
    offs = torch.arange(width, device=p.device)
    cols = start_blk.long()[..., None] * tm + offs  # (B, T, width)
    valid = (offs < nblk.long()[..., None] * tm) & (cols < M)
    cols = cols.clamp(max=M - 1)
    pt = p.reshape(B, T, rows, 3)
    idx = torch.empty((B, T, rows), dtype=torch.int64, device=p.device)
    d2 = torch.empty((B, T, rows), dtype=torch.float32, device=p.device)
    step = max(1, _PLAIN_ELEMS // (T * rows * width))
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        nb = cols[sl].shape[0]
        qw = torch.gather(
            q[sl, :, :3], 1, cols[sl].reshape(nb, T * width, 1).expand(-1, -1, 3)
        ).reshape(nb, T, width, 3)
        d = _sq_dist(pt[sl], qw)
        d = torch.where(valid[sl, :, None, :] & ~torch.isnan(d), d, float("inf"))
        arg = d.argmin(dim=3)
        d2[sl] = d.gather(3, arg[..., None])[..., 0]
        idx[sl] = cols[sl].gather(2, arg)
    return idx.reshape(B, N).to(torch.int32), d2.reshape(B, N)


def nn_stripe(p: torch.Tensor, q: torch.Tensor, start_blk: torch.Tensor,
              nblk: torch.Tensor, tm: int, q4: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stripe NN over a sorted map. p (B, T·rows, 3) grouped in tiles of
    ``rows`` rows; start_blk, nblk (B, T) int32 in blocks of ``tm`` map points.
    Rows of tiles with ``nblk == 0`` are left unwritten by the kernel: the
    caller keeps its own values for them.
    """
    if start_blk.shape != nblk.shape or start_blk.shape[0] != p.shape[0]:
        raise ValueError(f"start_blk {tuple(start_blk.shape)} / nblk "
                         f"{tuple(nblk.shape)} do not fit p {tuple(p.shape)}")
    B, N, _ = p.shape
    T = start_blk.shape[1]
    if N % T:
        raise ValueError(f"N={N} is not a whole number of {T} tiles")
    if not use_kernel(p, q, start_blk, nblk):
        return nn_stripe_plain(p, q, start_blk, nblk, tm)
    q4 = map_layout(q) if q4 is None else q4
    _check_points(p, q4)
    rows = N // T
    if rows > 1024:
        raise ValueError(f"tile of {rows} rows exceeds one block (1024 threads)")
    for t in (start_blk, nblk):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("start_blk and nblk must be contiguous int32")
    idx = torch.empty((B, N), dtype=torch.int32, device=p.device)
    d2 = torch.empty((B, N), dtype=torch.float32, device=p.device)
    launch("mm_nn_argmin", p.device, p.data_ptr(), q4.data_ptr(), start_blk.data_ptr(),
           nblk.data_ptr(), B, N, q4.shape[1], rows, tm, idx.data_ptr(), d2.data_ptr())
    nn_stripe.launches += 1
    return idx, d2


nn_stripe.launches = 0


def stripe_sort_target(
    q_full: torch.Tensor, pad_val: float = 1000.0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort map rows (B, M, C≥3) by their widest-spread planar coordinate.

    Returns (q_sorted (B, M, C), key_sorted (B, M), use_x (B,) bool). The
    span is taken over real rows only (pad rows sit at ``pad_val``); the
    sort is stable, as ``jnp.argsort`` is, so equal keys keep their order.
    """
    real = ~((q_full[..., 0] == pad_val) & (q_full[..., 1] == pad_val))
    xy = q_full[..., :2]
    ok = real[..., None] & ~torch.isnan(xy)
    span = (torch.where(ok, xy, float("-inf")).amax(1)
            - torch.where(ok, xy, float("inf")).amin(1))
    span = torch.where(ok.any(1), span, 0.0)
    use_x = span[:, 0] >= span[:, 1]
    key = torch.where(use_x[:, None], q_full[..., 0], q_full[..., 1])
    order = torch.argsort(key, dim=1, stable=True)
    q_sorted = torch.gather(q_full, 1, order[..., None].expand(-1, -1, q_full.shape[-1]))
    return q_sorted, torch.gather(key, 1, order), use_x


def stripe_blocks(p: torch.Tensor, key_sorted: torch.Tensor, use_x: torch.Tensor,
                  trim_dist: float, tn: int, tm: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (start_blk, nblk) (B, T) int32 covering each tile's key span
    ± trim in blocks of tm. p (B, T·tn, 3) in its row grouping."""
    B, Np, _ = p.shape
    T = Np // tn
    M = key_sorted.shape[1]
    key_t = torch.where(use_x[:, None], p[..., 0], p[..., 1]).reshape(B, T, tn)
    finite = torch.isfinite(key_t)
    lo = torch.where(finite, key_t, float("inf")).amin(2) - trim_dist
    hi = torch.where(finite, key_t, float("-inf")).amax(2) + trim_dist
    start_needed = torch.searchsorted(key_sorted, lo.contiguous(), side="left")
    end_needed = torch.searchsorted(key_sorted, hi.contiguous(), side="left")
    # clamp: a span beyond every key would start at block M/tm.
    start_blk = (start_needed // tm).clamp(0, M // tm - 1)
    end_blk = (end_needed + tm - 1) // tm
    nblk = torch.where(lo <= hi, end_blk - start_blk, 1).clamp(min=1)
    return start_blk.to(torch.int32), nblk.to(torch.int32)


def nn_argmin_stripe_presorted(
    p: torch.Tensor,
    q_sorted: torch.Tensor,
    key_sorted: torch.Tensor,
    use_x: torch.Tensor,
    trim_dist: float,
    window: int | None = None,
    tn: int = 256,
    q4: torch.Tensor | None = None,
    refresh: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stripe NN for scan rows grouped by key. Returns (idx (B, N) into the
    SORTED map, d2 (B, N)) in p's row order.

    refresh: optional (B,) bool; items with False do no association at all
    (nblk 0) and their idx/d2 are garbage — the caller keeps its cached
    values. q4: optional :func:`map_layout` of q_sorted, hoisted out of the
    solver loop. Where no block size tm ∈ {1024, 512, 256, 128} divides both
    M and the window, the call runs dense (K1); otherwise it launches the
    stripe kernel (K4), over the whole map when a tile is over budget.
    """
    B, N, _ = p.shape
    M = q_sorted.shape[1]
    q3 = q_sorted[..., :3]
    if window is None:
        window = max(512, M // 4)
    window = min(window, M)
    tn = min(tn, N)
    n_pad = -N % tn
    tm = next((t for t in (1024, 512, 256, 128) if M % t == 0 and window % t == 0),
              None)
    if window >= M or N + n_pad <= tn or tm is None:
        return nn_argmin(p, q3, q4)
    if n_pad:
        # Repeat the last row: its key matches the last tile's, so the
        # window is unaffected (zero rows would inject key 0).
        p = torch.cat([p, p[:, -1:].expand(B, n_pad, 3)], dim=1)
    start_blk, nblk = stripe_blocks(p, key_sorted, use_x, trim_dist, tn, tm)
    # The reference's lax.cond, as a select on the device: when any tile of
    # an item that searches needs more blocks than the budget, every tile
    # scans the whole sorted map from block 0, which is the dense result.
    # +1: a block-aligned cover of a run of `window` points can straddle a
    # block boundary at both ends.
    over = nblk > window // tm + 1
    if refresh is not None:
        over &= refresh[:, None]
    over = over.any()
    start_blk = torch.where(over, 0, start_blk)
    nblk = torch.where(over, M // tm, nblk)
    if refresh is not None:
        nblk = torch.where(refresh[:, None], nblk, 0)
    idx, d2 = nn_stripe(p, q3, start_blk.to(torch.int32), nblk.to(torch.int32), tm, q4)
    return idx[:, :N], d2[:, :N]
