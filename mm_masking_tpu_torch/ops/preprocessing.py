"""Point-cloud preprocessing: k nearest neighbours, normals and spectral
scores, voxel-grid downsampling.

Counterpart of ``mm_masking_tpu.ops.preprocessing``, with the same results
bit for bit where the arithmetic allows:

* :func:`knn_indices` forms ``|p|² − 2p·q + |q|²`` in float32 (TF32 is off
  in the package) and keeps the k smallest per row with ties broken by the
  lower index, as ``jax.lax.top_k`` does: a stable sort of the running
  best-k and each chunk's distances (``torch.topk`` promises no tie order);
* normals are the smallest eigenvector of the neighbourhood covariance,
  from a closed-form 3×3 eigen-decomposition, oriented toward the sensor;
* :func:`voxel_downsample` hashes cells with the same wrapping int32
  products, orders them with a stable sort and sums each cell's points in
  that order with a sequential segment sum: no atomics, so the card gives
  the same bits on every run.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def knn_indices(points: torch.Tensor, k: int, chunk: int = 1024) -> torch.Tensor:
    """(B, N, 3) → (B, N, k) int64 indices of the k nearest neighbours (self
    included), ascending by distance, equal distances by index.

    Blocked over map chunks: O(N·N) work, O(N·(chunk + k)) memory. Slots
    that no point fills (N < k) hold index 0, as the JAX package's do.
    """
    B, N, _ = points.shape
    p_sq = (points * points).sum(-1)
    best_d = points.new_full((B, N, k), math.inf)
    best_i = torch.zeros((B, N, k), dtype=torch.int64, device=points.device)
    for s in range(0, N, chunk):
        qc = points[:, s:s + chunk]
        q_sq = (qc * qc).sum(-1)
        cross = torch.einsum("bnd,bmd->bnm", points, qc)
        d2 = p_sq[:, :, None] - 2.0 * cross + q_sq[:, None, :]
        idx = torch.arange(s, s + qc.shape[1], device=points.device).expand_as(d2)
        d_all = torch.cat([best_d, d2], dim=2)
        i_all = torch.cat([best_i, idx], dim=2)
        d_sorted, order = torch.sort(d_all, dim=2, stable=True)
        best_d = d_sorted[..., :k]
        best_i = torch.gather(i_all, 2, order[..., :k])
    return best_i


def _sym_eigh_3x3(A: torch.Tensor):
    """Closed-form eigen-decomposition of batched symmetric 3×3 matrices:
    (eigenvalues ascending (…, 3), eigenvectors as columns (…, 3, 3)), from
    the trigonometric solution and cross products of the rows of A − λI."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt((p2 / 6.0).clamp(min=1e-30))
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = (detB / (2.0 * p ** 3)).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_big = q + 2.0 * p * torch.cos(phi)
    e_small = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_big - e_small
    vals = torch.stack([e_small, e_mid, e_big], dim=-1)

    def null_vec(lam):
        # A − λI has rank 2 generically: its null vector is the cross product
        # of its two most independent rows.
        r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
        c01 = torch.linalg.cross(r0, r1, dim=-1)
        c02 = torch.linalg.cross(r0, r2, dim=-1)
        c12 = torch.linalg.cross(r1, r2, dim=-1)
        n01 = (c01 * c01).sum(-1, keepdim=True)
        n02 = (c02 * c02).sum(-1, keepdim=True)
        n12 = (c12 * c12).sum(-1, keepdim=True)
        best = torch.where((n01 >= n02) & (n01 >= n12), c01,
                           torch.where(n02 >= n12, c02, c12))
        return best / torch.sqrt((best * best).sum(-1, keepdim=True).clamp(min=1e-30))

    v_small = null_vec(e_small)
    v_big = null_vec(e_big)
    v_mid = torch.linalg.cross(v_big, v_small, dim=-1)
    return vals, torch.stack([v_small, v_mid, v_big], dim=-1)


def neighbourhood_pca(points: torch.Tensor, idx: torch.Tensor):
    """Covariance eigen-decomposition of each point's neighbourhood: points
    (B, N, 3), idx (B, N, k) → (eigenvalues (B, N, 3), eigenvectors
    (B, N, 3, 3))."""
    B, N, k = idx.shape
    nbrs = torch.gather(points, 1, idx.reshape(B, N * k, 1).expand(-1, -1, 3)).reshape(B, N, k, 3)
    centered = nbrs - nbrs.mean(dim=2, keepdim=True)
    cov = torch.einsum("bnki,bnkj->bnij", centered, centered) / k
    return _sym_eigh_3x3(cov)


def estimate_normals(points: torch.Tensor, k: int = 10, orient_to_origin: bool = True,
                     chunk: int = 1024):
    """(B, N, 3) → (normals (B, N, 3), scores): linearity (e3 − e2)/e3,
    planarity (e2 − e1)/e3 and sphericity e1/e3, with e1 ≤ e2 ≤ e3."""
    vals, vecs = neighbourhood_pca(points, knn_indices(points, k, chunk=chunk))
    normals = vecs[..., 0]  # the smallest eigenvalue's eigenvector
    if orient_to_origin:
        flip = (normals * points).sum(-1, keepdim=True) > 0
        normals = torch.where(flip, -normals, normals)
    e1, e2, e3 = vals.unbind(-1)
    safe = e3.clamp(min=1e-12)
    return normals, {"linearity": (e3 - e2) / safe, "planarity": (e2 - e1) / safe,
                     "sphericity": e1 / safe}


def _cell_hash(points: torch.Tensor, voxel: float) -> torch.Tensor:
    """The cell hash of each point as the JAX package computes it: int32 cell
    keys times constants, wrapping, XORed and read as uint32 (here the low
    32 bits of int64 products, in an int64 tensor). The keys are
    ``floor(p · (1/voxel))`` with the reciprocal rounded to float32: XLA
    rewrites the division by the constant so inside the JAX package's jit,
    and a point within an ulp of a cell edge lands in the cell that gives."""
    inv = float(np.float32(1.0) / np.float32(voxel))
    keys = torch.floor(points * inv).to(torch.int32).to(torch.int64)
    mask = 0xFFFFFFFF
    return (((keys[:, 0] * 73856093) & mask) ^ ((keys[:, 1] * 19349663) & mask)
            ^ ((keys[:, 2] * 83492791) & mask))


def _cell_sums(pts_w: torch.Tensor, cell_id: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Sum rows of pts_w (N, C), sorted so that each cell is contiguous, into
    (n_cells, C), each cell's rows added one after another in their order
    (the order of the JAX package's scatter-add on the CPU). Empty cells
    sum to 0."""
    lengths = torch.zeros(n_cells, dtype=torch.int64, device=pts_w.device)
    lengths.scatter_add_(0, cell_id, torch.ones_like(cell_id))  # integer: order-free
    return torch.segment_reduce(pts_w, "sum", lengths=lengths, axis=0, unsafe=True)


def voxel_downsample(points: torch.Tensor, voxel: float = 0.5, max_out: int = 4096,
                     pad_val: float = 0.0, center: torch.Tensor | None = None,
                     weights: torch.Tensor | None = None):
    """(N, 3) → (max_out, 3) voxel-grid means; unused rows carry ``pad_val``.

    With more distinct cells than ``max_out``: with ``center`` (a (3,)
    position) the ``max_out`` cells nearest to it survive (the sliding local
    map); without it, cells drop in hash order. Cells of pad rows (|x| ≥ 500)
    and non-finite cells are never kept when ``center`` is given.

    ``weights`` ((N,), optional): per-point observation weights; the cell
    means become weighted means and the result a ``(means, cell_weights
    (max_out,))`` pair, so each merge's output weights can be fed to the
    next merge.
    """
    N = points.shape[0]
    h = _cell_hash(points, voxel)
    order = torch.argsort(h, stable=True)
    h_sorted = h[order]
    w_sorted = points.new_ones((N,)) if weights is None else weights[order]
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=points.device),
                        h_sorted[1:] != h_sorted[:-1]])
    cell_id = torch.cumsum(is_new, 0) - 1  # dense cell index in sorted order
    # One segment sum over the columns [points · w, w], in one order.
    data = torch.cat([points[order] * w_sorted[:, None], w_sorted[:, None]], dim=1)
    if center is None:
        sums = _cell_sums(data, cell_id.clamp(max=max_out), max_out + 1)[:max_out]
        wsum = sums[:, 3]
        means = sums[:, :3] / wsum[:, None].clamp(min=1e-12)
        used = wsum > 0
        means = torch.where(used[:, None], means, pad_val)
        if weights is None:
            return means
        return means, torch.where(used, wsum, 0.0)
    sums = _cell_sums(data, cell_id, N)
    wsum = sums[:, 3]
    means = sums[:, :3] / wsum[:, None].clamp(min=1e-12)
    used = wsum > 0
    # Pad cells (the ±1000 sentinel) and non-finite cells sort past every real one.
    far = (means[:, 0].abs() >= 500.0) | ~torch.isfinite(means).all(-1)
    d = means - center[None, :]
    dist = torch.where(used & ~far, torch.sqrt((d * d).sum(-1)), math.inf)
    pick = torch.argsort(dist, stable=True)[:max_out]
    ok = torch.isfinite(dist[pick])
    means = torch.where(ok[:, None], means[pick], pad_val)
    if weights is None:
        return means
    return means, torch.where(ok, wsum[pick], 0.0)
