"""Keypoint descriptors and Hamming matching for the RANSAC bootstrap.

Counterpart of ``mm_masking_tpu.ops.descriptors`` (the descriptor front end
of vtr ``radar.mcransac``): ORB, steered BRIEF with the intensity-centroid
orientation and a fixed 256-pair pattern, and BASD, comparisons of the mean
intensity of concentric rings, both from bilinear samples of the cartesian
image at the extracted keypoints; then Hamming nearest neighbours with the
NNDR ratio test and the mutual-best check.

The public descriptors are the JAX package's words: 32 bits a word, bit j of
word k is bit 32·k + j, as ``uint32`` values held in ``int64``. Matching
unpacks them to ±1 vectors and takes the Hamming matrix as one float32
product (TF32 off): with at most 256 bits every sum is an integer the
product represents exactly, and no (N, N, words) XOR tensor is formed.
Invalid keypoints (x = y = 0 pads) get all-zero words and match nothing.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mm_masking_tpu_torch.ops.radar import point_to_cart_idx


def _bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img (H, W) at rows u and columns v (zero padded)."""
    H, W = img.shape
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    u0i, v0i = u0.to(torch.int64), v0.to(torch.int64)

    def at(ui, vi):
        inside = (ui >= 0) & (ui < H) & (vi >= 0) & (vi < W)
        val = img[ui.clamp(0, H - 1), vi.clamp(0, W - 1)]
        return torch.where(inside, val, 0.0)

    return (at(u0i, v0i) * (1 - du) * (1 - dv) + at(u0i, v0i + 1) * (1 - du) * dv
            + at(u0i + 1, v0i) * du * (1 - dv) + at(u0i + 1, v0i + 1) * du * dv)


def points_to_pixels(pts: torch.Tensor, cart_resolution: float, cart_pixel_width: int):
    """Metric points → (row u, column v) on the cartesian image, by
    :func:`~mm_masking_tpu_torch.ops.radar.point_to_cart_idx`."""
    uv = point_to_cart_idx(pts, cart_resolution, cart_pixel_width)
    return uv[..., 0], uv[..., 1]


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(…, 32·W) bool → (…, W) words, uint32 values in int64."""
    b = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    return (b << torch.arange(32, device=bits.device)).sum(-1)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(…, W) words → (…, 32·W) bool, the inverse of the packing."""
    bits = (words[..., None] >> torch.arange(32, device=words.device)) & 1
    return bits.reshape(*words.shape[:-1], -1).bool()


@functools.lru_cache(maxsize=8)
def _brief_pattern(patch_size: int, n_pairs: int = 256, seed: int = 42):
    """The fixed BRIEF pairs (n_pairs, 2, 2), pixel offsets drawn Gaussian
    (σ = patch/5) and clipped to the patch radius."""
    rng = np.random.default_rng(seed)
    r = patch_size / 2.0
    pat = rng.normal(0.0, patch_size / 5.0, size=(n_pairs, 2, 2))
    return np.clip(pat, -r, r).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _patch_grid(patch_size: int):
    """The circular patch's (row, col) offsets (K, 2) for the moments."""
    r = patch_size // 2
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    keep = (yy**2 + xx**2) <= r * r
    return np.stack([yy[keep], xx[keep]], axis=-1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    patch_size: int = 31
    n_pairs: int = 256
    nndr: float = 1.0  # 1.0 = ratio test off


def _valid(pts: torch.Tensor) -> torch.Tensor:
    return ~((pts[..., 0] == 0.0) & (pts[..., 1] == 0.0))


def orb_bits(img: torch.Tensor, pts: torch.Tensor, cart_resolution: float,
             cfg: OrbConfig = OrbConfig()) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ORB comparisons: (bits (N, n_pairs) bool, a, b (N, n_pairs) the
    two samples each bit compares, a < b). Pad rows' bits are False."""
    u, v = points_to_pixels(pts, cart_resolution, img.shape[0])
    grid = torch.as_tensor(_patch_grid(cfg.patch_size), device=img.device)
    pat = torch.as_tensor(_brief_pattern(cfg.patch_size, cfg.n_pairs), device=img.device)
    inten = _bilinear(img, u[:, None] + grid[:, 0], v[:, None] + grid[:, 1])  # (N, K)
    theta = torch.atan2((inten * grid[:, 0]).sum(-1), (inten * grid[:, 1]).sum(-1))
    c, s = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    # The pattern turned with the content: (dr', dc') = (c·dr + s·dc, −s·dr + c·dc).
    rot_r = pat[..., 0] * c + pat[..., 1] * s  # (N, P, 2)
    rot_c = -pat[..., 0] * s + pat[..., 1] * c
    a = _bilinear(img, u[:, None] + rot_r[..., 0], v[:, None] + rot_c[..., 0])
    b = _bilinear(img, u[:, None] + rot_r[..., 1], v[:, None] + rot_c[..., 1])
    return (a < b) & _valid(pts)[:, None], a, b


def orb_descriptors(img: torch.Tensor, pts: torch.Tensor, cart_resolution: float,
                    cfg: OrbConfig = OrbConfig()) -> torch.Tensor:
    """Steered-BRIEF descriptors of img (H, W) at metric points (N, 3) →
    (N, n_pairs / 32) words (uint32 values in int64)."""
    return _pack_bits(orb_bits(img, pts, cart_resolution, cfg)[0])


@dataclasses.dataclass(frozen=True)
class BasdConfig:
    nbins: int = 16
    bin_size: float = 1.0  # ring width in pixels
    samples_per_ring: int = 32


@functools.lru_cache(maxsize=8)
def _ring_offsets(nbins: int, bin_size: float, samples: int):
    """(nbins, samples, 2) row/col offsets of the rings' sample circles."""
    ang = np.linspace(0.0, 2 * np.pi, samples, endpoint=False)
    radii = (np.arange(nbins) + 0.5) * bin_size
    off = np.stack([radii[:, None] * np.sin(ang)[None, :],
                    radii[:, None] * np.cos(ang)[None, :]], axis=-1)
    return off.astype(np.float32)


def basd_ring_means(img: torch.Tensor, pts: torch.Tensor, cart_resolution: float,
                    cfg: BasdConfig = BasdConfig()) -> torch.Tensor:
    """(N, nbins) mean intensity of each ring around each keypoint."""
    u, v = points_to_pixels(pts, cart_resolution, img.shape[0])
    off = torch.as_tensor(_ring_offsets(cfg.nbins, cfg.bin_size, cfg.samples_per_ring),
                          device=img.device).reshape(-1, 2)
    vals = _bilinear(img, u[:, None] + off[:, 0], v[:, None] + off[:, 1])
    return vals.reshape(-1, cfg.nbins, cfg.samples_per_ring).mean(-1)


def basd_descriptors(img: torch.Tensor, pts: torch.Tensor, cart_resolution: float,
                     cfg: BasdConfig = BasdConfig()) -> torch.Tensor:
    """Annular-statistics descriptors: adjacent rings' means compared
    (nbins − 1 bits) and each ring against the patch mean (nbins), padded to
    whole words → (N, ceil(bits / 32)) words."""
    ring = basd_ring_means(img, pts, cart_resolution, cfg)
    bits = torch.cat([ring[:, :-1] < ring[:, 1:], ring > ring.mean(-1, keepdim=True)], dim=1)
    bits = torch.nn.functional.pad(bits, (0, (-bits.shape[1]) % 32))
    return _pack_bits(bits & _valid(pts)[:, None])


def hamming(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(Na, Nb) int32 Hamming distances of packed words (Na, W), (Nb, W):
    (bits − a·b) / 2 of the ±1 vectors, one exact float32 product."""
    sa = unpack_bits(desc_a).to(torch.float32) * 2.0 - 1.0
    sb = unpack_bits(desc_b).to(torch.float32) * 2.0 - 1.0
    return torch.round((sa.shape[-1] - sa @ sb.T) * 0.5).to(torch.int32)


def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor, valid_a: torch.Tensor,
                      valid_b: torch.Tensor, nndr: float = 1.0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hamming NN matching a → b with the ratio (d1 ≤ nndr·d2; 1.0 disables)
    and mutual-best tests: (idx_b (Na,) int32, ok (Na,) bool). Ties take the
    first index, as ``jnp.argmin``."""
    big = 1 << 20
    d = torch.where(valid_a[:, None] & valid_b[None, :], hamming(desc_a, desc_b), big)
    d1, idx_b = d.amin(dim=1), d.argmin(dim=1)
    d2 = d.scatter(1, idx_b[:, None], big).amin(dim=1)
    ratio_ok = d1.to(torch.float32) <= nndr * d2.to(torch.float32)
    back = d.argmin(dim=0)
    mutual = back[idx_b] == torch.arange(d.shape[0], device=d.device)
    ok = valid_a & (d1 < big) & ratio_ok & mutual
    return idx_b.to(torch.int32), ok
