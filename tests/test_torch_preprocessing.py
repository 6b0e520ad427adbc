"""The port's point-cloud preprocessing vs the JAX package's on the CPU, on
the same numpy inputs at the JAX tests' sizes (``tests/test_preprocessing.py``).

``knn_indices``: on integer lattices, where every distance is exact in any
order of summation and ties abound, the indices equal JAX's (ties to the
lower index, as ``jax.lax.top_k``) and a float64 stable sort's.
``estimate_normals``: within 1e-5, sign included, on well-conditioned
surfaces. ``voxel_downsample``: means within 1e-6 and the same row order
(and cell weights), with and without ``center`` and ``weights``, including
negative and large cell keys whose int32 hash products wrap.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.ops import preprocessing as jpre
from mm_masking_tpu_torch.ops import preprocessing as pre


def lattice(seed, B=2, N=100, span=3):
    """Integer points on a small lattice, with repeats: many exact ties."""
    rng = np.random.default_rng(seed)
    return rng.integers(-span, span + 1, (B, N, 3)).astype(np.float32)


@pytest.mark.parametrize("chunk", [32, 1024])
def test_knn_indices_ties_match_jax(chunk):
    pts = lattice(0)
    want = np.asarray(jpre.knn_indices(jnp.asarray(pts), k=7, chunk=chunk))
    got = pre.knn_indices(torch.from_numpy(pts), k=7, chunk=chunk).numpy()
    np.testing.assert_array_equal(got, want)
    # The same as a float64 stable sort: ascending distance, then index.
    d2 = ((pts[:, :, None].astype(np.float64) - pts[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got, np.argsort(d2, axis=-1, kind="stable")[..., :7])


def test_knn_indices_fewer_points_than_k_match_jax():
    pts = lattice(1, B=1, N=5)
    want = np.asarray(jpre.knn_indices(jnp.asarray(pts), k=8, chunk=4))
    got = pre.knn_indices(torch.from_numpy(pts), k=8, chunk=4).numpy()
    np.testing.assert_array_equal(got, want)


def test_sym_eigh_3x3_matches_jax():
    rng = np.random.default_rng(1)
    M = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = M @ M.transpose(0, 2, 1)
    jv, jw = jpre._sym_eigh_3x3(jnp.asarray(A))
    v, w = pre._sym_eigh_3x3(torch.from_numpy(A))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-4)
    # Eigenvectors up to sign: the closed form's null vectors agree to ~1e-4 here.
    np.testing.assert_allclose(np.abs(w.numpy()), np.abs(np.asarray(jw)), rtol=0, atol=1e-3)


def surfaces(seed=2):
    """An offset plane and a tilted plane: normals well separated from the
    other eigenvectors."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((2, 200, 3), np.float32)
    pts[:, :, :2] = rng.uniform(-5, 5, (2, 200, 2))
    pts[0, :, 2] = 1.0 + rng.normal(0, 0.01, 200)
    pts[1, :, 2] = -2.0 + 0.3 * pts[1, :, 0] + rng.normal(0, 0.01, 200)
    return pts


@pytest.mark.parametrize("orient", [True, False])
def test_estimate_normals_match_jax(orient):
    pts = surfaces()
    jn, js = jax.jit(jpre.estimate_normals, static_argnames=("k", "orient_to_origin", "chunk"))(
        jnp.asarray(pts), k=10, orient_to_origin=orient, chunk=64)
    n, s = pre.estimate_normals(torch.from_numpy(pts), k=10, orient_to_origin=orient, chunk=64)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), rtol=0, atol=1e-5)
    for key in ("linearity", "planarity", "sphericity"):
        np.testing.assert_allclose(s[key].numpy(), np.asarray(js[key]), rtol=0, atol=1e-4)
    if orient:  # toward the sensor at the origin
        assert ((n * torch.from_numpy(pts)).sum(-1) <= 0).all()


def cloud(seed, n=500, scale=4.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (n, 3)) + offset).astype(np.float32)


def held(got, want):
    """Means within 1e-6 (of their magnitude) in the same row order; cell
    weights equal."""
    if isinstance(want, tuple):
        (got, gw), (want, ww) = got, want
        np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


VOXEL_CASES = {
    "plain": dict(voxel=1.0, max_out=128),
    "overflow": dict(voxel=0.5, max_out=40),
    "negative_keys_wrap": dict(voxel=0.05, max_out=256, offset=-300.0),
    "large_keys_wrap": dict(voxel=0.01, max_out=512, offset=120.0),
}


@pytest.mark.parametrize("case", sorted(VOXEL_CASES))
@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_voxel_downsample_matches_jax(case, center, weighted):
    kw = dict(VOXEL_CASES[case])
    pts = cloud(4, offset=kw.pop("offset", 0.0))
    if case == "negative_keys_wrap":  # a map buffer: some rows at the far sentinel
        pts[::7] = 1000.0
    extra = {}
    if center:
        extra["center"] = pts[3] + np.float32(0.25)
    if weighted:
        extra["weights"] = np.random.default_rng(5).integers(0, 4, pts.shape[0]).astype(np.float32)
    want = jpre.voxel_downsample(jnp.asarray(pts), pad_val=1000.0,
                                 **{k: jnp.asarray(v) for k, v in extra.items()}, **kw)
    got = pre.voxel_downsample(torch.from_numpy(pts), pad_val=1000.0,
                               **{k: torch.from_numpy(np.asarray(v)) for k, v in extra.items()},
                               **kw)
    held(got, want)


def test_cell_hash_matches_the_jitted_hash():
    """Inside its jit the JAX package's ``floor(p / voxel)`` runs as a
    multiplication by the float32 reciprocal; the port's hash is the jitted
    one on points that straddle cell edges."""
    def jhash(p, voxel):
        k = jnp.floor(p / voxel).astype(jnp.int32)
        return (k[:, 0] * 73856093 ^ k[:, 1] * 19349663 ^ k[:, 2] * 83492791).astype(jnp.uint32)

    pts = np.random.default_rng(6).uniform(-300, 300, (20000, 3)).astype(np.float32)
    for voxel in (0.3, 0.05, 0.0267):
        want = np.asarray(jax.jit(jhash, static_argnums=1)(jnp.asarray(pts), voxel))
        got = pre._cell_hash(torch.from_numpy(pts), voxel).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_cell_hash_wraps_like_int32():
    """Keys whose products leave int32: the hash equals numpy's wrapping
    int32 arithmetic read as uint32."""
    pts = np.array([[-1e4, 3e3, -7e3], [2e4, -2e4, 1.5e4], [-0.3, -0.2, 0.1]], np.float32)
    keys = np.floor(pts * (np.float32(1) / np.float32(0.5))).astype(np.int32)
    with np.errstate(over="ignore"):
        want = ((keys[:, 0] * np.int32(73856093)) ^ (keys[:, 1] * np.int32(19349663))
                ^ (keys[:, 2] * np.int32(83492791))).astype(np.uint32)
    got = pre._cell_hash(torch.from_numpy(pts), 0.5).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
