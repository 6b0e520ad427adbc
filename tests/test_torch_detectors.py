"""The port's radar detectors, Doppler and motion corrections and lidar
ingestion vs the JAX package's on the CPU, on the same numpy inputs at the
JAX tests' sizes (``tests/test_detectors.py``, ``tests/test_lidar.py``).

The JAX functions run jitted where they can, as their callers run them. Detection masks:
the window statistics are float32 sums whose order
differs between XLA and torch, so a bin may flip only where its value lies
within 1e-5 · max |x| of the threshold (computed here in float64); OS-CFAR
and k-strongest compare values only and must match exactly. The
corrections are held at 1e-6 m. The lidar chain selects the same voxel
means, bit for bit, with normals within 1e-4 on 99% of the rows
(``assert_normals_close`` says why not all); the order among scores an
ulp apart is not held.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.ops import detectors as jdet
from mm_masking_tpu.ops import lidar as jlidar
from mm_masking_tpu_torch.ops import detectors, lidar

RES = 0.0596


def scan_with_targets(seed=0, B=1, A=8, R=600, n_targets=6, amp=3.0):
    """The JAX tests' scan: a noise floor with bright planted bins."""
    rng = np.random.default_rng(seed)
    raw = (0.08 * rng.random((B, A, R))).astype(np.float32)
    for b in range(B):
        for a in range(A):
            raw[b, a, rng.integers(80, R - 80, n_targets)] = amp
    return raw


def band(R, minr, maxr):
    rng = np.arange(R) * RES
    return (rng >= minr) & (rng <= maxr)


def windows64(raw, w2, guard):
    """float64 (left, right, n_left, n_right) train-window sums, clipped."""
    R = raw.shape[-1]
    csum = np.concatenate([np.zeros(raw.shape[:-1] + (1,)), np.cumsum(raw.astype(np.float64), -1)],
                          -1)
    i = np.arange(R)
    lo_l, hi_l = np.clip(i - w2 - guard, 0, R), np.clip(i - guard, 0, R)
    lo_r, hi_r = np.clip(i + guard + 1, 0, R), np.clip(i + w2 + guard + 1, 0, R)
    return (csum[..., hi_l] - csum[..., lo_l], csum[..., hi_r] - csum[..., lo_r],
            hi_l - lo_l, hi_r - lo_r)


def kstrongest_stat(raw, kstrong=8, threshold3=0.2, minr=2.0, maxr=35.0):
    x = raw.astype(np.float64) * band(raw.shape[-1], minr, maxr)
    kth = -np.sort(-x, -1)[..., kstrong - 1:kstrong]
    return x, np.maximum(kth, threshold3)


def cen2018_stat(raw, zq=4.0, sigma=3, minr=2.0, maxr=35.0):
    t = np.arange(-2 * sigma, 2 * sigma + 1, dtype=np.float64)
    g = np.exp(-0.5 * (t / sigma) ** 2)
    g /= g.sum()
    sm = np.apply_along_axis(lambda row: np.convolve(row, g, mode="same"), -1,
                             raw.astype(np.float64))
    q = sm - sm.mean(-1, keepdims=True)
    neg = np.where(q < 0, q, 0.0)
    sig = np.sqrt((neg * neg).sum(-1, keepdims=True) / np.maximum((q < 0).sum(-1, keepdims=True), 1))
    return q, zq * sig + 0 * q


def cacfar_stat(raw, width=21, guard=2, threshold3=0.08):
    left, right, nl, nr = windows64(raw, width // 2, guard)
    return raw.astype(np.float64), (left + right) / np.maximum(nl + nr, 1) + threshold3


def modified_stat(raw, width=101, guard=5, threshold3=0.09, minr=2.0, maxr=80.0):
    """cfar_mask's greatest-of threshold, 1000 outside its columns."""
    R = raw.shape[-1]
    w2 = width // 2
    left, right, _, _ = windows64(raw, w2, guard)
    T = np.maximum(left, right) / w2 + threshold3
    cols = np.arange(R)
    inside = (cols >= int(minr / RES + w2 + guard + 1)) & (cols < int(maxr / RES - w2 - guard))
    return raw.astype(np.float64), np.where(inside, T, 1000.0)


CASES = {
    "kstrongest": (dict(kstrong=8, threshold3=0.2, minr=2.0, maxr=35.0), 0, kstrongest_stat),
    "cen2018": (dict(zq=4.0, sigma=3, minr=2.0, maxr=35.0), 1, cen2018_stat),
    "cacfar": (dict(width=21, guard=2, threshold3=0.08, minr=0.5, maxr=10.0), 2,
               lambda r: cacfar_stat(r, 21, 2, 0.08)),
    "oscfar": (dict(width=21, guard=1, kstat=10, threshold3=0.05, minr=0.5, maxr=30.0), 3, None),
    "modified_cacfar": (dict(width=41, guard=3, threshold3=0.09, minr=2.0, maxr=30.0), 4,
                        lambda r: modified_stat(r, 41, 3, 0.09, 2.0, 30.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_detector_matches_jax(name):
    kwargs, seed, stat = CASES[name]
    raw = scan_with_targets(seed=seed, B=2)
    ref = functools.partial(jdet.DETECTORS[name], res=RES, **kwargs)
    if name != "oscfar":  # its k-th statistic needs a concrete k: JAX runs it eagerly
        ref = jax.jit(ref)
    want = np.asarray(ref(jnp.asarray(raw)))
    got = detectors.detect(name, torch.from_numpy(raw), RES, **kwargs).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert want.sum() > 0
    flips = got != want
    if stat is None:  # a k-th value: compared as values, so exact
        assert not flips.any()
        return
    x, thr = stat(raw)
    near = np.abs(x - thr) <= 1e-5 * np.abs(x).max()
    assert not (flips & ~near).any(), np.argwhere(flips & ~near)[:5]


def test_window_sums_match_jax():
    raw = scan_with_targets(seed=5, A=3, R=200)
    want = jdet._window_sums(jnp.asarray(raw), 10, 2)
    got = detectors._window_sums(torch.from_numpy(raw), 10, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_doppler_shift_matches_jax():
    rng = np.random.default_rng(6)
    pts = np.zeros((2, 64, 3), np.float32)
    pts[:, :48, :2] = rng.uniform(-30, 30, (2, 48, 2))
    az = np.arctan2(pts[..., 1], pts[..., 0]).astype(np.float32)
    vel = rng.uniform(-10, 10, (2, 2)).astype(np.float32)
    want = np.asarray(jdet.doppler_shift(jnp.asarray(pts), jnp.asarray(az), jnp.asarray(vel)))
    got = detectors.doppler_shift(*map(torch.from_numpy, (pts, az, vel))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("yaw_rate", [0.0, 0.8])
def test_motion_undistort_matches_jax(yaw_rate):
    rng = np.random.default_rng(7)
    pts = np.zeros((2, 96, 3), np.float32)
    pts[:, :80, :2] = rng.uniform(-15, 15, (2, 80, 2))
    times = rng.uniform(0, 2.5e8, (2, 96)).astype(np.float32)  # ns within a sweep
    vel = np.array([[5.0, 0.3], [-2.0, 1.0]], np.float32)
    wz = np.full(2, yaw_rate, np.float32)
    want = np.asarray(jdet.motion_undistort(*map(jnp.asarray, (pts, times, vel, wz))))
    got = detectors.motion_undistort(*map(torch.from_numpy, (pts, times, vel, wz))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 80:], 0.0)  # pads stay


def make_room(seed=0, n_wall=3000, n_floor=1500, n_noise=120):
    """The JAX lidar tests' box room: four walls, a floor and noise."""
    rng = np.random.default_rng(seed)
    pts = []
    for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
        p = np.zeros((n_wall // 4, 3))
        p[:, axis] = sign * 10.0
        p[:, 1 - axis] = rng.uniform(-10, 10, n_wall // 4)
        p[:, 2] = rng.uniform(-1.5, 2.5, n_wall // 4)
        pts.append(p)
    floor = np.zeros((n_floor, 3))
    floor[:, :2] = rng.uniform(-10, 10, (n_floor, 2))
    floor[:, 2] = -1.5
    pts += [floor, rng.uniform(-9, 9, (n_noise, 3))]
    out = np.concatenate(pts).astype(np.float32)
    return out + rng.normal(0, 0.005, out.shape).astype(np.float32)


def test_velodyne_convert_matches_jax():
    raw = make_room(seed=1)[:400]
    raw = np.concatenate([raw, np.zeros((4, 3), np.float32)])
    want = jlidar.velodyne_convert(jnp.asarray(raw), use_fov_limit=True)
    got = lidar.velodyne_convert(torch.from_numpy(raw), use_fov_limit=True)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_allclose(got["points"].numpy(), np.asarray(want["points"]), atol=0)
    np.testing.assert_allclose(got["polar"].numpy(), np.asarray(want["polar"]), atol=1e-5)


def assert_normals_close(got, want):
    """Unit normals, within 1e-4 of JAX's on 99% of the rows. The others are
    neighbourhoods whose k-th and (k+1)-th neighbours lie an ulp apart (XLA's
    and torch's distance sums round differently), or whose two smallest
    eigenvalues nearly tie: an ulp there picks another neighbour or turns
    the eigenvector."""
    real = np.abs(want).sum(-1) > 0
    np.testing.assert_allclose(np.linalg.norm(got[real], axis=-1), 1.0, atol=1e-5)
    d = np.abs(got - want).max(-1)
    assert (d <= 1e-4).mean() >= 0.99, (np.sort(d)[-5:], (d > 1e-4).sum())


def by_point(points, normals):
    """Rows [point, normal] in lexicographic order of the points: the top-k
    selection's order among near-equal scores (an ulp apart between XLA and
    torch) is not held, the selected set is."""
    rows = np.concatenate([points, normals], -1)
    return rows[np.lexsort(points.T[::-1])]


@pytest.mark.parametrize("stage", ["", "stage1_"])
def test_lidar_preprocess_matches_jax(stage):
    room = make_room()
    cfg = dict(crop_range=30.0, frame_voxel_size=0.4, num_sample1=1024, num_sample2=2048,
               min_norm_score1=0.9, max_voxels=4096)
    want = jax.jit(jlidar.lidar_preprocess, static_argnums=1)(
        jnp.asarray(room), jlidar.LidarPreprocessConfig(**cfg))
    got = lidar.lidar_preprocess(torch.from_numpy(room), lidar.LidarPreprocessConfig(**cfg))
    valid = np.asarray(want[stage + "valid"])
    assert valid.sum() > (0 if stage else 500)
    np.testing.assert_array_equal(got[stage + "valid"].numpy(), valid)
    w = by_point(np.asarray(want[stage + "points"]), np.asarray(want[stage + "normals"]))
    g = by_point(got[stage + "points"].numpy(), got[stage + "normals"].numpy())
    np.testing.assert_array_equal(g[:, :3], w[:, :3])  # the same voxel means, selected
    assert_normals_close(g[:, 3:], w[:, 3:])


def test_lidar_frame_to_map_cloud_matches_jax():
    room = make_room(seed=3, n_wall=1200, n_floor=600, n_noise=50)
    cfg = dict(num_sample1=512, num_sample2=1024, frame_voxel_size=0.5, max_voxels=2048)
    want = np.asarray(jax.jit(jlidar.lidar_frame_to_map_cloud, static_argnums=1)(
        jnp.asarray(room), jlidar.LidarPreprocessConfig(**cfg)))
    got = lidar.lidar_frame_to_map_cloud(torch.from_numpy(room),
                                         lidar.LidarPreprocessConfig(**cfg)).numpy()
    assert got.shape == (1024, 6)
    g, w = by_point(got[:, :3], got[:, 3:]), by_point(want[:, :3], want[:, 3:])
    np.testing.assert_array_equal(g[:, :3], w[:, :3])
    assert_normals_close(g[:, 3:], w[:, 3:])
