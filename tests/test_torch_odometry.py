"""The port's teach pass (frame-to-map ICP odometry and voxel map) vs the JAX
package's on the CPU, on the scans of ``tests/test_odometry.py``.

Over 8 frames the trajectory stays within 1e-4 m (and 1e-5 in rotation) of
JAX's, the keyframe counts are equal and the map rows agree within 4e-4 m
(those limits at the scans' 28 m radius) in the same order, with equal cell
weights. ``merge_into_map`` on the same inputs gives the same rows within
1e-6; ``orthonormalize_planar`` within an ulp of cos and sin, and
``is_keyframe`` agrees exactly.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.geom import se3_exp as jse3_exp
from mm_masking_tpu.localization import odometry as jodo
from mm_masking_tpu_torch.localization import odometry


def make_world(seed=0, n=400):
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 3), np.float32)
    r = rng.uniform(3, 25, n)
    a = rng.uniform(0, 2 * np.pi, n)
    pts[:, 0], pts[:, 1] = r * np.cos(a), r * np.sin(a)
    return pts


def scans(n_frames=8, seed=9, step=(0.6, 0.04, 0, 0, 0, 0.03), n=256):
    """Scans of a planar scatter world from a robot moving at constant
    velocity (T_world_robot), with 1 cm noise and zero pad rows."""
    world = make_world(seed, 700)
    rng = np.random.default_rng(3)
    T = np.eye(4)
    out, poses = [], []
    for _ in range(n_frames):
        Ti = np.linalg.inv(T)
        s = (world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        s += rng.normal(0, 0.01, s.shape).astype(np.float32)
        s[:, 2] = 0.0
        s = s[np.linalg.norm(s[:, :2], axis=1) < 28][:n]
        out.append(np.pad(s, ((0, n - s.shape[0]), (0, 0))))
        poses.append(T)
        T = np.asarray(jse3_exp(jnp.asarray(step, jnp.float32))) @ T
    return out, poses


CFG = dict(max_map_pts=1024, voxel_size=0.3, max_iterations=30)


@pytest.fixture(scope="module")
def passes():
    frames, poses = scans()
    jtp = jodo.TeachPass(jodo.OdometryConfig(**CFG))
    tp = odometry.TeachPass(odometry.OdometryConfig(**CFG))
    for i, s in enumerate(frames):
        jtp.process(jnp.asarray(s), stamp_us=1000 * i)
        tp.process(torch.from_numpy(s), stamp_us=1000 * i)
    return jtp, tp, poses


def test_teach_pass_trajectory_matches_jax(passes):
    jtp, tp, poses = passes
    got, want = np.stack(tp.trajectory), np.stack(jtp.trajectory).astype(np.float32)
    assert got.shape == (8, 4, 4)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=0, atol=1e-5)
    assert tp.n_keyframes == jtp.n_keyframes == 8
    assert tp.stamps == jtp.stamps
    err = [np.linalg.norm((g @ np.linalg.inv(p))[:2, 3]) for g, p in zip(got, poses)]
    assert max(err) < 0.1, err


def test_teach_pass_map_matches_jax(passes):
    jtp, tp, _ = passes
    want, got = np.asarray(jtp.map_pts), tp.map_pts.numpy()
    real = np.abs(want[:, 0]) < 500
    assert real.sum() > 300
    np.testing.assert_array_equal(np.abs(got[:, 0]) < 500, real)
    # The poses' limits carried to the scans' 28 m radius: 1e-4 + 28 · 1e-5 m.
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-4)
    np.testing.assert_allclose(tp.map_w.numpy(), np.asarray(jtp.map_w), rtol=0, atol=0)
    # JAX's method, jitted on the map as an argument (a stand-in for self).
    jmwn = np.asarray(jax.jit(lambda m: jodo.TeachPass.map_with_normals(
        types.SimpleNamespace(map_pts=m, cfg=jtp.cfg)))(jtp.map_pts))
    mwn = tp.map_with_normals().numpy()
    assert mwn.shape == jmwn.shape == (1, 1024, 6)
    np.testing.assert_array_equal(mwn[0, ~real, 3:], 1000.0)
    np.testing.assert_allclose(tp.velocity_estimate().numpy(),
                               np.asarray(jtp.velocity_estimate()), rtol=0, atol=4e-4)


@pytest.mark.parametrize("center", [False, True])
def test_merge_into_map_matches_jax(center):
    frames, _ = scans(n_frames=2)
    cfg = dict(max_map_pts=300, voxel_size=0.4)  # fewer rows than cells: eviction
    map_pts = np.full((300, 3), 1000.0, np.float32)
    map_pts[:200] = frames[1][:200] + np.float32(0.05)
    map_w = np.zeros(300, np.float32)
    map_w[:200] = 2.0
    kw = dict(center=np.array([0.5, 0.1, 0.0], np.float32)) if center else {}
    want = jodo.merge_into_map(jnp.asarray(map_pts), jnp.asarray(frames[0]),
                               jodo.OdometryConfig(**cfg), map_w=jnp.asarray(map_w),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    got = odometry.merge_into_map(torch.from_numpy(map_pts), torch.from_numpy(frames[0]),
                                  odometry.OdometryConfig(**cfg), map_w=torch.from_numpy(map_w),
                                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_orthonormalize_and_keyframe_test_match_jax():
    rng = np.random.default_rng(8)
    T = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    th = rng.uniform(-1, 1, 5)
    T[:, 0, 0], T[:, 0, 1] = 1.01 * np.cos(th), -np.sin(th)
    T[:, 1, 0], T[:, 1, 1] = np.sin(th), 0.99 * np.cos(th)
    T[:, :2, 3] = rng.uniform(-2, 2, (5, 2))
    np.testing.assert_allclose(odometry.orthonormalize_planar(torch.from_numpy(T)).numpy(),
                               np.asarray(jodo.orthonormalize_planar(jnp.asarray(T))),
                               rtol=0, atol=1.2e-7)  # cos and sin an ulp apart
    for thresholds in ((0.0, 0.0), (1.0, 30.0), (5.0, 89.0)):
        cfg = dict(max_translation=thresholds[0], max_rotation_deg=thresholds[1])
        for Ti in T:
            assert odometry.is_keyframe(torch.from_numpy(Ti)[None],
                                        odometry.OdometryConfig(**cfg)) == \
                jodo.is_keyframe(jnp.asarray(Ti)[None], jodo.OdometryConfig(**cfg))


def test_yaw_to_se3_matches_jax():
    from mm_masking_tpu.geom import yaw_to_se3 as jyaw_to_se3
    from mm_masking_tpu_torch.geom import yaw_to_se3

    x, y, th = np.random.default_rng(2).uniform(-3, 3, (3, 7)).astype(np.float32)
    np.testing.assert_allclose(yaw_to_se3(*map(torch.from_numpy, (x, y, th))).numpy(),
                               np.asarray(jyaw_to_se3(*map(jnp.asarray, (x, y, th)))),
                               rtol=0, atol=1.2e-7)  # cos and sin an ulp apart


def test_unported_odometry_paths_raise():
    """The continuous-time and MC-RANSAC paths (items 14 and 15) run: each
    former refusal now returns (their values are held against JAX in
    ``tests/test_torch_ct_icp.py`` and ``tests/test_torch_ransac.py``)."""
    frames, _ = scans(n_frames=3)
    times = np.linspace(0.0, 1.0, frames[0].shape[0], dtype=np.float32)
    ct = odometry.TeachPass(odometry.OdometryConfig(continuous_time=True, **CFG))
    for i, s in enumerate(frames):
        ct.process(torch.from_numpy(s), stamp_us=1000 * i, times=torch.from_numpy(times))
    T, w = ct.pose_at(1500)
    assert T.shape == (4, 4) and w.shape == (6,) and torch.isfinite(T).all()
    ransac = odometry.TeachPass(odometry.OdometryConfig(use_mcransac=True, **CFG))
    for s in frames:
        ransac.process(torch.from_numpy(s))
    assert np.isfinite(np.stack(ransac.trajectory)).all()
    scan, mp = torch.from_numpy(frames[1])[None], ct.map_pts[None]
    T = odometry.register_frame(scan, mp, torch.eye(4)[None],
                                odometry.OdometryConfig(use_mcransac=True))
    T_end, xi = odometry.register_frame_ct(scan, torch.from_numpy(times)[None], mp,
                                           torch.eye(4)[None], torch.zeros(1, 3),
                                           odometry.OdometryConfig())
    assert T.shape == T_end.shape == (1, 4, 4) and xi.shape == (1, 3)
    img = torch.rand(1, 64, 64)
    pts = torch.from_numpy(frames[0][:32])[None] * 0.2
    out = odometry.descriptor_bootstrap(img, pts, img, pts, 0.25)
    assert out["T"].shape == (1, 4, 4) and out["matches"].dtype == torch.int32
