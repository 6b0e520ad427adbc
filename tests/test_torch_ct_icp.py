"""The port's continuous-time ICP (``dicp/ct_icp.py``), its teach pass and
the trajectory query against the JAX package's on the CPU.

Inputs are ``tests/test_ct_icp.py``'s: scans of a world of six walls,
distorted by the sensor's motion during its sweep. Limits: the planar
helpers within 1e-5 of JAX's (1e-6 where no sum enters); one GN step's
update within 1e-5 of its size; the solve with equal iterations, poses
within 1e-4 m and 1e-5 on R (``tests/test_torch_icp.py``'s limits) and the
twist within 1e-4; the continuous-time teach pass over the high-yaw sequence
likewise, with equal keyframes; ``pose_at`` within 1e-4 m.

JAX's solve associates through its Pallas kernel in interpret mode here, as
``tests/test_icp.py`` runs it on the CPU: the kernel's distances are the
port's, (p − q)² summed per axis. JAX's CPU fallback expands
|p|² − 2p·q + |q|², whose float32 rounding at 10 m ranges (1e-5 m²) flips
near-tied neighbours from one iteration to the next; its pt2pt solve then
cycles at steps of 1e-4 and does not reach the tolerance.
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.dicp import CTICPConfig as JCfg
from mm_masking_tpu.geom import se3_exp as jse3_exp
from mm_masking_tpu.localization import odometry as jodo
from mm_masking_tpu_torch.dicp import CTICPConfig, ct_icp
from mm_masking_tpu_torch.localization import odometry

# The modules (each package's dicp exports the function under the same name).
jct_mod = importlib.import_module("mm_masking_tpu.dicp.ct_icp")
ct_mod = importlib.import_module("mm_masking_tpu_torch.dicp.ct_icp")
jct = jct_mod.ct_icp


def _pallas_nn(p, q, use_pallas=None):
    from mm_masking_tpu.ops.pallas.nn_assoc import nn_argmin_pallas

    return nn_argmin_pallas(p, q, interpret=True)


@pytest.fixture(autouse=True)
def pallas_association(monkeypatch):
    monkeypatch.setattr(jct_mod, "nn_argmin", _pallas_nn)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def embed(xi):
    d6 = np.zeros((xi.shape[0], 6), np.float32)
    d6[:, 0], d6[:, 1], d6[:, 5] = xi[:, 0], xi[:, 1], xi[:, 2]
    return d6


def se2(dx, dy, th):
    T = np.eye(4)
    c, s = np.cos(th), np.sin(th)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = dx, dy
    return T


def walls_world(rng, n_map=768):
    """Six walls (points, normals), as ``tests/test_ct_icp.py::_walls_world``."""
    mp, nrm = np.zeros((n_map, 3), np.float32), np.zeros((n_map, 3), np.float32)
    k_n = n_map // 6
    for k in range(6):
        a = rng.uniform(-12, 12, 2)
        ang = rng.uniform(0, 2 * np.pi)
        d = np.array([np.cos(ang), np.sin(ang)])
        t = rng.uniform(0, 12, k_n)
        mp[k * k_n:(k + 1) * k_n, :2] = a[None] + t[:, None] * d[None]
        nrm[k * k_n:(k + 1) * k_n, :2] = (-d[1], d[0])
    return mp, nrm


def distorted_scan(rng, world, T_start, xi_gt, n=256, noise=0.01):
    """World points seen during the sweep from T_start·Exp(s·ξ)."""
    sel = rng.choice(world.shape[0], n, replace=False)
    w = world[sel].astype(np.float64)
    s = np.sort(rng.uniform(0, 1, n))
    Ti = np.linalg.inv(T_start)
    p_start = w @ Ti[:3, :3].T + Ti[:3, 3]
    p = np.array(jct_mod._exp_planar_points(
        jnp.asarray(p_start)[None], jnp.asarray(s)[None], jnp.asarray(-xi_gt)[None]))[0]
    p = p.astype(np.float64)
    p[:, :2] += rng.normal(0, noise, (n, 2))
    p[:, :2] += np.where(np.abs(p[:, :2]) < 1e-9, 1e-6, 0.0)
    return p.astype(np.float32), s.astype(np.float32)


def problem(seed=7, B=4):
    """``test_ct_icp_recovers_pose_and_twist``'s batch, with padded rows."""
    rng = np.random.default_rng(seed)
    world, nrm = walls_world(rng)
    scans, times, T0s = [], [], []
    for _ in range(B):
        T_start = se2(*rng.uniform(-3, 3, 2), rng.uniform(-np.pi, np.pi))
        xi_gt = np.array([rng.uniform(0.2, 0.4), rng.uniform(-0.1, 0.1),
                          rng.uniform(0.2, 0.35) * rng.choice([-1, 1])])
        p, s = distorted_scan(rng, world, T_start, xi_gt)
        p[-16:], s[-16:] = 0.0, 0.0  # pad rows
        scans.append(p)
        times.append(s)
        T0s.append((se2(*rng.normal(0, 0.1, 2), rng.normal(0, 0.05)) @ T_start))
    target = np.concatenate([world, nrm], -1)
    target = np.concatenate([target, np.full((64, 6), 1000.0, np.float32)])  # map pads
    return (np.stack(scans), np.stack(times), np.broadcast_to(target, (B,) + target.shape).copy(),
            np.stack(T0s).astype(np.float32))


def to_j(*a):
    return [jnp.asarray(x) for x in a]


def to_t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def test_planar_helpers_match_jax():
    rng = np.random.default_rng(1)
    xi = rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32)
    xi[0, 2] = 1e-8  # the series branch
    p = rng.uniform(-10, 10, (4, 32, 3)).astype(np.float32)
    p[:, -3:] = 0.0
    s = rng.uniform(0, 1, (4, 32)).astype(np.float32)
    got = ct_mod._exp_planar_points(*to_t(p, s, xi)).numpy()
    want = np.asarray(jct_mod._exp_planar_points(*to_j(p, s, xi)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    got = ct_mod.normalized_times(*to_t(p, s * 7.0), time_to_sec=0.5).numpy()
    want = np.asarray(jct_mod.normalized_times(*to_j(p, s * 7.0), time_to_sec=0.5))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[:, -3:] == 0).all()
    got = ct_mod.undistort_with_twist(*to_t(p, s, xi)).numpy()
    want = np.asarray(jct_mod.undistort_with_twist(*to_j(p, s, xi)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    T = np.asarray(jse3_exp(jnp.asarray(embed(xi)))).astype(np.float32)
    got = ct_mod.planar_log(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(got, np.asarray(jct_mod.planar_log(jnp.asarray(T))), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got, xi, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("icp_type", ["pt2pt", "pt2pl"])
def test_gn_ct_step_matches_jax(icp_type):
    """One joint GN step from the perturbed guesses, with both priors on."""
    source, times, target, T0 = problem()
    s_norm = np.asarray(jct_mod.normalized_times(*to_j(source, times)))
    valid = (~((source[..., 0] == 0) & (source[..., 1] == 0))).astype(np.float32)
    xi0 = np.tile(np.asarray([[0.2, 0.0, 0.1]], np.float32), (4, 1))
    prior = xi0 * 0.5
    T_prior = T0 @ se2(0.05, -0.02, 0.01).astype(np.float32)
    kw = dict(loss_name="cauchy", trim_dist=3.0, twist_prior_weight=0.5,
              pose_prior_weight=0.3, icp_type=icp_type)
    args = (T0, xi0, source, s_norm, target[..., :3], target[..., 3:6])
    jT, jxi, jd = jct_mod._gn_ct_step(*to_j(*args), None, jnp.asarray(valid), JCfg(**kw),
                                      jnp.asarray(prior), jnp.asarray(T_prior))
    tT, txi, td = ct_mod._gn_ct_step(*to_t(*args), None, torch.from_numpy(valid),
                                     CTICPConfig(**kw), torch.from_numpy(prior),
                                     torch.from_numpy(T_prior))
    scale = np.abs(np.asarray(jd)).max()
    assert scale > 1e-3
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-5)
    np.testing.assert_allclose(txi.numpy(), np.asarray(jxi), rtol=0, atol=1e-5)


def hold_solve(got: dict, want: dict) -> None:
    assert int(got["iterations"]) == int(want["iterations"])
    for key in ("T", "T_end"):
        g, w = got[key].numpy(), np.asarray(want[key])
        np.testing.assert_allclose(g[:, :3, 3], w[:, :3, 3], rtol=0, atol=1e-4)
        np.testing.assert_allclose(g[:, :3, :3], w[:, :3, :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["xi"].numpy(), np.asarray(want["xi"]), rtol=0, atol=1e-4)


@pytest.mark.parametrize("icp_type", ["pt2pt", "pt2pl"])
def test_ct_icp_matches_jax(icp_type):
    """The whole solve, global stop test and all: every item steps until the
    largest step is under tolerance (or the 30 iterations run out)."""
    source, times, target, T0 = problem()
    cfg = dict(icp_type=icp_type, max_iterations=30, trim_dist=3.0, twist_prior_weight=1e-3,
               tolerance=1e-4)
    want = jct(*to_j(source, times, target, T0), cfg=JCfg(**cfg))
    got = ct_icp(*to_t(source, times, target, T0), cfg=CTICPConfig(**cfg))
    hold_solve(got, want)
    assert got["stop_tests"] == -(-int(got["iterations"]) // 5) - (int(got["iterations"]) == 30)


def test_ct_icp_stops_on_the_largest_step():
    """A converged item keeps stepping while another still moves (the JAX
    loop's global test): with one item started at its solution and one far
    from it, both run the same iterations; the solve from the solution
    alone stops at once."""
    source, times, target, T0 = problem(B=2)
    cfg = CTICPConfig(max_iterations=30, trim_dist=3.0, twist_prior_weight=1e-3,
                      tolerance=1e-4)
    first = ct_icp(*to_t(source, times, target, T0), cfg=cfg)
    T_start = first["T"].numpy().copy()
    T_start[1] = T0[1]
    both = ct_icp(*to_t(source, times, target, T_start),
                  xi_init=torch.stack([first["xi"][0], torch.zeros(3)]), cfg=cfg)
    want = jct(*to_j(source, times, target, T_start),
               xi_init=jnp.asarray(np.stack([first["xi"][0].numpy(), np.zeros(3, np.float32)])),
               cfg=JCfg(**vars(cfg)))
    hold_solve(both, want)
    alone = ct_icp(*to_t(source[:1], times[:1], target[:1], T_start[:1]),
                   xi_init=first["xi"][:1], cfg=cfg)
    assert int(alone["iterations"]) < int(both["iterations"])


F_FRAMES = 6


def high_yaw_frames():
    """``test_teachpass_continuous_time_drift``'s sweep: frame k starts at
    S[k] and moves with ξ_k during its scan; frame 0 stands still."""
    rng = np.random.default_rng(13)
    world, _ = walls_world(rng, n_map=768)
    xi_seq = [np.zeros(3)] + [np.array([0.5, 0.0, 0.35])] * (F_FRAMES - 1)
    S = [np.eye(4)]
    for k in range(F_FRAMES):
        S.append(S[k] @ np.asarray(jse3_exp(jnp.asarray(embed(xi_seq[k][None]))))[0])
    rng_run = np.random.default_rng(17)
    return [distorted_scan(rng_run, world, S[k], xi_seq[k], n=256, noise=0.005)
            for k in range(F_FRAMES)], S


CT_CFG = dict(max_map_pts=2048, voxel_size=0.3, continuous_time=True, trim_dist=3.0)


@pytest.fixture(scope="module")
def ct_passes():
    frames, S = high_yaw_frames()
    stamps = [1_000_000 + 250_000 * k for k in range(F_FRAMES)]
    jtp = jodo.TeachPass(jodo.OdometryConfig(**CT_CFG))
    tp = odometry.TeachPass(odometry.OdometryConfig(**CT_CFG))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jct_mod, "nn_argmin", _pallas_nn)
        for (p, s), st in zip(frames, stamps):
            jtp.process(jnp.asarray(p), stamp_us=st, times=jnp.asarray(s))
            tp.process(torch.from_numpy(p), stamp_us=st, times=torch.from_numpy(s))
    return jtp, tp, S, stamps


def test_ct_teach_pass_matches_jax(ct_passes):
    jtp, tp, S, _ = ct_passes
    got, want = np.stack(tp.trajectory), np.stack(jtp.trajectory).astype(np.float32)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=0, atol=1e-5)
    assert tp.n_keyframes == jtp.n_keyframes == F_FRAMES
    real = np.abs(np.asarray(jtp.map_pts)[:, 0]) < 500
    np.testing.assert_array_equal(np.abs(tp.map_pts.numpy()[:, 0]) < 500, real)
    np.testing.assert_allclose(tp.map_pts.numpy(), np.asarray(jtp.map_pts), rtol=0, atol=4e-4)
    np.testing.assert_allclose(tp._xi_prior().numpy(), np.asarray(jtp._xi_prior()), rtol=0,
                               atol=1e-4)
    # The property the JAX test holds: the last pose tracks the scan-end GT.
    assert np.linalg.norm(got[-1][:2, 3] - S[F_FRAMES][:2, 3]) < 0.25


def test_pose_at_matches_jax_and_is_epoch_invariant(ct_passes):
    """``pose_at`` between frames equals JAX's at stamps near 1e6 µs; at
    epoch stamps (1.6e15 µs), where JAX's float32 seconds put every knot on
    one time, the port's query equals its query at the same stamps less the
    first."""
    jtp, tp, _, stamps = ct_passes
    for q in (stamps[0] - 5, stamps[1] + 125_000, stamps[3] + 30_000, stamps[-1] + 10):
        T, w = tp.pose_at(q)
        jT, jw = jtp.pose_at(q)
        np.testing.assert_allclose(T[:3, 3].numpy(), np.asarray(jT)[:3, 3], rtol=0, atol=1e-4)
        np.testing.assert_allclose(T[:3, :3].numpy(), np.asarray(jT)[:3, :3], rtol=0, atol=1e-5)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-3)
    epoch = 1606417230036848 - stamps[0]
    shifted = odometry.TeachPass(tp.cfg)
    shifted._poses, shifted.stamps = tp._poses, [s + epoch for s in stamps]
    for q in (stamps[1] + 125_000, stamps[4] + 7):
        np.testing.assert_array_equal(shifted.pose_at(q + epoch)[0].numpy(),
                                      tp.pose_at(q)[0].numpy())
    jshift = jodo.TeachPass(jtp.cfg)
    jshift.trajectory, jshift.stamps = jtp.trajectory, shifted.stamps
    assert len(np.unique(np.asarray(jnp.asarray(jshift.stamps, jnp.float32)))) < len(stamps)
