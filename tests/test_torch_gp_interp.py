"""The port's SE(3) additions and WNOA trajectory query against the JAX
package's on the CPU (``geom/se3.py``: vee3, so3_log, so3_left_jacobian_inv,
se3_log, rotate_vectors; ``geom/gp_interp.py``).

The cases mirror ``tests/test_gp_interp.py`` and ``tests/test_se3.py``: each
feeds both packages the same numpy inputs and holds the port to JAX's
outputs (float32, stated limits: 2e-6 on Jacobians and poses of unit scale,
1e-5 where a Log or a 6×6 solve enters), and to the properties the JAX tests
check.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_masking_tpu.geom as jg
import mm_masking_tpu.geom.gp_interp as jgp
import mm_masking_tpu_torch.geom as tg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_xi(rng, b, rot_scale=1.5, trans_scale=2.0):
    xi = rng.uniform(-1.0, 1.0, (b, 6)).astype(np.float32)
    xi[:, :3] *= trans_scale
    xi[:, 3:] *= rot_scale / np.sqrt(3.0)
    return xi


def both(fn_name, *args):
    """(port, JAX) of the same function on the same numpy arguments."""
    jf = getattr(jg, fn_name)
    tf = getattr(tg, fn_name)
    want = np.asarray(jf(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = tf(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]).numpy()
    return got, want


def knots(rng):
    T1 = np.asarray(jg.se3_exp(jnp.asarray(rand_xi(rng, 1))))
    w1 = rand_xi(rng, 1) * 0.5
    T2 = T1 @ np.asarray(jg.se3_exp(jnp.asarray(rand_xi(rng, 1) * 0.4)))
    w2 = rand_xi(rng, 1) * 0.5
    return T1.astype(np.float32), w1, T2.astype(np.float32), w2


# -------------------------------------------------------------- se3 additions


def test_vee3_and_rotate_vectors_match_jax():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(5, 3, 3)).astype(np.float32)
    got, want = both("vee3", M)
    np.testing.assert_array_equal(got, want)
    T = np.asarray(jg.se3_exp(jnp.asarray(rand_xi(rng, 4)))).astype(np.float32)
    v = rng.normal(size=(4, 50, 3)).astype(np.float32)
    got, want = both("rotate_vectors", T, v)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("scale", [1e-6, 1e-4, 1e-2, 0.3, 1.5])
def test_so3_log_and_jacobian_inverse_match_jax(scale):
    """Across the small-angle guard (cos θ ≥ 1 − 1e-6) and the Taylor branch
    of the inverse Jacobian (θ² < 0.01)."""
    rng = np.random.default_rng(1)
    phi = (rng.normal(size=(16, 3)) * scale).astype(np.float32)
    C = np.asarray(jg.so3_exp(jnp.asarray(phi))).astype(np.float32)
    got, want = both("so3_log", C)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * max(1.0, scale))
    got, want = both("so3_left_jacobian_inv", phi)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert np.isfinite(got).all()


def test_se3_log_inverts_exp_and_matches_jax():
    """JAX's ``test_log_inverts_exp`` and the f32 dead-zone repro of
    ``test_left_jacobian_inv_f32_dead_zone``."""
    rng = np.random.default_rng(2)
    xi = (rng.normal(size=(32, 6)) * 0.8).astype(np.float32)
    T = tg.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(tg.se3_log(T).numpy(), xi, rtol=0, atol=1e-4)
    got, want = both("se3_log", T.numpy())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    small = np.asarray([[6.8e-3, -8.5e-4, 0.0, 0.0, 0.0, 1.9e-4]], np.float32)
    np.testing.assert_allclose(tg.se3_log(tg.se3_exp(torch.from_numpy(small))).numpy(), small,
                               rtol=0, atol=1e-7)
    for theta in (2e-4, 1e-3, 2e-2, 0.09, 0.11, 0.5):
        phi = torch.tensor([0.0, 0.0, theta])
        np.testing.assert_allclose((tg.so3_left_jacobian_inv(phi)
                                    @ tg.so3_left_jacobian(phi)).numpy(), np.eye(3), atol=2e-6)
    phi = np.asarray([1e-6, -2e-6, 3e-6], np.float32)
    np.testing.assert_allclose(tg.so3_log(tg.so3_exp(torch.from_numpy(phi))).numpy(), phi,
                               atol=1e-9)


# ---------------------------------------------------------------- gp_interp


def test_left_jacobian_block_structure():
    xi = rand_xi(np.random.default_rng(0), 8)
    got, want = both("se3_left_jacobian6", xi)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    Jso3 = tg.so3_left_jacobian(torch.from_numpy(xi[:, 3:])).numpy()
    np.testing.assert_allclose(got[:, :3, :3], Jso3, atol=2e-6)
    np.testing.assert_allclose(got[:, 3:, 3:], Jso3, atol=2e-6)
    np.testing.assert_allclose(got[:, 3:, :3], 0.0, atol=2e-6)
    np.testing.assert_allclose(tg.se3_left_jacobian6(torch.zeros(1, 6))[0].numpy(), np.eye(6),
                               atol=1e-7)
    got, want = both("se3_right_jacobian6", xi)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_left_jacobian_matches_defining_integral():
    """Jl(ξ) = ∫₀¹ Ad(Exp(sξ)) ds (Simpson quadrature, as the JAX test)."""
    xi = torch.from_numpy(rand_xi(np.random.default_rng(1), 4))
    n = 200
    s = torch.linspace(0.0, 1.0, n + 1)
    T = tg.se3_exp(s[:, None, None] * xi[None])
    C, t_hat = T[..., :3, :3], tg.hat3(T[..., :3, 3])
    ad = torch.cat([torch.cat([C, t_hat @ C], -1), torch.cat([torch.zeros_like(C), C], -1)], -2)
    wgt = torch.ones(n + 1)
    wgt[1:-1:2], wgt[2:-1:2] = 4.0, 2.0
    integral = torch.einsum("s,sbij->bij", wgt, ad) / (3.0 * n)
    np.testing.assert_allclose(tg.se3_left_jacobian6(xi).numpy(), integral.numpy(), atol=5e-5,
                               rtol=1e-4)


def test_curly_hat_bracket():
    rng = np.random.default_rng(2)
    x, y = rand_xi(rng, 1), rand_xi(rng, 1)
    got, want = both("se3_curly_hat", x)
    np.testing.assert_array_equal(got, want)

    def hat4(v):
        M = torch.zeros(4, 4)
        M[:3, :3] = tg.hat3(v[3:])
        M[:3, 3] = v[:3]
        return M

    xt, yt = torch.from_numpy(x[0]), torch.from_numpy(y[0])
    lhs = hat4(tg.se3_curly_hat(xt) @ yt)
    rhs = hat4(xt) @ hat4(yt) - hat4(yt) @ hat4(xt)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-5)


def interp_both(T1, w1, T2, w2, alpha, dt):
    want = jgp.wnoa_interpolate(*map(jnp.asarray, (T1, w1, T2, w2)), alpha, dt)
    got = tg.wnoa_interpolate(*map(torch.from_numpy, (T1, w1, T2, w2)), alpha, dt)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("alpha", [0.0, 0.37, 1.0])
def test_boundary_conditions_and_interior_match_jax(alpha):
    T1, w1, T2, w2 = knots(np.random.default_rng(3))
    (Tq, wq), (jT, jw) = interp_both(T1, w1, T2, w2, alpha, 0.7)
    np.testing.assert_allclose(Tq, jT, rtol=0, atol=1e-5)
    np.testing.assert_allclose(wq, jw, rtol=0, atol=1e-4)
    if alpha in (0.0, 1.0):
        T_end, w_end = (T1, w1) if alpha == 0.0 else (T2, w2)
        np.testing.assert_allclose(Tq, T_end, atol=1e-5)
        np.testing.assert_allclose(wq, w_end, atol=1e-4)


def test_constant_twist_is_exact():
    rng = np.random.default_rng(4)
    T1 = tg.se3_exp(torch.from_numpy(rand_xi(rng, 1)))
    w = torch.from_numpy(rand_xi(rng, 1) * 0.6)
    dt = 0.5
    T2 = T1 @ tg.se3_exp(w * dt)
    for alpha in (0.2, 0.5, 0.8):
        Tq, wq = tg.wnoa_interpolate(T1, w, T2, w, alpha, dt)
        np.testing.assert_allclose(Tq.numpy(), (T1 @ tg.se3_exp(alpha * dt * w)).numpy(),
                                   atol=2e-5)
        np.testing.assert_allclose(wq.numpy(), w.numpy(), atol=1e-4)


def test_interpolated_twist_is_kinematically_consistent():
    """w(τ) is the body velocity of the interpolated curve, by a float64
    finite difference (the port's functions take float64 as they are)."""
    T1, w1, T2, w2 = (torch.from_numpy(a).double() for a in knots(np.random.default_rng(5)))
    dt, alpha, eps = 0.8, 0.37, 1e-6
    Ta, wa = tg.wnoa_interpolate(T1, w1, T2, w2, alpha, dt)
    Tb, _ = tg.wnoa_interpolate(T1, w1, T2, w2, alpha + eps, dt)
    w_fd = tg.se3_log(tg.se3_inv(Ta) @ Tb) / (eps * dt)
    np.testing.assert_allclose(wa.numpy(), w_fd.numpy(), atol=1e-4, rtol=1e-4)


def test_beats_constant_twist_on_accelerating_trajectory():
    """Body twist linear in t: the GP midpoint within 2 cm of the fine
    integration and under a tenth of constant-twist interpolation's error;
    the integration in float64 here, the query in float32."""

    def w_of_t(t):
        z = torch.zeros_like(t)
        return torch.stack([2.0 * t, z, z, z, z, torch.full_like(t, 0.5)], -1)

    def integrate(t1, steps=4000):
        h = t1 / steps
        t = (torch.arange(steps, dtype=torch.float64) + 0.5) * h
        T = torch.eye(4, dtype=torch.float64)
        for Tk in tg.se3_exp(w_of_t(t) * h):
            T = T @ Tk
        return T[None].float()

    T1, T2, T_mid = torch.eye(4)[None], integrate(1.0), integrate(0.5)
    w1, w2 = w_of_t(torch.tensor(0.0))[None], w_of_t(torch.tensor(1.0))[None]
    T_gp, _ = tg.wnoa_interpolate(T1, w1, T2, w2, 0.5, 1.0)
    T_lin = T1 @ tg.se3_exp(0.5 * tg.se3_log(tg.se3_inv(T1) @ T2))
    err_gp = float((T_gp[0, :3, 3] - T_mid[0, :3, 3]).norm())
    err_lin = float((T_lin[0, :3, 3] - T_mid[0, :3, 3]).norm())
    assert err_gp < 0.1 * err_lin and err_gp < 0.02, (err_gp, err_lin)


def test_trajectory_interpolator_hits_knots_clamps_and_matches_jax():
    rng = np.random.default_rng(6)
    Ts = [np.eye(4, dtype=np.float32)]
    for _ in range(4):
        Ts.append(Ts[-1] @ np.asarray(jg.se3_exp(jnp.asarray(rand_xi(rng, 1)[0] * 0.3))))
    Ts = np.stack(Ts).astype(np.float32)
    times = np.asarray([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)
    q = np.asarray([-0.1, 0.0, 0.1, 0.5, 0.63, 1.0, 1.3], np.float32)
    jT, jw = (np.asarray(a) for a in jg.interpolate_trajectory(*map(jnp.asarray, (Ts, times, q))))
    Tq, wq = (a.numpy() for a in tg.interpolate_trajectory(*map(torch.from_numpy, (Ts, times, q))))
    np.testing.assert_allclose(Tq, jT, rtol=0, atol=1e-5)
    np.testing.assert_allclose(wq, jw, rtol=0, atol=1e-4)
    for i, k in ((1, 0), (3, 2), (5, 4), (0, 0), (6, 4)):
        np.testing.assert_allclose(Tq[i], Ts[k], atol=1e-5)
    assert wq.shape == (7, 6)
    T1, w1 = (a.numpy() for a in tg.interpolate_trajectory(
        torch.from_numpy(Ts[:1]), torch.zeros(1), torch.from_numpy(q)))
    assert T1.shape == (7, 4, 4) and (T1 == Ts[0]).all() and (w1 == 0).all()


def test_central_difference_twists_recover_constant_twist():
    w = np.asarray([[0.8, -0.2, 0.0, 0.0, 0.0, 0.4]], np.float32)
    Ts = [np.eye(4, dtype=np.float32)]
    for _ in range(4):
        Ts.append(Ts[-1] @ np.asarray(jg.se3_exp(jnp.asarray(w[0] * 0.25))))
    Ts = np.stack(Ts).astype(np.float32)
    times = np.arange(5, dtype=np.float32) * 0.25
    got = tg.body_twists_from_trajectory(torch.from_numpy(Ts), torch.from_numpy(times)).numpy()
    want = np.asarray(jg.body_twists_from_trajectory(jnp.asarray(Ts), jnp.asarray(times)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.broadcast_to(w, (5, 6)), atol=1e-4)


def test_epoch_stamps_collapse_in_float32_seconds():
    """At Boreas's epoch stamps (~1.6e15 µs) float32 seconds have a 128 s ulp:
    JAX's ``teach --interp-period-us`` and ``TeachPass.pose_at`` cast the
    absolute stamps, so a sequence's knots fall on one time. The port
    references them to the first stamp in int64 first."""
    stamps = 1606417230036848 + 250000 * np.arange(5, dtype=np.int64)
    assert len(np.unique(np.asarray(stamps, np.float64).astype(np.float32) * 1e-6)) == 1
    jax_times = np.asarray(jnp.asarray(stamps, jnp.float32) * 1e-6)
    assert len(np.unique(jax_times)) == 1
    from mm_masking_tpu_torch.localization.odometry import seconds_since

    rel = seconds_since(stamps, stamps[0]).numpy()
    np.testing.assert_array_equal(rel, np.arange(5, dtype=np.float32) * np.float32(0.25))
