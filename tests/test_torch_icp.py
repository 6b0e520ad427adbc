"""PyTorch port's ICP vs the JAX package's ``icp`` on the CPU.

Converging planar scenes; the stripe association is forced on at a small
window. The two solvers differ only in float32 reduction order and in the
association's distance form, so converged poses agree to 1e-4 m / 1e-5 rad
and iteration counts to within one. The unrolled differentiable solver is
held to ``jax.grad``: ∂T/∂weight within 1e-3 of its largest entry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.dicp import ICP as JICP, ICPConfig as JICPConfig, icp as jicp
from mm_masking_tpu.dicp import icp_implicit as jicp_implicit
from mm_masking_tpu.dicp.icp import _icp_implicit_bwd as jimplicit_bwd
from mm_masking_tpu.dicp.icp import _solve3x3 as jsolve3x3
from mm_masking_tpu_torch.dicp import ICP, TARGET_PAD_VAL, ICPConfig, icp, icp_implicit
from mm_masking_tpu_torch.dicp.icp import _implicit_weight_grad, _solve3x3, _solve_frozen
from mm_masking_tpu_torch.geom import se3_exp
from mm_masking_tpu_torch.ops.kernels import nn_assoc as tnn
from test_torch_e2e_product import one_thread  # noqa: F401
from test_torch_train import no_host_reads


def scene(seed, B=3, N=256, M=2048, n_pad_src=16, n_pad_map=96):
    """Planar scatter map (with normals) and a noisy gt-aligned scan of it."""
    rng = np.random.default_rng(seed)
    map_pts = np.zeros((B, M, 3), np.float32)
    map_pts[..., :2] = rng.uniform(-40, 40, (B, M, 2))
    nrm = rng.normal(size=(B, M, 3)).astype(np.float32)
    nrm[..., 2] *= 0.1
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    src = map_pts[:, :N] + rng.normal(0, 0.01, (B, N, 3)).astype(np.float32)
    src[..., 2] = 0.0
    src[:, N - n_pad_src:] = 0.0
    map_pts[:, M - n_pad_map:] = TARGET_PAD_VAL
    nrm[:, M - n_pad_map:] = TARGET_PAD_VAL
    xi = np.zeros((B, 6), np.float32)
    xi[:, :2] = rng.uniform(-0.5, 0.5, (B, 2))
    xi[:, 5] = rng.uniform(-0.08, 0.08, B)
    weight = rng.uniform(0.2, 1.0, (B, N)).astype(np.float32)
    T_init = se3_exp(torch.from_numpy(xi)).numpy()
    return src, np.concatenate([map_pts, nrm], -1), T_init, weight


@pytest.mark.parametrize(
    "icp_type,stripe,dim",
    [("pt2pt", True, 2), ("pt2pl", True, 2), ("pt2pt", False, 2), ("pt2pl", False, 3)],
)
def test_inference_icp_matches_jax(icp_type, stripe, dim):
    src, tgt, T_init, weight = scene(seed=3 if icp_type == "pt2pt" else 6)
    cfg = dict(icp_type=icp_type, max_iterations=50, tolerance=1e-5, differentiable=False,
               nn_stripe=stripe, nn_stripe_window=512, nn_stripe_tile=64, dim=dim)
    want = jicp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(T_init),
                weight=jnp.asarray(weight), cfg=JICPConfig(**cfg))
    got = icp(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init),
              weight=torch.from_numpy(weight), cfg=ICPConfig(**cfg))
    T_w, T_g = np.asarray(want["T"]), got["T"].numpy()
    converged = np.asarray(want["delta_norm"]) < 1e-5
    assert converged.all() and (got["delta_norm"].numpy() < 1e-5).all()
    np.testing.assert_allclose(T_g[:, :3, 3], T_w[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(T_g[:, :3, :3], T_w[:, :3, :3], rtol=0, atol=1e-5)
    assert abs(got["iterations"] - int(want["iterations"])) <= 1
    assert np.abs(T_g[:, 1, 0]).max() < 1e-3  # recovered the identity


def staggered_scene(seed=3):
    """scene() with initial offsets scaled per item, so that the items stop
    at different iterations: one within 3, one within 7, two after 20."""
    src, tgt, _, weight = scene(seed=seed, B=4)
    xi = np.zeros((4, 6), np.float32)
    scale = np.array([0.02, 0.3, 1.0, 2.5], np.float32)
    xi[:, 0], xi[:, 1], xi[:, 5] = 0.5 * scale, -0.4 * scale, 0.08 * scale
    return src, tgt, se3_exp(torch.from_numpy(xi)).numpy(), weight


@pytest.mark.parametrize("stripe", [True, False])
@pytest.mark.parametrize("max_iterations", [7, 50])
def test_chunked_inference_icp_matches_the_per_iteration_loop(monkeypatch, max_iterations,
                                                              stripe):
    """The inference solve reads its stop test once per chunk of
    STOP_TEST_EVERY iterations and counts iterations on the device. Against
    the same solve testing after every iteration (chunks of 1): the same
    T, delta_norm and iterations, bit for bit, with items that stop at
    different iterations and a max_iterations (7) that is no multiple of
    the chunk; against the JAX icp: T within its limits and the same count."""
    icp_module = importlib.import_module("mm_masking_tpu_torch.dicp.icp")
    src, tgt, T_init, weight = staggered_scene()
    cfg = dict(icp_type="pt2pt", max_iterations=max_iterations, tolerance=1e-5,
               differentiable=False, nn_stripe=stripe, nn_stripe_window=512,
               nn_stripe_tile=64)
    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init))
    reads = []
    to_bool = torch.Tensor.__bool__

    def counted(self):
        reads.append(1)
        return to_bool(self)

    with mock.patch.object(torch.Tensor, "__bool__", counted):
        got = icp(*args, weight=torch.from_numpy(weight), cfg=ICPConfig(**cfg))
    k = icp_module.STOP_TEST_EVERY
    assert k > 1 and 7 % k  # chunks of several iterations; 7 is no multiple
    assert len(reads) == got["stop_tests"] <= math.ceil(max_iterations / k)
    monkeypatch.setattr(icp_module, "STOP_TEST_EVERY", 1)
    loop = icp(*args, weight=torch.from_numpy(weight), cfg=ICPConfig(**cfg))
    assert loop["stop_tests"] == min(max_iterations - 1, int(loop["iterations"]))
    for name in ("T", "delta_norm", "iterations"):
        assert torch.equal(got[name], loop[name]), name
    stopped = (got["delta_norm"] < 1e-5).numpy()
    if max_iterations == 7:
        assert int(got["iterations"]) == 7 and stopped[:2].all() and not stopped[2:].any()
    else:
        assert stopped.all() and int(got["iterations"]) > 20

    want = jicp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(T_init),
                weight=jnp.asarray(weight), cfg=JICPConfig(**cfg))
    T_w, T_g = np.asarray(want["T"]), got["T"].numpy()
    np.testing.assert_allclose(T_g[:, :3, 3], T_w[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(T_g[:, :3, :3], T_w[:, :3, :3], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(want["delta_norm"]) < 1e-5, stopped)
    assert abs(int(got["iterations"]) - int(want["iterations"])) <= (max_iterations == 50)


GATED = dict(max_iterations=50, tolerance=1e-5, differentiable=False, nn_stripe_window=512,
             nn_stripe_tile=64, nn_refresh_dist=0.05)


@pytest.mark.parametrize("stripe", [True, False])
@pytest.mark.parametrize("icp_type", ["pt2pt", "pt2pl"])
def test_gated_refresh_matches_jax(icp_type, stripe):
    """The motion-gated solve (nn_refresh_dist 0.05) against JAX's: T within
    1e-4 m / 1e-5 rad, iterations within one, on items that stop at
    different iterations; its gate steps every item until the largest
    update is under tolerance, so it runs more iterations than the
    per-item freeze of the ungated solve. pt2pl takes scene(6) of the
    ungated parity test: the staggered scene's farthest item ends in a wrong
    basin under pt2pl, where the two packages' float32 orders part."""
    src, tgt, T_init, weight = staggered_scene() if icp_type == "pt2pt" else scene(seed=6)
    cfg = dict(GATED, icp_type=icp_type, nn_stripe=stripe)
    want = jicp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(T_init),
                weight=jnp.asarray(weight), cfg=JICPConfig(**cfg))
    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init))
    got = icp(*args, weight=torch.from_numpy(weight), cfg=ICPConfig(**cfg))
    ungated = icp(*args, weight=torch.from_numpy(weight),
                  cfg=ICPConfig(**{**cfg, "nn_refresh_dist": 0.0}))
    T_w, T_g = np.asarray(want["T"]), got["T"].numpy()
    assert (np.asarray(want["delta_norm"]) < 1e-5).all() and (got["delta_norm"] < 1e-5).all()
    np.testing.assert_allclose(T_g[:, :3, 3], T_w[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(T_g[:, :3, :3], T_w[:, :3, :3], rtol=0, atol=1e-5)
    assert abs(int(got["iterations"]) - int(want["iterations"])) <= 1
    assert int(got["iterations"]) >= int(ungated["iterations"])


def gated_need(src, tgt, T_init, weight, cfg) -> tuple[list, dict]:
    """The gated solve with each stripe call's ``refresh`` recorded, and
    the gate recomputed from the GN steps' deltas, one iteration at a time."""
    icp_module = importlib.import_module("mm_masking_tpu_torch.dicp.icp")
    calls = []
    stripe_call = icp_module.nn_argmin_stripe_presorted

    def spy(*a, refresh=None, **kw):
        calls.append(refresh.clone())
        return stripe_call(*a, refresh=refresh, **kw)

    deltas = []
    gn_step = icp_module._gn_step

    def gn_spy(*a, **kw):
        T_new, delta = gn_step(*a, **kw)
        deltas.append(delta.clone())
        return T_new, delta

    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init))
    with mock.patch.object(icp_module, "nn_argmin_stripe_presorted", spy), \
            mock.patch.object(icp_module, "_gn_step", gn_spy):
        out = icp(*args, weight=torch.from_numpy(weight), cfg=ICPConfig(**cfg))
    want, moved = [], torch.full((len(src),), float("inf"))
    for it, delta in enumerate(deltas):
        go = it < int(out["iterations"])
        need = (torch.full_like(moved, go, dtype=torch.bool)
                & ((it == 0) | (moved >= cfg["nn_refresh_dist"])))
        want.append(need)
        motion = delta[:, :3].norm(dim=-1) + cfg["nn_refresh_range"] * delta[:, 3:].norm(dim=-1)
        if go:
            moved = torch.where(need, 0.0, moved) + motion
    return list(zip(calls, want)), out


def test_gated_stripe_call_skips_items_without_need():
    """Every stripe call of the gated solve gets refresh = need: true at the
    first iteration and after an item has moved nn_refresh_dist, false
    otherwise (those items get no blocks and keep their cached idx), and
    false for all once the solve has stopped inside a chunk."""
    src, tgt, T_init, weight = staggered_scene()
    cfg = dict(GATED, icp_type="pt2pt", nn_stripe=True, nn_refresh_range=80.0)
    pairs, out = gated_need(src, tgt, T_init, weight, cfg)
    assert len(pairs) == -(-int(out["iterations"]) // 5) * 5
    for it, (got, want) in enumerate(pairs):
        assert torch.equal(got, want), it
    skipped = sum(int((~g).sum()) for g, _ in pairs[:int(out["iterations"])])
    assert pairs[0][0].all() and skipped > len(src) * 5
    assert not pairs[-1][0].any()


@pytest.mark.parametrize("stripe", [True, False])
def test_chunked_gated_solve_matches_the_per_iteration_loop(monkeypatch, stripe):
    """The gated solve in chunks of STOP_TEST_EVERY against chunks of 1:
    T, delta_norm and iterations bit for bit, and the stop test read at
    most ⌈50/5⌉ times; the iterations of a chunk after the stop change
    nothing."""
    icp_module = importlib.import_module("mm_masking_tpu_torch.dicp.icp")
    src, tgt, T_init, weight = staggered_scene()
    cfg = ICPConfig(**GATED, icp_type="pt2pt", nn_stripe=stripe)
    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init))
    got = icp(*args, weight=torch.from_numpy(weight), cfg=cfg)
    assert got["stop_tests"] <= math.ceil(50 / icp_module.STOP_TEST_EVERY)
    assert int(got["iterations"]) % icp_module.STOP_TEST_EVERY
    monkeypatch.setattr(icp_module, "STOP_TEST_EVERY", 1)
    loop = icp(*args, weight=torch.from_numpy(weight), cfg=cfg)
    for name in ("T", "delta_norm", "iterations"):
        assert torch.equal(got[name], loop[name]), name


@pytest.mark.parametrize(
    "icp_type,stripe", [("pt2pt", False), ("pt2pt", True), ("pt2pl", False), ("pt2pl", True)])
def test_unrolled_icp_weight_gradient_matches_jax(icp_type, stripe):
    """∂(Σ c·T)/∂weight through 3 unrolled iterations, both packages."""
    src, tgt, T_init, weight = scene(seed=7, B=2, N=128, M=1024)
    cfg = dict(icp_type=icp_type, max_iterations=3, differentiable=True, nn_stripe=stripe,
               nn_stripe_window=256, nn_stripe_tile=64)
    cot = np.random.default_rng(8).standard_normal((2, 4, 4)).astype(np.float32)

    def jloss(w):
        out = jicp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(T_init), weight=w,
                   cfg=JICPConfig(**cfg))
        return jnp.sum(out["T"] * cot), out

    (_, j_out), j_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(weight))
    w = torch.from_numpy(weight).requires_grad_(True)
    out = icp(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init),
              weight=w, cfg=ICPConfig(**cfg))
    (t_grad,) = torch.autograd.grad((out["T"] * torch.from_numpy(cot)).sum(), (w,))
    assert out["delta_norms"].shape == (3, 2)
    np.testing.assert_allclose(out["delta_norms"].detach().numpy(),
                               np.asarray(j_out["delta_norms"]), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(out["T"].detach().numpy(), np.asarray(j_out["T"]),
                               rtol=0, atol=1e-5)
    j_grad = np.asarray(j_grad)
    assert np.abs(j_grad).max() > 0
    np.testing.assert_allclose(t_grad.numpy(), j_grad, rtol=0,
                               atol=1e-3 * np.abs(j_grad).max())


def run_scene(seed, B=2, M=2048, n_real=1900, trim=3.0):
    """A planar corridor map (x spans 120 m, y 10 m, so the stripe keys on x)
    with normals and pad rows, and a scan of 4 dense clusters of 64 points,
    248 points strewn over the map's upper half and 8 points 15 m off it
    (past trim), taken through a small planar pose and sorted by x, the key
    at the identity initial guess: the stripe keeps the scan's row order.
    Returns (src, tgt, T_init, weight)."""
    rng = np.random.default_rng(seed)
    q = np.full((B, M, 6), TARGET_PAD_VAL, np.float32)
    q[:, :n_real, 0] = np.sort(rng.uniform(-60, 60, (B, n_real)), axis=1)
    q[:, :n_real, 1] = rng.uniform(-5, 5, (B, n_real))
    q[:, :n_real, 2] = 0.0
    ang = rng.uniform(0, 2 * np.pi, (B, n_real))
    q[:, :n_real, 3:6] = np.stack([np.cos(ang), np.sin(ang), np.zeros_like(ang)], -1)
    picks = np.concatenate([np.arange(c, c + 64) for c in (100, 400, 700, 900)]
                           + [np.linspace(1000, n_real - 1, 248).astype(int)])
    pts = q[:, picks, :3] + rng.normal(0, 0.01, (B, len(picks), 3)).astype(np.float32)
    off = q[:, rng.choice(np.arange(1000, n_real), 8), :3] + np.float32([0.0, 15.0, 0.0])
    pts = np.concatenate([pts, off], 1)
    xi = np.zeros((B, 6), np.float32)
    xi[:, :2] = rng.uniform(-0.4, 0.4, (B, 2))
    xi[:, 5] = rng.uniform(-0.05, 0.05, B)
    T_gt_inv = torch.linalg.inv(se3_exp(torch.from_numpy(xi))).numpy()
    src = np.einsum("bij,bnj->bni", T_gt_inv[:, :3, :3], pts) + T_gt_inv[:, None, :3, 3]
    src[..., 2] = 0.0
    src = np.take_along_axis(src, np.argsort(src[..., 0], axis=1, kind="stable")[..., None], 1)
    src = np.ascontiguousarray(src, dtype=np.float32)
    weight = rng.uniform(0.2, 1.0, src.shape[:2]).astype(np.float32)
    T_init = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    return src, q, T_init, weight


@pytest.mark.parametrize("icp_type", ["pt2pt", "pt2pl"])
def test_stripe_runs_give_the_dense_solve_bit_for_bit(icp_type):
    """With each stripe tile scanning its own run of map blocks (runs past
    the old budget among them), the planar solve is the dense association's
    bit for bit: the tolerance-stopped solve's T, iterations and delta_norm,
    and the unrolled solve's T and gradient with respect to the weights.
    Every row with a neighbour within trim gets the dense neighbour; every
    other row is inactive either way."""
    src, tgt, T_init, weight = run_scene(seed=31 if icp_type == "pt2pt" else 32)
    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init))
    base = dict(icp_type=icp_type, trim_dist=3.0, dim=2, nn_stripe_window=128,
                nn_stripe_tile=64)
    q_s, key_s, use_x = tnn.stripe_sort_target(args[1])
    assert use_x.all()  # the scan is sorted by the key: the solve keeps its rows' order
    _, nblk = tnn.stripe_blocks(args[0], key_s, use_x, 3.0, 64, 128)
    assert (nblk > 128 // 128 + 1).any() and (nblk <= 2).any()  # some tiles over the window
    solve = dict(base, max_iterations=50, tolerance=1e-5, differentiable=False)
    got = icp(*args, weight=torch.from_numpy(weight), cfg=ICPConfig(**solve, nn_stripe=True))
    want = icp(*args, weight=torch.from_numpy(weight), cfg=ICPConfig(**solve, nn_stripe=False))
    assert 0 < int(want["iterations"]) < 50
    for name in ("T", "iterations", "delta_norm"):
        assert torch.equal(got[name], want[name]), name
    cot = torch.from_numpy(np.random.default_rng(33).standard_normal((2, 4, 4)).astype(np.float32))
    unrolled = dict(base, max_iterations=5, differentiable=True)
    outs = []
    for stripe in (True, False):
        w = torch.from_numpy(weight).requires_grad_(True)
        out = icp(*args, weight=w, cfg=ICPConfig(**unrolled, nn_stripe=stripe))
        (grad,) = torch.autograd.grad((out["T"] * cot).sum(), (w,))
        outs.append((out["T"].detach(), grad))
    (T_s, g_s), (T_d, g_d) = outs
    assert torch.equal(T_s, T_d) and torch.equal(g_s, g_d)
    assert g_d.abs().max() > 0


@pytest.mark.parametrize("damped_dead", [False, True])
def test_solve3x3_backward_matches_jax(damped_dead):
    """The adjoint backward vs the JAX custom VJP; on a near-dead damped
    system (A ≈ 1e-9·I) both stay finite, where autograd through the
    cofactor arithmetic overflows."""
    rng = np.random.default_rng(9)
    if damped_dead:
        A = np.broadcast_to(np.eye(3, dtype=np.float32) * 1e-9, (4, 3, 3)).copy()
        A += rng.standard_normal((4, 3, 3)).astype(np.float32) * 1e-12
    else:
        M = rng.standard_normal((4, 3, 3)).astype(np.float32)
        A = M @ M.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)
    b = rng.standard_normal((4, 3)).astype(np.float32) * 1e-6
    g = rng.standard_normal((4, 3)).astype(np.float32)
    _, vjp = jax.vjp(jsolve3x3, jnp.asarray(A), jnp.asarray(b))
    jA, jb = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    At = torch.from_numpy(A).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    tA, tb = torch.autograd.grad(_solve3x3(At, bt), (At, bt), torch.from_numpy(g))
    assert torch.isfinite(tA).all() and torch.isfinite(tb).all()
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-4, atol=0)
    np.testing.assert_allclose(tA.numpy(), jA, rtol=1e-4, atol=1e-6 * np.abs(jA).max())


def test_icp_config_fields_match_jax():
    assert dataclasses.asdict(ICPConfig()) == dataclasses.asdict(JICPConfig())


@pytest.mark.parametrize("icp_type,limit", [("pt2pt", 1e-4), ("pt2pl", 1e-3)])
def test_icp_implicit_matches_jax(icp_type, limit):
    """The solve to tolerance and its implicit-function-theorem gradient
    (the stripe association in the forward, the dense one in the backward,
    as in JAX): the pose within the ICP tests' 1e-4 m / 1e-5 rad; the
    backward at JAX's own pose within 1e-6 of max |g| of JAX's; and
    ∂(Σ c·T)/∂weight against jax.grad within ``limit`` of max |g|. The last
    carries the two poses' difference (1.4e-7 here): pt2pl's gradient is
    −λᵀm(Jᵀr) with r the point-to-plane residual, and at the fixed point
    many residuals are near 0, so it moves 1.8e-4 of max |g| with it."""
    src, tgt, T_init, weight = scene(seed=7 if icp_type == "pt2pt" else 6, B=2, N=128, M=1024)
    cfg = dict(icp_type=icp_type, max_iterations=50, tolerance=1e-5, nn_stripe=True,
               nn_stripe_window=256, nn_stripe_tile=64)
    cot = np.random.default_rng(8).standard_normal((2, 4, 4)).astype(np.float32)

    def jloss(w):
        T = jicp_implicit(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(T_init), w,
                          JICPConfig(**cfg))
        return jnp.sum(T * cot), T

    (_, T_w), j_grad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(weight))
    w = torch.from_numpy(weight).requires_grad_(True)
    T = icp_implicit(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init), w,
                     ICPConfig(**cfg))
    (t_grad,) = torch.autograd.grad((T * torch.from_numpy(cot)).sum(), (w,))
    T_w, T_g = np.asarray(T_w), T.detach().numpy()
    np.testing.assert_allclose(T_g[:, :3, 3], T_w[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(T_g[:, :3, :3], T_w[:, :3, :3], rtol=0, atol=1e-5)
    j_grad = np.asarray(j_grad)
    scale = np.abs(j_grad).max()
    assert scale > 0 and torch.isfinite(t_grad).all()
    np.testing.assert_allclose(t_grad.numpy(), j_grad, rtol=0, atol=limit * scale)
    # The backward alone, at JAX's pose.
    *_, j_at = jimplicit_bwd(JICPConfig(**cfg), (jnp.asarray(src), jnp.asarray(tgt),
                                                 jnp.asarray(T_w), jnp.asarray(weight)),
                             jnp.asarray(cot))
    t_at = _implicit_weight_grad(torch.from_numpy(src), torch.from_numpy(tgt),
                                 torch.from_numpy(T_w.copy()), torch.from_numpy(weight),
                                 torch.from_numpy(cot), ICPConfig(**cfg))
    np.testing.assert_allclose(t_at.numpy(), np.asarray(j_at), rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("refresh", [0.0, 0.05])
@pytest.mark.parametrize("stripe", [True, False])
def test_frozen_solve_equals_the_host_tested_solve(stripe, refresh):
    """icp_implicit's forward runs every iteration with each item frozen on
    the device (no host read, so it can sit in a captured train step); its
    pose is the chunked, host-tested solve's bit for bit, on items that stop
    at different iterations, ungated and motion-gated. (The stripe's plain
    version, which the CPU runs, reads its block counts on the host; K4
    does not, so the read check runs on the dense path.)"""
    src, tgt, T_init, weight = staggered_scene()
    cfg = ICPConfig(icp_type="pt2pt", max_iterations=50, tolerance=1e-5, differentiable=False,
                    nn_stripe=stripe, nn_stripe_window=512, nn_stripe_tile=64,
                    nn_refresh_dist=refresh)
    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init),
            torch.from_numpy(weight))
    want = icp(*args[:3], weight=args[3], cfg=cfg)
    assert want["stop_tests"] > 0 and int(want["iterations"]) < 50
    with contextlib.nullcontext() if stripe else no_host_reads():
        got = _solve_frozen(*args, cfg)
    assert torch.equal(got, want["T"])


def test_icp_class_is_icp():
    """The ICP wrapper (the reference's construction pattern) runs icp with
    its settings: the same result as icp, and as the JAX class's."""
    src, tgt, T_init, weight = scene(seed=3, B=2, N=128, M=1024)
    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init))
    solver = ICP(icp_type="pt2pl", differentiable=False, max_iterations=30)
    got = solver.icp(*args, weight=torch.from_numpy(weight), trim_dist=4.0,
                     loss_fn={"name": "huber", "metric": 0.5})
    want = icp(*args, weight=torch.from_numpy(weight), cfg=ICPConfig(
        icp_type="pt2pl", differentiable=False, max_iterations=30, trim_dist=4.0,
        loss_name="huber", loss_metric=0.5, dim=2))
    for name in ("T", "delta_norm", "iterations"):
        assert torch.equal(got[name], want[name]), name
    jgot = JICP(icp_type="pt2pl", differentiable=False, max_iterations=30).icp(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(T_init), weight=jnp.asarray(weight),
        trim_dist=4.0, loss_fn={"name": "huber", "metric": 0.5})
    np.testing.assert_allclose(got["T"].numpy(), np.asarray(jgot["T"]), rtol=0, atol=1e-4)
