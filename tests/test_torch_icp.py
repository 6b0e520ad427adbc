"""PyTorch port's ICP vs the JAX package's ``icp`` on the CPU.

Converging planar scenes; the stripe association is forced on at a small
window. The two solvers differ only in float32 reduction order and in the
association's distance form, so converged poses agree to 1e-4 m / 1e-5 rad
and iteration counts to within one. The unrolled differentiable solver is
held to ``jax.grad``: ∂T/∂weight within 1e-3 of its largest entry.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.dicp import ICPConfig as JICPConfig, icp as jicp
from mm_masking_tpu.dicp.icp import _solve3x3 as jsolve3x3
from mm_masking_tpu_torch.dicp import TARGET_PAD_VAL, ICPConfig, icp, icp_implicit
from mm_masking_tpu_torch.dicp.icp import _solve3x3
from mm_masking_tpu_torch.geom import se3_exp


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


@pytest.mark.parametrize("mode", ["nn_refresh", "implicit"])
def test_icp_refuses_unported_modes(mode):
    src, tgt, T_init, _ = scene(seed=5, B=1, N=64, M=256)
    args = (torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(T_init))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if mode == "nn_refresh":
            icp(*args, cfg=ICPConfig(differentiable=False, nn_refresh_dist=0.05))
        else:
            icp_implicit(*args, None, ICPConfig(differentiable=False))


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
