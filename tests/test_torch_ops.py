"""PyTorch port vs the JAX package: geometry, sampling, radar warp, CFAR and
the per-point weight lookup. The same numpy inputs go to both; atol 1e-5
(float32 rounding of the same formulas in another order)."""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu import config as jcfg
from mm_masking_tpu import geom as jgeom
from mm_masking_tpu import ops as jops
from mm_masking_tpu_torch import config as tcfg
from mm_masking_tpu_torch import geom as tgeom
from mm_masking_tpu_torch import ops as tops

ATOL = 1e-5


def close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("scale", [0.0, 1e-5, 3e-3, 0.4, 2.5])
def test_se3_matches_jax(scale):
    rng = np.random.default_rng(0)
    xi = (rng.standard_normal((5, 6)) * scale).astype(np.float32)
    xi[:, :3] = rng.uniform(-20, 20, (5, 3))
    pts = rng.uniform(-50, 50, (5, 7, 3)).astype(np.float32)
    T_j = jgeom.se3_exp(jnp.asarray(xi))
    T_t = tgeom.se3_exp(torch.from_numpy(xi))
    close(T_t, T_j)
    close(tgeom.so3_exp(torch.from_numpy(xi[:, 3:])), jgeom.so3_exp(jnp.asarray(xi[:, 3:])))
    close(tgeom.so3_left_jacobian(torch.from_numpy(xi[:, 3:])),
          jgeom.so3_left_jacobian(jnp.asarray(xi[:, 3:])))
    close(tgeom.se3_inv(T_t), jgeom.se3_inv(T_j), atol=1e-4)
    close(tgeom.transform_points(T_t, torch.from_numpy(pts)),
          jgeom.transform_points(T_j, jnp.asarray(pts)), atol=1e-4)
    for got, want in zip(tgeom.planar_xi_first_order(T_t),
                         jgeom.planar_xi_first_order(T_j)):
        close(got, want)
    close(tgeom.hat3(torch.from_numpy(xi[:, :3])), jgeom.hat3(jnp.asarray(xi[:, :3])))


@pytest.mark.parametrize("fn", ["se3_exp", "so3_exp", "so3_left_jacobian"])
@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.4])
def test_se3_gradients_match_jax(fn, scale):
    """Gradients under a random cotangent, finite at δ = 0 (the double
    ``where`` guard of the small-angle branch) and equal to JAX's."""
    rng = np.random.default_rng(11)
    dim = 6 if fn == "se3_exp" else 3
    xi = (rng.standard_normal((4, dim)) * scale).astype(np.float32)
    if fn == "se3_exp":
        xi[:, :3] = rng.uniform(-2, 2, (4, 3))
    cot = rng.standard_normal((4, 4, 4) if fn == "se3_exp" else (4, 3, 3)).astype(np.float32)
    (want,) = jax.grad(lambda v: jnp.sum(getattr(jgeom, fn)(v) * cot), argnums=(0,))(
        jnp.asarray(xi))
    t = torch.from_numpy(xi).requires_grad_(True)
    (got,) = torch.autograd.grad((getattr(tgeom, fn)(t) * torch.from_numpy(cot)).sum(), (t,))
    assert torch.isfinite(got).all()
    close(got, want)


def test_extract_bev_from_pts_matches_jax():
    rng = np.random.default_rng(12)
    pc = rng.uniform(-12, 12, (2, 300, 3)).astype(np.float32)
    pc[:, -20:] = 0.0  # pad rows
    pc[:, :10, :2] = rng.uniform(40, 60, (10, 2))  # outside the image
    want = jops.extract_bev_from_pts(jnp.asarray(pc), cart_pixel_width=64, cart_resolution=0.4)
    got = tops.extract_bev_from_pts(torch.from_numpy(pc), cart_pixel_width=64,
                                    cart_resolution=0.4)
    assert got.shape == (2, 64, 64) and 0 < float(got.sum()) < 2 * 4 * 300
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_jax(align_corners):
    rng = np.random.default_rng(1)
    img = rng.random((2, 3, 9, 11)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 5, 4, 2)).astype(np.float32)
    close(tops.grid_sample_2d(torch.from_numpy(img), torch.from_numpy(grid),
                              align_corners=align_corners),
          jops.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid),
                              align_corners=align_corners))
    pts = rng.uniform(-1.2, 1.2, (2, 13, 2)).astype(np.float32)
    close(tops.grid_sample_points(torch.from_numpy(img[:, 0]), torch.from_numpy(pts),
                                  align_corners=align_corners),
          jops.grid_sample_points(jnp.asarray(img[:, 0]), jnp.asarray(pts),
                                  align_corners=align_corners))


@pytest.mark.parametrize("fix_wobble", [True, False])
def test_polar_to_cartesian_matches_jax(fix_wobble):
    rng = np.random.default_rng(2)
    B, A, R, W = 2, 48, 96, 40
    fft = rng.random((B, A, R)).astype(np.float32)
    # Non-uniform encoder azimuths (the "wobble" the searchsorted path fixes).
    az = np.linspace(0, 2 * np.pi * (A - 1) / A, A) + rng.uniform(-0.01, 0.01, (B, A))
    az = np.sort(az, axis=1).astype(np.float32)
    kw = dict(radar_resolution=0.25, cart_resolution=0.5, cart_pixel_width=W,
              fix_wobble=fix_wobble)
    close(tops.radar_polar_to_cartesian(torch.from_numpy(fft), torch.from_numpy(az), **kw),
          jops.radar_polar_to_cartesian(jnp.asarray(fft), jnp.asarray(az), **kw))
    r_t, a_t = tops.form_cart_range_angle_grid(0.5, W)
    r_j, a_j = jops.form_cart_range_angle_grid(0.5, W)
    close(r_t, r_j)
    close(a_t, a_j)


@pytest.mark.parametrize("min_to_plus_1", [True, False])
def test_point_to_cart_idx_matches_jax(min_to_plus_1):
    pc = np.random.default_rng(3).uniform(-30, 30, (2, 17, 3)).astype(np.float32)
    close(tops.point_to_cart_idx(torch.from_numpy(pc), 0.5, 64, min_to_plus_1),
          jops.point_to_cart_idx(jnp.asarray(pc), 0.5, 64, min_to_plus_1), atol=1e-4)


@pytest.mark.parametrize("res,R", [(0.0596, 1400), (0.25, 256)])
@pytest.mark.parametrize("diff", [True, False])
def test_cfar_mask_matches_jax(res, R, diff):
    # (0.25, 256): the valid band's windows reach past the last bin, which
    # the reference reads as NaN (no detection).
    rng = np.random.default_rng(4)
    x = (0.05 * rng.random((2, 6, R)) ** 2).astype(np.float32)
    hits = rng.integers(0, R, (2, 6, 12))
    np.put_along_axis(x, hits, rng.uniform(0.6, 1.0, hits.shape).astype(np.float32), 2)
    close(tops.cfar_mask(torch.from_numpy(x), res, diff=diff),
          jops.cfar_mask(jnp.asarray(x), res, diff=diff))


def test_extract_weights_matches_jax():
    rng = np.random.default_rng(5)
    mask = rng.random((2, 64, 64)).astype(np.float32)
    pc = rng.uniform(-20, 20, (2, 50, 3)).astype(np.float32)
    pc[:, 40:] = 0.0  # pad rows
    pc[0, 3, :2] = 200.0  # outside the image
    w_t, s_t = tops.extract_weights(torch.from_numpy(mask), torch.from_numpy(pc), 0.5, 64)
    w_j, s_j = jops.extract_weights(jnp.asarray(mask), jnp.asarray(pc), 0.5, 64)
    close(w_t, w_j)
    assert (w_t[:, 40:] == 0).all()
    for f in s_t._fields:
        close(getattr(s_t, f).float(), getattr(s_j, f), atol=1e-4)


def test_config_from_dict_loads_jax_config_json():
    cfg = jcfg.Config(model=jcfg.ModelConfig(enc_channels=(4, 8), dtype="bfloat16",
                                             icp_overrides=("damping_rel=0",)),
                      train=jcfg.TrainConfig(batch_size_test=4))
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    port = tcfg.Config.from_dict(d)
    assert dataclasses.asdict(port) == dataclasses.asdict(jcfg.Config.from_dict(d))
    assert port.model.torch_dtype == torch.bfloat16
    assert dataclasses.asdict(tcfg.Config()) == dataclasses.asdict(jcfg.Config())
