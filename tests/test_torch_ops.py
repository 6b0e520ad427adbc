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
from mm_masking_tpu_torch.models.unet import upsample_bilinear_align_corners
from mm_masking_tpu_torch.ops.kernels import resample

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


def lookup_inputs(rng, dtype: str):
    """Image (2, H, W) and normalised points (2, 48, 2) for the lookup's
    gradient: points inside and around the image, 6 pad points at
    (-100, -100), points 16..23 exact copies of 0..7 (every tap coincides)
    and 24..31 moved within the cells of 0..7 (the same pixels, other
    weights). float32: uniform coordinates on a 13 x 19 image. bfloat16: a
    17 x 17 image and pixel coordinates on a grid of 1/8 pixel, which
    bfloat16 and the unnormalisation hold exactly in both packages, so that
    the test compares the backward's sums and not the rounding of the
    coordinates."""
    if dtype == "float32":
        H, W = 13, 19
        pts = rng.uniform(-1.2, 1.2, (2, 48, 2))
        pts[:, 24:32] = pts[:, 0:8] + 0.3 / np.array([W - 1, H - 1])
    else:
        H = W = 17
        pts = rng.integers(-12, 8 * 16 + 12, (2, 48, 2)) / 64.0 - 1.0
        pts[:, 24:32] = pts[:, 0:8] + 1 / 64
    pts[:, 16:24] = pts[:, 0:8]
    pts[:, -6:] = -100.0
    img = rng.random((2, H, W))
    return img.astype(np.float32), pts.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_sample_points_gradient_matches_jax(dtype):
    """The port's autograd of the point lookup (on the CPU the gather-form
    backward's plain version, grid_sampler_2d_backward) against jax.vjp of
    the JAX lookup with respect to the image, on the same numpy inputs.
    Limits: float32 within 1e-6 of max |g| (the same products summed in
    another order); bfloat16 within 1e-2 of max |g| (both round each product
    and partial sum to 8 bits, in other orders). Pad points contribute
    nothing on either side."""
    rng = np.random.default_rng(23)
    img, pts = lookup_inputs(rng, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    cot = rng.standard_normal(pts.shape[:2]).astype(np.float32)
    cot_pad = cot.copy()
    cot_pad[:, -6:] = 0.0
    coords_j = jnp.asarray(pts).astype(jdt)
    grads = []
    for c in (cot, cot_pad):
        _, vjp = jax.vjp(lambda im: jops.grid_sample_points(im, coords_j, align_corners=True),
                         jnp.asarray(img).astype(jdt))
        grads.append(np.asarray(vjp(jnp.asarray(c).astype(jdt))[0].astype(jnp.float32)))
    want, want_pad = grads
    np.testing.assert_array_equal(want, want_pad)  # the pad points reach no pixel
    it = torch.from_numpy(img).to(tdt).requires_grad_(True)
    out = tops.grid_sample_points(it, torch.from_numpy(pts).to(tdt), align_corners=True)
    (got,) = torch.autograd.grad(out, it, torch.from_numpy(cot).to(tdt))
    assert got.dtype == tdt and got.shape == it.shape
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_gather_backward_plain_versions_are_bitwise_repeatable():
    """Two backward runs of the upsample and of the point lookup on the CPU
    (the kernels' plain versions) give the same bits."""
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.standard_normal((2, 3, 10, 12)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 3, 20, 24)).astype(np.float32))
    img, pts = lookup_inputs(rng, "float32")
    img_t, pts_t = torch.from_numpy(img), torch.from_numpy(pts)
    cot_p = torch.from_numpy(rng.standard_normal(pts.shape[:2]).astype(np.float32))

    def grads():
        xr, ir = x.clone().requires_grad_(True), img_t.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(upsample_bilinear_align_corners(xr, (20, 24)), xr, cot)
        (gi,) = torch.autograd.grad(tops.grid_sample_points(ir, pts_t), ir, cot_p)
        return gx, gi

    for a, b in zip(grads(), grads()):
        assert torch.equal(a, b)


def test_grid_sample_points_gives_the_coordinates_gradient():
    """The lookup's Function returns the coordinates' gradient (per point,
    ATen's own) where they require one, equal to F.grid_sample's."""
    rng = np.random.default_rng(25)
    img, pts = lookup_inputs(rng, "float32")
    img_t = torch.from_numpy(img)
    cot = torch.from_numpy(rng.standard_normal(pts.shape[:2]).astype(np.float32))
    c1 = torch.from_numpy(pts).requires_grad_(True)
    (got,) = torch.autograd.grad(tops.grid_sample_points(img_t, c1), c1, cot)
    c2 = torch.from_numpy(pts).requires_grad_(True)
    ref = torch.nn.functional.grid_sample(img_t[:, None], c2[:, :, None, :],
                                          align_corners=True)[:, 0, :, 0]
    (want,) = torch.autograd.grad(ref, c2, cot)
    assert torch.equal(got, want)


def edge_lookup_inputs(rng, N=2, H=170, W=300, P=640):
    """Image (N, H, W), normalised points (N, P, 2) and a cotangent for the
    lookup backward's ordered reference and binning: points straddling the
    kernel's bin edges (columns k·BIN_W − 1 | k·BIN_W, rows k·BIN_H − 1 |
    k·BIN_H) and the image's border, some on an edge pixel exactly, some
    uniform over and around the image, copies (every tap coincides), and
    every seventh a pad point at (−100, −100)."""
    xs = [k * resample.BIN_W - 1.0 for k in range(W // resample.BIN_W + 1)] + [-1.0, W - 1.0]
    ys = [k * resample.BIN_H - 1.0 for k in range(H // resample.BIN_H + 1)] + [-1.0, H - 1.0]
    ix = rng.choice(xs, (N, P)) + rng.random((N, P))
    iy = rng.choice(ys, (N, P)) + rng.random((N, P))
    ix[:, 1::5], iy[:, 2::5] = np.ceil(ix[:, 1::5]), np.ceil(iy[:, 2::5])
    ix[:, 3::5], iy[:, 3::5] = rng.uniform(-2, W + 1, (N, P))[:, 3::5], rng.uniform(
        -2, H + 1, (N, P))[:, 3::5]
    pts = np.stack([ix / (W - 1) * 2 - 1, iy / (H - 1) * 2 - 1], -1)
    pts[:, P // 2:P // 2 + P // 8] = pts[:, 0:P // 8]
    pts[:, ::7] = -100.0
    img = rng.random((N, H, W))
    cot = rng.standard_normal((N, P))
    return img.astype(np.float32), pts.astype(np.float32), cot.astype(np.float32)


def test_ordered_lookup_backward_matches_jax_vjp():
    """The lookup backward's ordered reference (the CUDA kernel's sums in
    plain PyTorch) against jax.vjp of the JAX lookup with respect to the
    image, on the same numpy inputs, within 1e-6 of max |g| (the same
    float32 products summed in another order)."""
    img, pts, cot = edge_lookup_inputs(np.random.default_rng(26))
    _, vjp = jax.vjp(lambda im: jops.grid_sample_points(im, jnp.asarray(pts), align_corners=True),
                     jnp.asarray(img))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    got = resample.bilinear_points_bwd_ordered(torch.from_numpy(cot), torch.from_numpy(img),
                                               torch.from_numpy(pts))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape", [(2, 170, 300, 640), (3, 13, 19, 64)])
def test_ordered_lookup_backward_matches_float64(shape, align_corners):
    """The ordered reference against a float64 sum of the same taps (pixel
    coordinates and weights formed in float32 as ATen forms them, exact in
    float64): each pixel within (n + 2)·2⁻²⁴·Σ|terms| of it, n its taps
    (two roundings a product, one a sum), and pad points reach nothing."""
    N, H, W, P = shape
    img, pts, cot = edge_lookup_inputs(np.random.default_rng(27), N, H, W, P)
    dout, image, coords = map(torch.from_numpy, (cot, img, pts))
    got = resample.bilinear_points_bwd_ordered(dout, image, coords, align_corners)
    cols, rows, ok, w = resample._taps(coords, H, W, align_corners)
    flat = (torch.arange(N)[:, None, None] * H * W + rows * W + cols)[ok]
    terms = (w.double() * dout.double()[..., None])[ok]
    ref, mass, n = (torch.zeros(N * H * W, dtype=torch.float64).index_add_(0, flat, v)
                    for v in (terms, terms.abs(), torch.ones_like(terms)))
    assert ((got.double().flatten() - ref).abs() <= (n + 2) * 2.0 ** -24 * mass).all()
    pad = coords[..., 0] == -100.0
    assert pad.any() and not ok[pad].any()
    no_pads = dout.masked_fill(pad, 0.0)
    assert torch.equal(got, resample.bilinear_points_bwd_ordered(no_pads, image, coords,
                                                                 align_corners))


def test_lookup_binning_rule():
    """The kernel's binning in plain PyTorch: every tap in the image is in
    exactly one list entry, of its bin, in its point's chunk; a point's
    taps in one bin share one entry; each bin's list ascends in p; pad
    points are in no list; the starts bound each chunk's lists."""
    N, H, W, P = 2, 250, 390, 700
    img, pts, _ = edge_lookup_inputs(np.random.default_rng(28), N, H, W, P)
    coords = torch.from_numpy(pts)
    lists, starts = resample.bin_points_plain(coords, H, W)
    G, bins = resample.lookup_layout(N, P, H, W)
    assert lists.shape == (N, G, 4 * resample.CHUNK) and starts.shape == (N, bins + 1, G)
    cols, rows, ok, _ = resample._taps(coords, H, W, True)
    bin_of = rows // resample.BIN_H * -(-W // resample.BIN_W) + cols // resample.BIN_W
    entries = set()
    for n in range(N):
        for g in range(G):
            s = starts[n, :, g].tolist()
            assert s[0] == 0 and s == sorted(s) and (lists[n, g, s[-1]:] == -1).all()
            for t in range(bins):
                ps = lists[n, g, s[t]:s[t + 1]].tolist()
                assert ps == sorted(set(ps))
                assert all(g * resample.CHUNK <= p < (g + 1) * resample.CHUNK for p in ps)
                entries |= {(n, p, t) for p in ps}
    taps = {(n, p, bin_of[n, p, j].item()) for n, p, j in ok.nonzero().tolist()}
    assert entries == taps  # each (point, bin) once: its first tap in the bin
    pads = (coords[..., 0] == -100.0).nonzero().tolist()
    assert pads and not any((n, p) == (e[0], e[1]) for n, p in pads for e in entries)
