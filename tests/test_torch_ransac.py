"""The port's MC-RANSAC (``ops/mcransac.py``), descriptors
(``ops/descriptors.py``) and their odometry front ends against the JAX
package's on the CPU, on the inputs of ``tests/test_mcransac.py`` and
``tests/test_descriptors.py``.

``jax.random`` bits have no torch counterpart, so the comparisons draw the
hypotheses with ``jax.random`` exactly as JAX's ``mcransac`` does and feed
them to the port's :func:`mcransac_from_hypotheses` (or, through the
odometry functions, in place of :func:`draw_hypotheses`). Limits: inliers,
``ok`` and matches equal; T within 1e-5 (the registration's ICP within
1e-4 m and 1e-5 on R). Descriptor words: a bit may differ from JAX's only
where the two samples it compares lie within 1e-5 of each other (float32
rounding of the bilinear sums decides it; none differs on these inputs).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_masking_tpu.ops.descriptors as jdesc
import mm_masking_tpu.ops.mcransac as jransac
from mm_masking_tpu.localization import odometry as jodo
from mm_masking_tpu_torch.localization import odometry
from mm_masking_tpu_torch.ops import descriptors, mcransac

RES, WIDTH = 0.25, 256


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_draws(B, N, iterations, key=None):
    """The hypotheses' indices as JAX's ``mcransac`` draws them."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0) if key is None else key)
    i1 = jax.random.randint(k1, (B, iterations), 0, N)
    off = jax.random.randint(k2, (B, iterations), 1, N)
    return (torch.from_numpy(np.array(i1)).long(),
            torch.from_numpy(np.array((i1 + off) % N)).long())


@pytest.fixture
def jax_hypotheses(monkeypatch):
    """The port's draws replaced by JAX's with PRNGKey(0), its default."""
    monkeypatch.setattr(mcransac, "draw_hypotheses",
                        lambda B, N, iterations, generator=None: jax_draws(B, N, iterations))


def make_matched(seed=0, B=3, N=256, outlier_frac=0.3, theta=0.2, t=(1.0, -0.5), noise=0.01):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (B, N, 2)).astype(np.float32)
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]], np.float32)
    tgt = src @ R.T + np.asarray(t, np.float32)
    tgt += rng.normal(0, noise, tgt.shape).astype(np.float32)
    n_out = int(outlier_frac * N)
    is_out = np.zeros((B, N), bool)
    for b in range(B):
        idx = rng.permutation(N)[:n_out]
        tgt[b, idx] += rng.uniform(2.0, 15.0, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
        is_out[b, idx] = True
    return src, tgt, is_out, R, np.asarray(t, np.float32)


def hold_ransac(got: dict, want: dict) -> None:
    np.testing.assert_array_equal(got["inliers"].numpy(), np.asarray(want["inliers"]))
    np.testing.assert_array_equal(got["ok"].numpy(), np.asarray(want["ok"]))
    np.testing.assert_allclose(got["inlier_frac"].numpy(), np.asarray(want["inlier_frac"]),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(got["T"].numpy(), np.asarray(want["T"]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["gross_outliers", "pads", "ratio_0.5"])
def test_mcransac_on_jax_hypotheses_matches_jax(case):
    if case == "pads":
        src, tgt, *_ = make_matched(seed=4, B=2, N=128)
        valid = np.ones((2, 128), bool)
        valid[:, -30:] = False
        src[:, -30:], tgt[:, -30:] = 0.0, 0.0
        key, cfg = jax.random.PRNGKey(2), {}
    else:
        src, tgt, *_ = make_matched()
        valid, key = None, jax.random.PRNGKey(1)
        cfg = {"inlier_ratio": 0.5} if case == "ratio_0.5" else {}
    want = jransac.mcransac(jnp.asarray(src), jnp.asarray(tgt),
                            None if valid is None else jnp.asarray(valid),
                            jransac.RansacConfig(**cfg), rng=key)
    i1, i2 = jax_draws(src.shape[0], src.shape[1], 100, key)
    got = mcransac.mcransac_from_hypotheses(
        torch.from_numpy(src), torch.from_numpy(tgt),
        None if valid is None else torch.from_numpy(valid), mcransac.RansacConfig(**cfg), i1, i2)
    hold_ransac(got, want)


def test_mcransac_draws_its_hypotheses_from_a_generator():
    """The port's own draws: two distinct indices a pair, the same draws from
    the same seed, and the pose of ``test_recovers_pose_under_gross_outliers``."""
    src, tgt, is_out, R, t = make_matched()
    i1, i2 = mcransac.draw_hypotheses(3, 256, 100)
    assert (i1 != i2).all() and ((i1 >= 0) & (i2 < 256)).all()
    j1, j2 = mcransac.draw_hypotheses(3, 256, 100, torch.Generator().manual_seed(0))
    assert torch.equal(i1, j1) and torch.equal(i2, j2)
    out = mcransac.mcransac(torch.from_numpy(src), torch.from_numpy(tgt))
    T = out["T"].numpy()
    for b in range(3):
        np.testing.assert_allclose(T[b, :2, :2], R, atol=5e-3)
        np.testing.assert_allclose(T[b, :2, 3], t, atol=2e-2)
    inl = out["inliers"].numpy()
    assert (inl & is_out).sum() == 0 and (~inl & ~is_out).mean() < 0.02


def test_ransac_filter_pc_matches_jax():
    pc = np.random.default_rng(0).normal(size=(2, 8, 3)).astype(np.float32)
    inl = np.asarray([[True] * 4 + [False] * 4, [False, True] * 4])
    np.testing.assert_array_equal(
        mcransac.ransac_filter_pc(torch.from_numpy(pc), torch.from_numpy(inl)).numpy(),
        np.asarray(jransac.ransac_filter_pc(jnp.asarray(pc), jnp.asarray(inl))))


def clutter_frame():
    """``test_register_frame_with_mcransac_flag``'s map and cluttered scan."""
    rng = np.random.default_rng(6)
    M, N, n_clutter = 2048, 256, 80
    map_pts = np.zeros((M, 3), np.float32)
    r, a = rng.uniform(3, 25, M), rng.uniform(0, 2 * np.pi, M)
    map_pts[:, 0], map_pts[:, 1] = r * np.cos(a), r * np.sin(a)
    sel = rng.permutation(M)[: N - n_clutter]
    c, s = np.cos(0.04), np.sin(0.04)
    T_true = np.eye(4)
    T_true[:2, :2] = [[c, -s], [s, c]]
    T_true[:2, 3] = (0.2, -0.1)
    T_rw = np.linalg.inv(T_true)
    scan = np.zeros((N, 3), np.float32)
    scan[: N - n_clutter] = map_pts[sel] @ T_rw[:3, :3].T + T_rw[:3, 3]
    scan += rng.normal(0, 0.01, scan.shape).astype(np.float32)
    cr, ca = rng.uniform(26, 35, n_clutter), rng.uniform(0, 2 * np.pi, n_clutter)
    scan[N - n_clutter:, 0], scan[N - n_clutter:, 1] = cr * np.cos(ca), cr * np.sin(ca)
    scan[:, 2] = 0.0
    return scan, map_pts, T_true


@pytest.mark.parametrize("init_icp", [False, True])
def test_register_frame_with_mcransac_matches_jax(jax_hypotheses, init_icp):
    scan, map_pts, T_true = clutter_frame()
    kw = dict(use_mcransac=True, mcransac_filter_pc=True, mcransac_tolerance=0.5,
              max_iterations=25, mcransac_init_icp=init_icp)
    want = np.asarray(jodo.register_frame(jnp.asarray(scan)[None], jnp.asarray(map_pts)[None],
                                          jnp.eye(4)[None], jodo.OdometryConfig(**kw)))[0]
    got = odometry.register_frame(torch.from_numpy(scan)[None], torch.from_numpy(map_pts)[None],
                                  torch.eye(4)[None], odometry.OdometryConfig(**kw))[0].numpy()
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], rtol=0, atol=1e-5)
    D = got @ np.linalg.inv(T_true)
    assert np.linalg.norm(D[:2, 3]) < 0.05 and abs(D[1, 0]) < 0.01


def test_teach_pass_with_mcransac_runs():
    """``use_mcransac`` in the teach pass: no longer refused, and on a
    clutter-free sequence every frame keeps its points."""
    scan, map_pts, _ = clutter_frame()
    tp = odometry.TeachPass(odometry.OdometryConfig(use_mcransac=True, max_map_pts=1024,
                                                    mcransac_tolerance=0.5))
    for _ in range(3):
        tp.process(torch.from_numpy(scan[:176]))
    assert np.isfinite(np.stack(tp.trajectory)).all() and tp.n_keyframes == 3
    np.testing.assert_allclose(np.stack(tp.trajectory)[:, :2, 3], 0.0, atol=1e-3)


# ------------------------------------------------------------- descriptors


def render(landmarks, jitter, seed):
    """``tests/test_descriptors.py``'s blob image with per-landmark lobes."""
    rng = np.random.default_rng(seed)
    r = (WIDTH - 1) / 2.0
    yy, xx = np.mgrid[0:WIDTH, 0:WIDTH]
    x, y = -(yy - r) * RES, (xx - r) * RES
    img = np.zeros((WIDTH, WIDTH), np.float32)
    for i, (lx, ly) in enumerate(landmarks):
        img += np.exp(-((x - lx) ** 2 + (y - ly) ** 2) / (2 * 0.6**2))
        for k in range(jitter.shape[1]):
            ox, oy = jitter[i, k]
            amp = 0.4 + 0.5 * ((i * 7 + k * 3) % 5) / 4.0
            sig = 0.3 + 0.15 * ((i + k) % 3)
            img += amp * np.exp(-((x - (lx + ox)) ** 2 + (y - (ly + oy)) ** 2) / (2 * sig**2))
    img += rng.normal(0, 0.01, img.shape).astype(np.float32)
    return img.astype(np.float32)


def make_pair(theta=0.35, t=(1.5, -0.8), n=24, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-18, 18, (n, 2)).astype(np.float32)
    jit = rng.uniform(-1.6, 1.6, (n, 4, 2)).astype(np.float32)
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]], np.float32)
    pts_b = pts @ R.T + np.asarray(t, np.float32)
    to3 = lambda p: np.concatenate([p, np.zeros((n, 1), np.float32)], 1)  # noqa: E731
    return (render(pts, jit, 1), to3(pts), render(pts_b, jit @ R.T, 2), to3(pts_b), R,
            np.asarray(t, np.float32))


@pytest.mark.parametrize("kind", ["orb", "basd"])
def test_descriptor_words_match_jax(kind):
    img, pts, *_ = make_pair()
    pts[-4:] = 0.0  # pads: all-zero words
    fn = "orb_descriptors" if kind == "orb" else "basd_descriptors"
    want = np.asarray(getattr(jdesc, fn)(jnp.asarray(img), jnp.asarray(pts), RES)).astype(np.int64)
    got = getattr(descriptors, fn)(torch.from_numpy(img), torch.from_numpy(pts), RES)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert (want[-4:] == 0).all() and (got[-4:] == 0).all()
    flips = (descriptors.unpack_bits(got) != descriptors.unpack_bits(torch.from_numpy(want)))
    if kind == "orb":
        _, a, b = descriptors.orb_bits(torch.from_numpy(img), torch.from_numpy(pts), RES)
        close = (a - b).abs() <= 1e-5
    else:
        ring = descriptors.basd_ring_means(torch.from_numpy(img), torch.from_numpy(pts), RES)
        adjacent = (ring[:, :-1] - ring[:, 1:]).abs() <= 1e-5
        vs_mean = (ring - ring.mean(-1, keepdim=True)).abs() <= 1e-5
        close = torch.nn.functional.pad(torch.cat([adjacent, vs_mean], 1), (0, 1))
    assert not (flips & ~close).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_match_descriptors_matches_jax():
    """Equal outputs on the same words: ORB words of the pair, shuffled, and
    random words from few patterns (ties in both directions), with pads."""
    img_a, pts_a, img_b, pts_b, *_ = make_pair(theta=0.3, t=(1.2, -0.7))
    perm = np.random.default_rng(7).permutation(24)
    da = np.asarray(jdesc.orb_descriptors(jnp.asarray(img_a), jnp.asarray(pts_a), RES))
    db = np.asarray(jdesc.orb_descriptors(jnp.asarray(img_b), jnp.asarray(pts_b[perm]), RES))
    rng = np.random.default_rng(3)
    base = rng.integers(0, 2**32, (5, 8), dtype=np.uint64).astype(np.uint32)
    ra, rb = base[rng.integers(0, 5, 40)], base[rng.integers(0, 5, 33)]
    ra[::3, 0] ^= np.uint32(1)
    cases = [(da, db, np.ones(24, bool), np.ones(24, bool), 0.95),
             (da, db, np.arange(24) % 5 != 0, np.arange(24) % 7 != 0, 1.0),
             (ra, rb, np.arange(40) % 4 != 0, np.ones(33, bool), 1.0),
             (ra, rb, np.ones(40, bool), np.arange(33) % 3 != 0, 0.8)]
    for a, b, va, vb, nndr in cases:
        ji, jok = jdesc.match_descriptors(*map(jnp.asarray, (a, b, va, vb)), nndr=nndr)
        ti, tok = descriptors.match_descriptors(
            torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64)),
            torch.from_numpy(va), torch.from_numpy(vb), nndr=nndr)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert descriptors.hamming(torch.from_numpy(ra.astype(np.int64)),
                               torch.from_numpy(rb.astype(np.int64))).max() <= 256


@pytest.mark.parametrize("kind", ["orb", "basd"])
def test_descriptor_bootstrap_matches_jax(jax_hypotheses, kind):
    img_a, pts_a, img_b, pts_b, R, t = make_pair(theta=0.3, t=(1.2, -0.7))
    args = (img_a[None], pts_a[None], img_b[None], pts_b[None])
    want = jodo.descriptor_bootstrap(*map(jnp.asarray, args), RES, descriptor=kind, nndr=0.95)
    got = odometry.descriptor_bootstrap(*map(torch.from_numpy, args), RES, descriptor=kind,
                                        nndr=0.95)
    np.testing.assert_array_equal(got["matches"].numpy(), np.asarray(want["matches"]))
    np.testing.assert_array_equal(got["match_ok"].numpy(), np.asarray(want["match_ok"]))
    hold_ransac(got, want)
    if kind == "orb":  # JAX's own test's limits
        T = got["T"].numpy()[0]
        np.testing.assert_allclose(T[:2, :2], R, atol=1e-3)
        np.testing.assert_allclose(T[:2, 3], t, atol=5e-3)
        assert got["ok"].all()
