"""The port's kernel modules vs the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as the JAX package's own
tests do. ``test_torch_gpu.py`` holds each CUDA kernel against its plain
version on the card.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.ops.pallas import nn_assoc as jnn
from mm_masking_tpu.ops.pallas.conv2d import _dk_nhcw_raw, _pad_cw, _pick_th, conv3x3_nhcw
from mm_masking_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from mm_masking_tpu_torch.ops.kernels import nn_assoc as tnn
from mm_masking_tpu_torch.ops.kernels._build import use_kernel
from mm_masking_tpu_torch.ops.kernels.conv2d import conv3x3, conv3x3_dk_plain


ULP = 2.0 ** -23  # one float32 ulp, relative


def conv_inputs(seed, B, H, W, Ci, Co):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Ci, H, W)).astype(np.float32)
    k = (rng.standard_normal((3, 3, Ci, Co)) * 0.2).astype(np.float32)  # HWIO
    b = (rng.standard_normal(Co) * 0.1).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("Ci,Co", [(1, 8), (8, 8), (16, 16)])
def test_conv3x3_matches_pallas(Ci, Co, relu, dtype):
    B, H, W = 2, 16, 40
    x, k, b = conv_inputs(0, B, H, W, Ci, Co)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = conv3x3_nhcw(jnp.asarray(x).transpose(0, 2, 1, 3).astype(jdt),
                        jnp.asarray(k).astype(jdt), jnp.asarray(b).astype(jdt), relu)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    tdt = getattr(torch, dtype)
    got = conv3x3(torch.from_numpy(x).to(tdt),
                  torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).to(tdt),
                  torch.from_numpy(b).to(tdt), relu)
    assert got.dtype == tdt and got.shape == (B, Co, H, W)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Ci", [1, 3, 8])
def test_conv3x3_dk_matches_pallas(Ci, dtype):
    """K3's plain version vs the Pallas dk kernel (interpret mode), fed as the
    JAX package's backward feeds it: C padded to the sublane tile, W to 128."""
    B, H, W, Co = 2, 16, 200, 8
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((B, Ci, H, W)) * 0.1).astype(np.float32)
    dy = (rng.standard_normal((B, Co, H, W)) * 0.1).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tile = 16 if dtype == "bfloat16" else 8
    Cip, Cop, Wp = max(tile, -(-Ci // tile) * tile), max(tile, -(-Co // tile) * tile), 256
    xj = _pad_cw(jnp.asarray(x).transpose(0, 2, 1, 3).astype(jdt), Cip, Wp)
    dyj = _pad_cw(jnp.asarray(dy).transpose(0, 2, 1, 3).astype(jdt), Cop, Wp)
    want = np.asarray(_dk_nhcw_raw(xj, dyj, _pick_th(H))).reshape(3, 3, Cip, Cop)[:, :, :Ci, :Co]
    tdt = getattr(torch, dtype)
    got = conv3x3_dk_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (Co, Ci, 3, 3)
    got = got.permute(2, 3, 1, 0).numpy()  # OIHW → HWIO
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("relu", [False, True])
def test_conv3x3_gradients_match_pallas_vjp(relu):
    """jax.grad through conv3x3_nhcw's custom VJP (Pallas dx and dk in
    interpret mode) vs the port's autograd Function on the CPU."""
    B, H, W, Ci, Co = 2, 16, 40, 3, 8
    x, k, b = conv_inputs(4, B, H, W, Ci, Co)
    # Scaled so that dk, a sum over B·H·W products, is of order 1.
    cot = (np.random.default_rng(5).standard_normal((B, Co, H, W)) * 0.02).astype(np.float32)

    def loss(xj, kj, bj):
        y = conv3x3_nhcw(xj.transpose(0, 2, 1, 3), kj, bj, relu)
        return jnp.sum(y * jnp.asarray(cot).transpose(0, 2, 1, 3))

    gx, gk, gb = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = conv3x3(xt, wt, bt, relu)
    assert type(y.grad_fn).__name__ == "_Conv3x3Backward"
    tx, tw, tb = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(cot))
    np.testing.assert_allclose(tx.numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tw.permute(2, 3, 1, 0).numpy(), np.asarray(gk), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(gb), rtol=0, atol=1e-5)


def test_first_conv_takes_no_dx():
    """An input that needs no gradient (the UNet's image) gets no dx."""
    x, k, b = conv_inputs(6, 1, 8, 12, 1, 8)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    y = conv3x3(torch.from_numpy(x), w, torch.from_numpy(b), True)
    (gw,) = torch.autograd.grad(y.sum(), (w,))
    assert gw.shape == w.shape and torch.isfinite(gw).all()


def test_backward_hands_the_kernels_contiguous_tensors(monkeypatch):
    """The cotangent that cat hands a decoder conv is a channel slice; the
    backward copies it before the innermost calls, which on the card need
    contiguous NCHW."""
    from mm_masking_tpu_torch.ops.kernels import conv2d

    seen = []
    for name in ("conv3x3_dx_plain", "conv3x3_dk_plain"):
        fn = getattr(conv2d, name)

        def spy(a, b, fn=fn):
            seen.append(a.is_contiguous() and b.is_contiguous())
            return fn(a, b)

        monkeypatch.setattr(conv2d, name, spy)
    x, k, b = conv_inputs(7, 2, 8, 12, 4, 4)
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    inner = conv3x3(xt, w, torch.from_numpy(b), True)
    outer = conv3x3(torch.cat([inner, inner * 2.0], dim=1)[:, 2:6], w, torch.from_numpy(b))
    torch.autograd.grad(outer.sum(), (xt, w))
    assert len(seen) == 4 and all(seen)


def scene_points(seed, B, N, M):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-30, 30, (B, N, 3)).astype(np.float32)
    q = rng.uniform(-30, 30, (B, M, 3)).astype(np.float32)
    q[:, -7:] = 1000.0  # map pad rows
    q[:, 11] = q[:, 5]  # exact duplicate: the first occurrence must win
    return p, q


def test_nn_argmin_matches_pallas_interpret():
    p, q = scene_points(6, 2, 160, 1300)
    idx_j, d2_j = jnn.nn_argmin_pallas(jnp.asarray(p), jnp.asarray(q), tn=128, tm=512,
                                       interpret=True)
    idx_t, d2_t = tnn.nn_argmin(torch.from_numpy(p), torch.from_numpy(q))
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    # XLA contracts the interpreted kernel's multiply-adds: one float32 ulp.
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=ULP, atol=1e-6)
    assert not (idx_t == 11).any()  # duplicate of row 5 never chosen


def test_nn_argmin_matches_blocked():
    p, q = scene_points(7, 2, 200, 2048)
    idx_j, d2_j = jnn.nn_argmin_blocked(jnp.asarray(p), jnp.asarray(q), chunk=512)
    idx_t, d2_t = tnn.nn_argmin(torch.from_numpy(p), torch.from_numpy(q))
    # The blocked oracle expands |p|² − 2p·q + |q|²: its rounding error scales
    # with |p|² + |q|², not with d2 (bound: a few ulps of that magnitude).
    real = q[:, :-7]
    err = 8 * ULP * ((p ** 2).sum(-1).max() + (real ** 2).sum(-1).max())
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-4, atol=err)
    d_all = ((p[:, :, None] - q[:, None]) ** 2).sum(-1)
    part = np.partition(d_all, 1, axis=2)
    clear = (part[..., 1] - part[..., 0]) > 2 * err
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(idx_t.numpy()[clear], np.asarray(idx_j)[clear])


def stripe_case(seed=8, B=3, N=256, M=2048, tn=64, tm=256):
    rng = np.random.default_rng(seed)
    q = np.zeros((B, M, 3), np.float32)
    q[..., 0] = np.sort(rng.uniform(-50, 50, (B, M)), axis=1)
    q[..., 1] = rng.uniform(-5, 5, (B, M))
    p = np.zeros((B, N, 3), np.float32)
    p[..., 0] = np.sort(rng.uniform(-45, 45, (B, N)), axis=1)
    p[..., 1] = rng.uniform(-5, 5, (B, N))
    T = N // tn
    start = rng.integers(0, M // tm - 2, (B, T)).astype(np.int32)
    nblk = rng.integers(1, 3, (B, T)).astype(np.int32)
    nblk[1] = 0  # a frozen item: no association at all
    return p, q, start, nblk, tn, tm


def test_nn_stripe_matches_pallas_interpret():
    p, q, start, nblk, tn, tm = stripe_case()
    idx_j, d2_j = jnn._nn_stripe_pallas(
        jnp.pad(jnp.asarray(p), ((0, 0), (0, 0), (0, 5))), jnn.coord_major(jnp.asarray(q)),
        jnp.asarray(start), tn=tn, tm=tm, nk=int(nblk.max()), interpret=True,
        nblk=jnp.asarray(nblk))
    idx_t, d2_t = tnn.nn_stripe(torch.from_numpy(p), torch.from_numpy(q),
                                torch.from_numpy(start), torch.from_numpy(nblk), tm)
    live = np.repeat(nblk > 0, tn, axis=1)
    np.testing.assert_array_equal(idx_t.numpy()[live], np.asarray(idx_j)[live])
    np.testing.assert_allclose(d2_t.numpy()[live], np.asarray(d2_j)[live], rtol=ULP,
                               atol=1e-6)


def test_stripe_sort_target_matches_jax():
    rng = np.random.default_rng(9)
    q = np.zeros((2, 300, 6), np.float32)
    q[0, :, 0] = rng.uniform(10, 15, 300)
    q[0, :, 1] = rng.uniform(20, 120, 300)  # item 0: y is the wide axis
    q[1, :, 0] = np.round(rng.uniform(-60, 60, 300))  # item 1: x, many equal keys
    q[1, :, 1] = rng.uniform(-5, 5, 300)
    q[..., 3:] = rng.standard_normal((2, 300, 3))
    q[:, -40:] = 1000.0
    got = tnn.stripe_sort_target(torch.from_numpy(q))
    want = jnn.stripe_sort_target(jnp.asarray(q))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("refresh", [None, [True, False, True]])
def test_stripe_dispatcher_matches_dense_within_trim(refresh):
    rng = np.random.default_rng(10)
    B, N, M, trim = 3, 200, 2048, 3.0
    q = np.full((B, M, 3), 1000.0, np.float32)
    q[:, :1900, :2] = rng.uniform(-60, 60, (B, 1900, 2))
    q[:, :1900, 2] = 0.0
    q_s, key_s, use_x = tnn.stripe_sort_target(torch.from_numpy(q))
    p = q_s[:, :1900:9][:, :N] + torch.from_numpy(rng.normal(0, 0.5, (B, N, 3)).astype(np.float32))
    order = torch.argsort(torch.where(use_x[:, None], p[..., 0], p[..., 1]), dim=1, stable=True)
    p = torch.gather(p, 1, order[..., None].expand(-1, -1, 3)).contiguous()
    gate = None if refresh is None else torch.tensor(refresh)
    reset_launch_counts()
    idx, d2 = tnn.nn_argmin_stripe_presorted(p, q_s, key_s, use_x, trim, window=512,
                                             tn=64, refresh=gate)
    counts = launch_counts()  # CPU: no kernel runs
    assert set(counts) == {"conv3x3", "conv3x3_dx", "conv3x3_dk", "nn_stripe", "nn_argmin"}
    assert not any(counts.values())
    idx_d, d2_d = tnn.nn_argmin(p, q_s)
    near = d2_d < trim ** 2
    assert near.float().mean() > 0.9
    if gate is not None:
        near &= gate[:, None]
    np.testing.assert_array_equal(idx[near].numpy(), idx_d[near].numpy())
    np.testing.assert_array_equal(d2[near].numpy(), d2_d[near].numpy())
    # The jax dispatcher agrees within trim too (its CPU path: window tiers).
    idx_j, _ = jnn.nn_argmin_stripe_presorted(
        jnp.asarray(p.numpy()), jnp.asarray(q_s.numpy()), jnp.asarray(key_s.numpy()),
        jnp.asarray(use_x.numpy()), trim, window=512, tn=64)
    np.testing.assert_array_equal(idx[near].numpy(), np.asarray(idx_j)[near.numpy()])


def test_stripe_blocks_cover_each_tile_span():
    p, q, *_ = stripe_case(seed=11, B=2, N=256, M=2048)
    q_s, key_s, use_x = tnn.stripe_sort_target(torch.from_numpy(q))
    tn, tm, trim = 64, 256, 2.0
    start, nblk = tnn.stripe_blocks(torch.from_numpy(p), key_s, use_x, trim, tn, tm)
    key = p[..., 0].reshape(2, -1, tn)
    for b in range(2):
        for t in range(key.shape[1]):
            lo, hi = key[b, t].min() - trim, key[b, t].max() + trim
            need = np.nonzero((key_s[b].numpy() >= lo) & (key_s[b].numpy() < hi))[0]
            assert start[b, t] * tm <= need.min()
            assert need.max() < (start[b, t] + nblk[b, t]) * tm


def test_wrappers_refuse_devices_without_a_path():
    x = torch.empty((1, 1, 4, 4), device="meta")
    w = torch.empty((8, 1, 3, 3), device="meta")
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        conv3x3(x, w, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        use_kernel(torch.empty(1), torch.empty(1, device="meta"))
