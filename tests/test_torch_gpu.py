"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch; ``tests/conftest.py``
imports JAX, so run it with::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from mm_masking_tpu_torch.benchmarks.probe_conv import (
    CHECKS,
    FULL,
    TIMES,
    Case,
    calls,
    check,
    inputs,
)
from mm_masking_tpu_torch.config import Config, ModelConfig
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.models.unet import conv3x3_shapes, upsample_shapes
from mm_masking_tpu_torch.ops.kernels import (
    eager,
    launch_counts,
    plain_versions,
    reset_launch_counts,
)
from mm_masking_tpu_torch.ops.kernels import conv2d as tconv
from mm_masking_tpu_torch.ops.kernels import nn_assoc as tnn
from mm_masking_tpu_torch.ops.kernels import resample
from mm_masking_tpu_torch.ops.kernels._build import library
from mm_masking_tpu_torch.ops.kernels.conv_probes import (
    LANE_CHUNKS,
    SMEM_LIMIT,
    SMEM_TWO,
    VARIANTS,
    W_TILES,
    flat_rows,
    halo_smem_bytes,
    mma_smem_bytes,
    nhcw_bf16_smem_bytes,
    pick_size,
)
from mm_masking_tpu_torch.ops.kernels.conv2d import (
    conv3x3,
    conv3x3_dk,
    conv3x3_dk_plain,
    conv3x3_dx,
    conv3x3_dx_plain,
    conv3x3_plain,
)
from mm_masking_tpu_torch.train import Trainer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# W = H + 7. The float32 kernel's tile edges: Ci of 3 and 12 (chunks of 8
# padded in shared memory), Co of 1, 12 and 72 (past one 64-channel block),
# widths that are no multiple of 16 (W = 37) and multiples of 32 (W = 32, 64:
# the 32-column tile). The bfloat16 kernel's: Ci of 3 (a chunk of 8), 12 and
# 72 (chunks of 16), Co past its channel block, widths that are no multiple
# of 8 (16-bit loads and stores) or of its 40-column tile.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Ci,Co,H", [(1, 8, 96), (16, 32, 50), (64, 64, 40), (256, 128, 20),
                                     (3, 12, 30), (12, 1, 25), (12, 72, 30), (72, 12, 57)])
def test_conv3x3_kernel_matches_plain(cuda, Ci, Co, H, dtype):
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, Ci, H, H + 7)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((Co, Ci, 3, 3)) * 0.2).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(Co) * 0.1).astype(np.float32))
    x, w, b = (t.to(cuda, dtype) for t in (x, w, b))
    for relu in (False, True):
        got = conv3x3(x, w, b, relu)
        want = conv3x3_plain(x, w, b, relu)
        scale = max(1.0, want.float().abs().max().item())
        # f32: summation order only; bf16: one rounding of the output.
        tol = 1e-4 * scale if dtype == torch.float32 else 2e-2 * scale
        assert got.dtype == dtype
        assert (got.float() - want.float()).abs().max().item() <= tol


def test_nn_kernels_match_plain(cuda):
    rng = np.random.default_rng(13)
    p = torch.from_numpy(rng.uniform(-30, 30, (2, 700, 3)).astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.uniform(-30, 30, (2, 5000, 3)).astype(np.float32)).to(cuda)
    idx, d2 = tnn.nn_argmin(p, q)
    with plain_versions():
        idx_p, d2_p = tnn.nn_argmin(p, q)
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)

    start = torch.tensor([[0, 3, 10], [2, 0, 1]], dtype=torch.int32, device=cuda)
    nblk = torch.tensor([[2, 1, 5], [0, 0, 0]], dtype=torch.int32, device=cuda)
    p3 = p[:, :672].contiguous()  # 3 tiles of 224 rows
    idx, d2 = tnn.nn_stripe(p3, q, start, nblk, tm=256)
    with plain_versions():
        idx_p, d2_p = tnn.nn_stripe(p3, q, start, nblk, tm=256)
    assert torch.equal(idx[0], idx_p[0]) and torch.equal(d2[0], d2_p[0])


def test_eval_step_runs_the_kernels(cuda):
    spec = SyntheticSpec(n_scan=1024, n_map=4096, polar_shape=(128, 512),
                         cart_pixel_width=128, res=0.25, cart_resolution=0.5,
                         max_range=30.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
    cfg = Config(model=ModelConfig(enc_channels=(4, 8, 16), cart_pixel_width=128,
                                   cart_resolution=0.5, res=0.25, polar_shape=(128, 512)))
    trainer = Trainer(cfg, cuda)
    params = trainer.init_state(0).params
    batch = synthetic_batch(3, 4, spec, device=cuda)
    reset_launch_counts()
    err, _, mask = trainer.eval_step(params, batch)
    counts = launch_counts()
    assert counts["conv3x3"] == 2 * 3 + 4 * 2
    assert counts["nn_stripe"] + counts["nn_argmin"] >= 1
    with plain_versions():
        err_p, _, mask_p = trainer.eval_step(params, batch)
    assert torch.isfinite(err).all()
    assert (mask - mask_p).abs().max().item() < 1e-4
    assert (err - err_p).abs().max().item() < 1e-3


def test_stripe_dispatcher_matches_plain(cuda):
    rng = np.random.default_rng(14)
    q = np.full((3, 4096, 3), 1000.0, np.float32)
    q[:, :3800, :2] = rng.uniform(-60, 60, (3, 3800, 2))
    q[:, :3800, 2] = 0.0
    q_s, key_s, use_x = tnn.stripe_sort_target(torch.from_numpy(q).to(cuda))
    p = (q_s[:, :3800:7][:, :500] + 0.3).contiguous()
    gate = torch.tensor([True, False, True], device=cuda)
    # window 2048: each tile scans its own blocks; 256: the tiles outgrow the
    # budget, and K4 scans the whole map (the dense result), chosen on the
    # device.
    for window in (2048, 256):
        reset_launch_counts()
        idx, d2 = tnn.nn_argmin_stripe_presorted(p, q_s, key_s, use_x, 5.0,
                                                 window=window, tn=128, refresh=gate)
        assert launch_counts()["nn_stripe"] == 1 and sum(launch_counts().values()) == 1
        with plain_versions():
            idx_p, d2_p = tnn.nn_argmin_stripe_presorted(
                p, q_s, key_s, use_x, 5.0, window=window, tn=128, refresh=gate)
        assert torch.equal(idx[gate], idx_p[gate]) and torch.equal(d2[gate], d2_p[gate])
    idx_d, d2_d = tnn.nn_argmin(p, q_s)
    assert torch.equal(idx[gate], idx_d[gate]) and torch.equal(d2[gate], d2_d[gate])


def test_full_range_stripe_scan_is_the_dense_kernel(cuda):
    """K4 over every block from block 0 (the over-budget select) gives the
    dense kernel's indices and the same d2 bits; ties go to the first map
    row."""
    rng = np.random.default_rng(15)
    B, N, M, tn, tm = 3, 1024, 8192, 256, 1024
    q = rng.uniform(-40, 40, (B, M, 3)).astype(np.float32)
    q[:, -100:] = 1000.0
    q[:, 4000] = q[:, 17]  # exact duplicates: the first occurrence wins
    q[:, 6000] = q[:, 5999]
    p = rng.uniform(-40, 40, (B, N, 3)).astype(np.float32)
    p[:, 5] = q[:, 17]
    p[:, 6] = q[:, 5999]
    p, q = torch.from_numpy(p).to(cuda), torch.from_numpy(q).to(cuda)
    start = torch.zeros((B, N // tn), dtype=torch.int32, device=cuda)
    nblk = torch.full_like(start, M // tm)
    idx, d2 = tnn.nn_stripe(p, q, start, nblk, tm)
    idx_d, d2_d = tnn.nn_argmin(p, q)
    assert torch.equal(idx, idx_d) and torch.equal(d2.view(torch.int32), d2_d.view(torch.int32))
    assert (idx[:, 5] == 17).all() and (idx[:, 6] == 5999).all()


def tie_heavy(seed, B, N, M):
    """Points on a coarse grid (many equal distances), exact duplicate map
    points, map pad rows at 1000, and two rows with no finite distance: a
    NaN scan point and one whose every d2 overflows."""
    rng = np.random.default_rng(seed)
    p = (rng.integers(-12, 12, (B, N, 3)) * 0.5).astype(np.float32)
    q = (rng.integers(-12, 12, (B, M, 3)) * 0.5).astype(np.float32)
    q[:, M // 2:M // 2 + 40] = q[:, 7:47]
    q[:, -9:] = 1000.0
    p[:, 3] = np.nan
    p[:, 4] = (1e30, 0.0, 0.0)
    return torch.from_numpy(p), torch.from_numpy(q)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_nn_dense_kernel_matches_plain_on_ties(cuda):
    """K1 against its plain version on tie-heavy inputs whose N and M are
    multiples of no tile, unit or chunk: idx equal, d2 bit for bit, the rows
    with no finite distance at idx 0 and d2 inf, and two runs equal."""
    p, q = (t.to(cuda) for t in tie_heavy(21, 3, 1000, 3001))
    idx, d2 = tnn.nn_argmin(p, q)
    with plain_versions():
        idx_p, d2_p = tnn.nn_argmin(p, q)
    assert torch.equal(idx, idx_p) and same_bits(d2, d2_p)
    assert (idx[:, 3:5] == 0).all() and torch.isinf(d2[:, 3:5]).all()
    idx2, d22 = tnn.nn_argmin(p, q)
    assert torch.equal(idx, idx2) and same_bits(d2, d22)


def test_nn_stripe_kernel_matches_plain_on_unequal_tiles(cuda):
    """K4 against its plain version at the eval step's B = 32, N = 4096,
    M = 16384 on tie-heavy inputs, tiles of 0 to 16 map blocks (runs past the
    map's end among them): live rows equal in idx and d2 bits, the rows with
    no finite distance at idx 0 and d2 inf, two runs equal; a tile that scans
    the whole map from block 0 gets the dense kernel's result."""
    B, N, M, tn, tm = 32, 4096, 16384, 256, 1024
    p, q = (t.to(cuda) for t in tie_heavy(22, B, N, M))
    g = torch.Generator(device=cuda).manual_seed(23)
    start = torch.randint(0, M // tm, (B, N // tn), generator=g, device=cuda, dtype=torch.int32)
    nblk = torch.randint(0, M // tm + 1, (B, N // tn), generator=g, device=cuda,
                         dtype=torch.int32)
    start[:, 0], nblk[:, 0] = 3, 2  # the all-infinite rows' tile: live, from block 3
    start[:, 1], nblk[:, 1] = 0, M // tm
    idx, d2 = tnn.nn_stripe(p, q, start, nblk, tm)
    with plain_versions():
        idx_p, d2_p = tnn.nn_stripe(p, q, start, nblk, tm)
    live = (nblk > 0).repeat_interleave(tn, dim=1)
    assert torch.equal(idx[live], idx_p[live]) and same_bits(d2[live], d2_p[live])
    assert (idx[:, 3:5] == 0).all() and torch.isinf(d2[:, 3:5]).all()
    idx2, d22 = tnn.nn_stripe(p, q, start, nblk, tm)
    assert torch.equal(idx[live], idx2[live]) and same_bits(d2[live], d22[live])
    rows = slice(tn, 2 * tn)
    idx_d, d2_d = tnn.nn_argmin(p[:, rows].contiguous(), q)
    assert torch.equal(idx[:, rows], idx_d) and same_bits(d2[:, rows], d2_d)


def test_bf16_eval_step_matches_plain(cuda):
    spec = SyntheticSpec(n_scan=512, n_map=2048, polar_shape=(128, 512),
                         cart_pixel_width=128, res=0.25, cart_resolution=0.5,
                         max_range=30.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
    cfg = Config(model=ModelConfig(enc_channels=(4, 8, 16), cart_pixel_width=128,
                                   cart_resolution=0.5, res=0.25, polar_shape=(128, 512),
                                   dtype="bfloat16"))
    trainer = Trainer(cfg, cuda)
    params = trainer.init_state(1).params
    batch = synthetic_batch(4, 2, spec, device=cuda)
    _, _, mask = trainer.eval_step(params, batch)
    with plain_versions():
        _, _, mask_p = trainer.eval_step(params, batch)
    assert mask.dtype == torch.float32 and torch.isfinite(mask).all()
    # bf16 activations: each conv output is rounded to 8 significant bits.
    assert (mask - mask_p).abs().max().item() < 5e-2


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# dx is K2 from Co to Ci channels: the same tile edges as the forward's.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Ci,Co,H", [(1, 8, 96), (3, 8, 50), (8, 1, 33), (8, 16, 40),
                                     (16, 32, 50), (64, 64, 40), (256, 128, 20),
                                     (12, 3, 30), (1, 12, 25), (72, 12, 30), (12, 72, 57)])
def test_conv3x3_backward_kernels_match_plain(cuda, Ci, Co, H, dtype):
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((2, Ci, H, H + 7)).astype(np.float32))
    # dy as a channel slice of a wider tensor: not contiguous, as the
    # cotangent of a cat hands it to a decoder conv.
    dy = torch.from_numpy(rng.standard_normal((2, Co + 3, H, H + 7)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((Co, Ci, 3, 3)) * 0.2).astype(np.float32))
    x, w = x.to(cuda, dtype), w.to(cuda, dtype)
    dy = dy.to(cuda, dtype)[:, 3:]
    assert not dy.is_contiguous()
    dk = conv3x3_dk(x, dy)
    assert dk.dtype == torch.float32 and dk.shape == (Co, Ci, 3, 3)
    # Both sum the same float32 products, in another order.
    assert rel_err(dk, conv3x3_dk_plain(x, dy)) <= 1e-4
    dx = conv3x3_dx(dy, w)
    assert dx.dtype == dtype and dx.shape == x.shape
    # f32: summation order; bf16: one rounding of the result to 8 bits.
    assert rel_err(dx, conv3x3_dx_plain(dy, w)) <= (1e-4 if dtype == torch.float32 else 2e-2)


def test_conv3x3_f32_blocks_fit_the_shared_memory(cuda):
    """The float32 kernel's block at each UNet stage shape, as the forward
    (Co outputs) and as dx (Ci outputs), fits the 227 KB a block may have."""
    smem = library().mm_conv3x3_f32_smem_bytes
    sizes = {smem(c, h) for ci, co, h in conv3x3_shapes() for c in (ci, co)}
    assert all(0 < s <= SMEM_LIMIT for s in sizes), sizes


def test_conv3x3_f32_refuses_before_launching(cuda, monkeypatch):
    """A float32 shape the kernel cannot take raises before any launch; it is
    not handed to another kernel or to cuDNN."""
    x = torch.zeros((1, 8, 16, 16), device=cuda)
    w, b = torch.zeros((8, 8, 3, 3), device=cuda), torch.zeros(8, device=cuda)
    monkeypatch.setattr(tconv, "SMEM_LIMIT", 1024)
    reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        conv3x3(x, w, b)
    assert not any(launch_counts().values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Ci,Co,H,W", [(1, 8, 320, 320), (256, 256, 40, 40)])
def test_conv3x3_dk_is_bitwise_reproducible(cuda, Ci, Co, H, W, dtype):
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn(4, Ci, H, W, device=cuda, generator=g).to(dtype)
    dy = torch.randn(4, Co, H, W, device=cuda, generator=g).to(dtype)
    assert torch.equal(conv3x3_dk(x, dy), conv3x3_dk(x, dy))


# The longest sum (6.5 M pixels a weight at 1 -> 8, 640^2, B = 16) and the
# widest stage (256 -> 256 at 40^2) of a bf16 train step.
@pytest.mark.parametrize("Ci,Co,H", [(1, 8, 640), (256, 256, 40)])
def test_conv3x3_dk_bf16_matches_float64(cuda, Ci, Co, H):
    """K3's bf16 GEMM sums exact products in float32, a fresh tensor-core
    accumulator per spatial tile: within 1e-5 of max |dk| of a float64 sum
    of the same (widened) inputs."""
    g = torch.Generator(device=cuda).manual_seed(17)
    x = torch.randn(16, Ci, H, H, device=cuda, generator=g).bfloat16()
    dy = torch.randn(16, Co, H, H, device=cuda, generator=g).bfloat16()
    dk = conv3x3_dk(x, dy)
    dk64 = torch.nn.grad.conv2d_weight(x.double(), dk.shape, dy.double(), padding=1)
    assert rel_err(dk, dk64) <= 1e-5


# The same two stages of a float32 train step.
@pytest.mark.parametrize("Ci,Co,H", [(1, 8, 640), (256, 256, 40)])
def test_conv3x3_dk_f32_matches_float64(cuda, Ci, Co, H):
    """K3's float32 GEMM splits x and dy into TF32 halves, takes three
    products each and starts a fresh tensor-core accumulator per row of a
    tile: within 1e-5 of max |dk| of a float64 sum of the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn(16, Ci, H, H, device=cuda, generator=g)
    dy = torch.randn(16, Co, H, H, device=cuda, generator=g)
    dk = conv3x3_dk(x, dy)
    dk64 = torch.nn.grad.conv2d_weight(x.double(), dk.shape, dy.double(), padding=1)
    assert rel_err(dk, dk64) <= 1e-5


# The bf16 path's three kinds of chunk at a train step's B = 16: Ci = 1 (the
# 9 taps in one k-step) and 16 (one tap a k-step) at 640^2, bound by bytes,
# and the widest stage, 256 -> 256 at 40^2; dx runs the same kernel on Co
# input channels (8, 16 and 256).
@pytest.mark.parametrize("use", ["forward", "dx"])
@pytest.mark.parametrize("Ci,Co,H", [(1, 8, 640), (16, 16, 640), (256, 256, 40)])
def test_conv3x3_bf16_matches_float64(cuda, Ci, Co, H, use):
    """K2's bf16 kernel sums exact products in float32, a fresh tensor-core
    accumulator per chunk, and rounds once to bf16: each element within
    2^-8 |y64| + 1e-5 max |y64| of a float64 conv of the same bf16 values.
    A tap read from the wrong pixel or channel misses this by far."""
    g = torch.Generator(device=cuda).manual_seed(19)
    w = (torch.randn(Co, Ci, 3, 3, device=cuda, generator=g) * (2.0 / (9 * Ci)) ** 0.5).bfloat16()
    if use == "forward":
        x = torch.randn(16, Ci, H, H, device=cuda, generator=g).bfloat16()
        b = torch.randn(Co, device=cuda, generator=g) * 0.1
        got = tconv.conv3x3_forward(x, w, b)
        want = torch.nn.functional.conv2d(x.double(), w.double(), b.double(), padding=1)
    else:
        dy = torch.randn(16, Co, H, H, device=cuda, generator=g).bfloat16()
        got = conv3x3_dx(dy, w)
        want = torch.nn.grad.conv2d_input((16, Ci, H, H), w.double(), dy.double(), padding=1)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    limit = 2.0 ** -8 * want.abs() + 1e-5 * want.abs().max()
    assert ((got.double() - want).abs() <= limit).all()


def test_conv3x3_bf16_blocks_fit_the_shared_memory(cuda):
    """The bf16 conv's block at each UNet stage shape, as the forward (Ci in,
    Co out) and as dx (Co in, Ci out), fits the 227 KB a block may have."""
    smem = library().mm_conv3x3_bf16_smem_bytes
    sizes = {smem(a, c) for ci, co, _ in conv3x3_shapes() for a, c in ((ci, co), (co, ci))}
    assert all(0 < s <= SMEM_LIMIT for s in sizes), sizes


def test_conv3x3_dk_f32_blocks_fit_the_shared_memory(cuda):
    """The float32 dk block at each UNet stage shape fits the 227 KB a block
    may have."""
    smem = library().mm_conv3x3_dk_f32_smem_bytes
    sizes = {smem(ci, co) for ci, co, _ in conv3x3_shapes()}
    assert all(0 < s <= SMEM_LIMIT for s in sizes), sizes


def test_conv3x3_dk_bf16_blocks_fit_the_shared_memory(cuda):
    """The bf16 dk block at each UNet stage shape fits the 227 KB a block may
    have."""
    smem = library().mm_conv3x3_dk_bf16_smem_bytes
    sizes = {smem(ci, co) for ci, co, _ in conv3x3_shapes()}
    assert all(0 < s <= SMEM_LIMIT for s in sizes), sizes


def test_conv3x3_output_carries_its_backward(cuda):
    """A CUDA conv output has the conv's grad_fn, and its gradients equal the
    plain path's."""
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((2, 8, 24, 40)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((16, 8, 3, 3)) * 0.2).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(16) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 16, 24, 40)).astype(np.float32)).to(cuda)

    def grads():
        leaves = [t.clone().to(cuda).requires_grad_(True) for t in (x, w, b)]
        y = conv3x3(*leaves, True)
        assert type(y.grad_fn).__name__ == "_Conv3x3Backward"
        return torch.autograd.grad(y, leaves, g)

    reset_launch_counts()
    got = grads()
    counts = launch_counts()
    assert (counts["conv3x3"], counts["conv3x3_dx"], counts["conv3x3_dk"]) == (1, 1, 1)
    with plain_versions():
        want = grads()
    for a, e in zip(got, want):
        assert rel_err(a, e) <= 1e-4


def test_backward_through_a_cat_slice(cuda):
    """The decoder's pattern: conv(cat([skip, conv(x)])). The cotangent of
    the inner conv's output is a channel slice of the outer conv's dx."""
    rng = np.random.default_rng(18)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda)  # noqa: E731
    x, skip = mk(2, 8, 20, 36), mk(2, 8, 20, 36)
    w1, w2 = mk(8, 8, 3, 3) * 0.2, mk(8, 16, 3, 3) * 0.2
    b1, b2 = mk(8) * 0.1, mk(8) * 0.1

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        xx, a1, c1, a2, c2 = leaves
        y = conv3x3(torch.cat([skip, conv3x3(xx, a1, c1, True)], dim=1), a2, c2, True)
        return torch.autograd.grad(y.square().sum(), leaves)

    got = grads()
    with plain_versions():
        want = grads()
    for a, e in zip(got, want):
        assert torch.isfinite(a).all() and rel_err(a, e) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_runs_the_kernels(cuda, dtype):
    spec = SyntheticSpec(n_scan=1024, n_map=4096, polar_shape=(128, 512),
                         cart_pixel_width=128, res=0.25, cart_resolution=0.5,
                         max_range=30.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
    cfg = Config(model=ModelConfig(enc_channels=(4, 8, 16), cart_pixel_width=128,
                                   cart_resolution=0.5, res=0.25, polar_shape=(128, 512),
                                   max_iter=3, dtype=dtype))
    trainer = Trainer(cfg, cuda)
    batch = synthetic_batch(5, 4, spec, device=cuda)
    state = trainer.init_state(2)
    n_conv = 2 * 3 + 4 * 2
    want = (n_conv, n_conv - 1, n_conv)
    reset_launch_counts()
    _, loss, _, gnorm = trainer.train_step(state, batch)
    # The first call warms the step up, captures it and replays it: each
    # kernel launched twice; a later call replays only.
    counts = launch_counts()
    assert (counts["conv3x3"], counts["conv3x3_dx"], counts["conv3x3_dk"]) == tuple(
        2 * n for n in want)
    reset_launch_counts()
    trainer.train_step(state, batch)
    counts = launch_counts()
    assert (counts["conv3x3"], counts["conv3x3_dx"], counts["conv3x3_dk"]) == want
    assert counts["nn_stripe"] + counts["nn_argmin"] >= 3
    ref = trainer.init_state(2)
    with plain_versions():
        _, loss_p, _, gnorm_p = trainer.train_step(ref, batch)
    assert torch.isfinite(loss) and torch.isfinite(gnorm)
    if dtype == "float32":  # summation order only
        assert abs(loss.item() - loss_p.item()) <= 1e-4 * abs(loss_p.item())
        assert abs(gnorm.item() - gnorm_p.item()) <= 1e-2 * gnorm_p.item()
    else:
        # Each activation is rounded to 8 bits on both paths, and a sum in
        # another order can flip that rounding. grad_norm is not compared:
        # in bfloat16 several mask pixels tie at the image's max, and the
        # BCE's 1/max(p(1-p), 1e-12) at p = 1 no longer cancels through the
        # normalisation, so it reaches ~1e7 on both paths (and in the JAX
        # package) and depends on which pixels tie.
        assert abs(loss.item() - loss_p.item()) <= 2e-2 * abs(loss_p.item())


def small_trainer(cuda, **model):
    spec = SyntheticSpec(n_scan=1024, n_map=4096, polar_shape=(128, 512),
                         cart_pixel_width=128, res=0.25, cart_resolution=0.5,
                         max_range=30.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
    cfg = Config(model=ModelConfig(enc_channels=(4, 8, 16), cart_pixel_width=128,
                                   cart_resolution=0.5, res=0.25, polar_shape=(128, 512),
                                   **model))
    return Trainer(cfg, cuda), spec


def test_train_step_graph_replays_match_eager_steps(cuda):
    """Three replays of the captured train step (dropout on, its generator
    registered with the graph) against three eager kernel-path steps from
    the same seed, each from the state the replay started from: loss and
    grad_norm within 1e-6 relative, the parameters within 1e-5 of the
    largest |p|, and the dropout generator advanced alike. (Each step starts
    the eager state from the graph's, so that a difference shows at the step
    that makes it; test_train_step_chains_are_bitwise_repeatable holds
    chains.) The capture's warm-up leaves the state as it was."""
    trainer, spec = small_trainer(cuda, max_iter=3, dropout=0.05)
    batch = synthetic_batch(6, 4, spec, device=cuda)
    graph_state, eager_state = trainer.init_state(3), trainer.init_state(3)
    trainer.capture_train_step(graph_state, batch)
    scale = max(v.abs().max().item() for v in graph_state.params.values())
    for step in range(3):
        with torch.no_grad():
            for a, b in zip(eager_state.opt.tensors(), graph_state.opt.tensors()):
                a.copy_(b)
        assert torch.equal(eager_state.generator.get_state(), graph_state.generator.get_state())
        _, loss, _, gn = trainer.train_step(graph_state, batch)
        with eager():
            _, loss_e, _, gn_e = trainer.train_step(eager_state, batch)
        assert abs(loss.item() - loss_e.item()) <= 1e-6 * abs(loss_e.item()), step
        assert abs(gn.item() - gn_e.item()) <= 1e-6 * gn_e.item(), step
        for k, v in eager_state.params.items():
            assert (graph_state.params[k] - v).abs().max().item() <= 1e-5 * scale, (step, k)
    assert len(graph_state.graphs) == 1 and not eager_state.graphs
    assert int(graph_state.opt.count) == int(eager_state.opt.count) == 3
    assert torch.equal(graph_state.generator.get_state(), eager_state.generator.get_state())


def test_graph_eval_step_matches_eager(cuda):
    """The eval solve's replayed chunks against the eager loop: the same
    iteration count, poses within 1e-6 m / 1e-5 deg."""
    trainer, spec = small_trainer(cuda)
    params = trainer.init_state(4).params
    batch = synthetic_batch(7, 8, spec, device=cuda)
    loc, mp, T0 = batch["loc_data"], batch["map_data"], batch["transforms"]["T_ml_init"]
    with torch.inference_mode():
        trainer.policy.apply(params, loc, mp, T0)  # captures the chunk
        out = trainer.policy.apply(params, loc, mp, T0)
        with eager():
            ref = trainer.policy.apply(params, loc, mp, T0)
    assert int(out.icp_info["iterations"]) == int(ref.icp_info["iterations"])
    assert out.icp_info["stop_tests"] <= 10
    dt = (out.T_pred[:, :3, 3] - ref.T_pred[:, :3, 3]).norm(dim=-1).max().item()
    def yaw(T):
        return torch.rad2deg(torch.atan2(T[:, 1, 0], T[:, 0, 0]))

    dyaw = (yaw(out.T_pred) - yaw(ref.T_pred)).abs().max().item()
    assert dt <= 1e-6 and dyaw <= 1e-5


def test_train_step_makes_no_synchronising_call(cuda):
    """After the warm-up, an eager kernel-path train step and a replayed one
    under torch.cuda.set_sync_debug_mode("error"): no call waits on the card
    (the stripe dispatch, the non-finite skip and the planar solve's
    indexing read nothing back)."""
    trainer, spec = small_trainer(cuda, max_iter=3)
    batch = synthetic_batch(8, 4, spec, device=cuda)
    state = trainer.init_state(5)
    trainer.train_step(state, batch)  # capture
    with eager():
        trainer.train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with eager():
            trainer.train_step(state, batch)
        trainer.train_step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert int(state.opt.count) == 4


# Each probe kernel and P2 variant at a small shape (the probe's first check
# shape), at a ragged one (W = 130 takes no 16-byte copies and ends in a
# partial column tile; Co = 5 leaves a partial channel group; P3's 5 row
# tiles split unevenly over its blocks) and at full size (B = 16, 640^2,
# 16 -> 16).
PROBE_CASES = (
    [CHECKS[p][0] for p in ("P1", "P3", "P4")] + CHECKS["P2"][:5]
    + [Case("P1", 1, 16, 130, 3, 5, 8, relu=True), Case("P3", 2, 40, 130, 3, 5, 8),
       Case("P4", 2, 24, 130, 3, 5, 8, ndot=3)]
    + [Case("P2", 1, 16, 130, 3, 5, 8, variant=v) for v in ("full", "asm-only", "row2",
                                                             "tap-dots")]
    + [c for p in ("P1", "P2", "P3", "P4") for c in FULL[p]])
COUNTER = {"P1": "conv3x3_nhcw", "P3": "conv3x3_nhcw_v2", "P4": "conv3x3_flat"}


def test_probe_tiles_fit_the_shared_memory(cuda):
    """The tiles the host picks from the sources' own block sizes."""
    lib = library()
    nhcw, halo = lib.mm_probe_nhcw_smem_bytes, lib.mm_probe_halo_smem_bytes
    assert pick_size(W_TILES, lambda t: nhcw(0, 16, 16, 8, t, 2), "x") == 64
    # 320², 32 -> 32, TH 8, f32: a whole-width tile would need far more.
    assert pick_size(W_TILES, lambda t: nhcw(0, 32, 32, 8, t, 4), "x") == 16
    assert SMEM_TWO < nhcw(0, 32, 32, 8, 16, 4) <= SMEM_LIMIT
    # P3 at TH 32 in f32 with its two ring slots: only 8 columns fit.
    assert pick_size(W_TILES, lambda t: halo(16, 16, 32, t, 4), "x") == 8
    # P3 in bf16 (the tensor cores' halo, output tile and two slab slots):
    # whole m-tiles of 16 columns only, two blocks an SM up to TH 16.
    assert halo(16, 16, 16, 8, 2) == 2**64 - 1
    assert pick_size(W_TILES, lambda t: halo(16, 16, 8, t, 2), "x") == 64
    assert pick_size(W_TILES, lambda t: halo(16, 16, 16, t, 2), "x") == 32
    assert pick_size(W_TILES, lambda t: halo(16, 16, 32, t, 2), "x") == 32
    assert SMEM_TWO < halo(16, 16, 32, 32, 2) <= SMEM_LIMIT
    # P1 in bf16 (the tensor cores' stack): the source's bytes are the
    # layout's sum, and every P1 and P2 full shape takes a tile.
    for c in CHECKS["P1"] + TIMES["P1"] + TIMES["P2"]:
        for t in W_TILES:
            assert nhcw(0, c.Ci, c.Co, c.TH, t, 2) == mma_smem_bytes(c.Ci, c.Co, c.TH, t)
        pick_size(W_TILES, lambda t: nhcw(0, c.Ci, c.Co, c.TH, t, 2), c.label)
    # P2's variants in bf16 (row2's two-row stack, tap-dots' halo without
    # the ring) and P3's and P4's halo (with it): the sources' bytes are the
    # CPU sums at every shape and tile.
    for c in CHECKS["P2"] + FULL["P2"] + TIMES["P2"] + P2_BF16:
        v = VARIANTS.index(c.variant)
        for t in W_TILES:
            assert nhcw(v, c.Ci, c.Co, c.TH, t, 2) == nhcw_bf16_smem_bytes(c.variant, c.Ci, c.Co,
                                                                           c.TH, t)
    flat = lib.mm_probe_flat_smem_bytes
    for c in CHECKS["P3"] + TIMES["P3"] + CHECKS["P4"] + TIMES["P4"] + P4_BF16:
        rows = flat_rows(c.TH) if c.probe == "P4" else c.TH
        for t in W_TILES:
            assert flat(c.Ci, c.Co, c.W, rows, t, 2) == halo_smem_bytes(c.Ci, c.Co, rows, t, True)
            assert halo(c.Ci, c.Co, rows, t, 2) == halo_smem_bytes(c.Ci, c.Co, rows, t, True)
    assert pick_size(W_TILES, lambda t: flat(16, 16, 640, 8, t, 2), "x") == 64
    # P4 in f32 keeps its lane chunks.
    assert pick_size(LANE_CHUNKS, lambda c: flat(16, 16, 640, 16, c, 4), "x") == 256
    # In f32, tap-dots builds no im2col stack, so it takes a wider tile than full.
    assert nhcw(4, 16, 16, 16, 32, 4) < nhcw(0, 16, 16, 16, 32, 4)
    with pytest.raises(ValueError, match="shared memory"):
        pick_size(W_TILES, lambda t: nhcw(0, 64, 64, 32, t, 4), "P1 64->64")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PROBE_CASES, ids=lambda c: c.label.replace(" ", "-"))
def test_conv_probe_kernels_match_plain(cuda, case, dtype):
    """check() raises beyond 1e-4 (f32) or 1e-2 (bf16) of max|y| from the
    plain version or from F.conv2d; asm-only must match bit for bit and
    dot-only (undefined value) its shape and type."""
    reset_launch_counts()
    check(case, dtype, cuda)
    torch.cuda.synchronize()
    name = COUNTER.get(case.probe, f"conv3x3_nhcw_run:{case.variant}")
    assert launch_counts()[name] == 1


# Every decoder upsample of the default Config() at B = 16, each axis as the
# backward meets it (W first, then H), and odd shapes: an axis of size 1 (the
# repeat), a shrinking axis, sizes that are no multiple of anything.
RESIZE_CASES = ([(16, c, H, H, h, 3) for c, h, H in upsample_shapes()]
                + [(16, c, H, h, h, 2) for c, h, H in upsample_shapes()]
                + [(2, 3, 9, 13, 1, 3), (2, 3, 9, 13, 1, 2), (2, 5, 7, 33, 17, 3),
                   (3, 4, 11, 6, 4, 2)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,H,W,n_in,axis", RESIZE_CASES)
def test_resize_bwd_kernel_matches_plain(cuda, B, C, H, W, n_in, axis, dtype):
    """The upsample's backward kernel on dy (B, C, H, W) resized from n_in
    rows along ``axis``: two runs bit for bit; against its plain version
    (index_add, atomics) within 1e-6 of max |dx| in float32 (the same
    float32 products summed in another order) and 2e-2 in bfloat16 (the
    plain version rounds each product and partial sum to 8 bits, as the
    conv kernels' bfloat16 limit allows); in bfloat16 also elementwise
    against a float64 sum within 2^-8 |dx64| + 1e-5 max |dx64| (one
    rounding of a float32 sum)."""
    g = torch.Generator(device=cuda).manual_seed(31)
    dy = torch.randn(B, C, H, W, generator=g, device=cuda).to(dtype)
    i0, w0, w1 = resample.resize_tables(n_in, dy.shape[axis], dtype, cuda)
    reset_launch_counts()
    got = resample.resize_bwd(dy, i0, w0, w1, n_in, axis)
    again = resample.resize_bwd(dy, i0, w0, w1, n_in, axis)
    assert launch_counts()["resize_bwd"] == 2
    with plain_versions():
        want = resample.resize_bwd(dy, i0, w0, w1, n_in, axis)
        ref = resample.resize_bwd(dy.double(), i0, w0.double(), w1.double(), n_in, axis)
    assert got.dtype == dtype and got.shape == want.shape and torch.equal(got, again)
    assert rel_err(got, want) <= (1e-6 if dtype == torch.float32 else 2e-2)
    if dtype == torch.bfloat16:
        limit = 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()
        assert ((got.double() - ref).abs() <= limit).all()


def lookup_case(cuda, N, H, W, P, dtype, seed=32):
    """An image (N, H, W) and P points a lookup takes on it: normalised
    coordinates inside and around the image, 64 pad points at (-100, -100),
    points 64..127 copies of 0..63 (their taps coincide); and a cotangent."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    image = torch.rand(N, H, W, generator=g, device=cuda).to(dtype)
    coords = torch.rand(N, P, 2, generator=g, device=cuda) * 2.2 - 1.1
    coords[:, 64:128] = coords[:, 0:64]
    coords[:, -64:] = -100.0
    dout = torch.randn(N, P, generator=g, device=cuda)
    return image, coords.to(dtype), dout.to(dtype)


def lookup_grad64(dout, image, coords):
    """The lookup's image gradient in float64 from the kernel's own float32
    pixel coordinates (ATen's unnormalisation, align_corners) and tap
    weights, which are exact in float32: so that it differs from the kernel
    only by the kernel's float32 sums and rounding."""
    N, H, W = image.shape
    ix = (coords[..., 0].float() + 1.0) * 0.5 * (W - 1)
    iy = (coords[..., 1].float() + 1.0) * 0.5 * (H - 1)
    x0, y0 = ix.floor(), iy.floor()
    grad = torch.zeros(N * H * W, dtype=torch.float64, device=image.device)
    item = torch.arange(N, device=image.device)[:, None] * (H * W)
    for a in (0, 1):
        for b in (0, 1):
            wx = ix - x0 if a else x0 + 1.0 - ix
            wy = iy - y0 if b else y0 + 1.0 - iy
            c, r = x0 + a, y0 + b
            ok = (c >= 0) & (c < W) & (r >= 0) & (r < H)
            flat = item + (r.clamp(0, H - 1) * W + c.clamp(0, W - 1)).long()
            grad.index_add_(0, flat[ok], (wx.double() * wy.double() * dout.double())[ok])
    return grad.view(N, H, W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,H,W,P", [(16, 640, 640, 4096), (3, 70, 130, 300)])
def test_bilinear_points_bwd_kernel_matches_plain(cuda, N, H, W, P, dtype):
    """The lookup's image-gradient kernel at the train step's shape (B = 16,
    640^2, 4096 points) and a ragged one: two runs bit for bit; against its
    plain version (grid_sampler_2d_backward, atomics) within 1e-6 of max |g|
    in float32 and 2e-2 in bfloat16 (the plain version sums in bfloat16);
    in bfloat16 also elementwise against the plain version in float64 on the
    same values within 2^-8 |g64| + 1e-5 max |g64|."""
    image, coords, dout = lookup_case(cuda, N, H, W, P, dtype)
    reset_launch_counts()
    got = resample.bilinear_points_bwd(dout, image, coords)
    again = resample.bilinear_points_bwd(dout, image, coords)
    assert launch_counts()["bilinear_points_bwd"] == 2
    with plain_versions():
        want = resample.bilinear_points_bwd(dout, image, coords)
    ref = lookup_grad64(dout, image, coords)
    assert got.dtype == dtype and got.shape == image.shape and torch.equal(got, again)
    assert rel_err(got, want) <= (1e-6 if dtype == torch.float32 else 2e-2)
    if dtype == torch.bfloat16:
        limit = 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()
        assert ((got.double() - ref).abs() <= limit).all()


def edge_case(cuda, N, H, W, P, dtype, seed=33):
    """A lookup whose points straddle the kernel's bin edges (columns
    k·BIN_W − 1 | k·BIN_W, rows k·BIN_H − 1 | k·BIN_H) and the image's
    border, some exactly on an edge pixel, every seventh a pad point at
    (−100, −100); and a cotangent."""
    g = torch.Generator().manual_seed(seed)
    xs = torch.tensor([k * resample.BIN_W - 1.0 for k in range(W // resample.BIN_W + 1)]
                      + [-1.0, W - 1.0])
    ys = torch.tensor([k * resample.BIN_H - 1.0 for k in range(H // resample.BIN_H + 1)]
                      + [-1.0, H - 1.0])
    ix = xs[torch.randint(len(xs), (N, P), generator=g)] + torch.rand(N, P, generator=g)
    iy = ys[torch.randint(len(ys), (N, P), generator=g)] + torch.rand(N, P, generator=g)
    ix[:, 1::5], iy[:, 2::5] = ix[:, 1::5].ceil(), iy[:, 2::5].ceil()
    coords = torch.stack([ix / (W - 1) * 2 - 1, iy / (H - 1) * 2 - 1], -1)
    coords[:, ::7] = -100.0
    image = torch.rand(N, H, W, generator=g)
    dout = torch.randn(N, P, generator=g)
    return (t.to(cuda, dtype) for t in (image, coords, dout))


LOOKUP_CASES = [("random", 16, 640, 640, 4096), ("random", 3, 70, 130, 300),
                ("edges", 4, 250, 390, 2000)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,N,H,W,P", LOOKUP_CASES)
def test_bilinear_points_bwd_is_the_ordered_sum(cuda, kind, N, H, W, P, dtype):
    """The lookup's image-gradient kernel equal bit for bit to its ordered
    reference (every pixel's taps added in ascending point order in
    float32, rounded once), twice: at the train step's shape, a ragged one
    and one whose points straddle the tile edges and the border. Its
    binning equals the plain binning: each bin's list, in ascending p."""
    make = edge_case if kind == "edges" else lookup_case
    image, coords, dout = make(cuda, N, H, W, P, dtype)
    got, lists, starts = resample._lookup_bwd_kernel(dout, image, coords, True)
    again = resample.bilinear_points_bwd(dout, image, coords)
    want = resample.bilinear_points_bwd_ordered(dout, image, coords)
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(got, again)
    want_lists, want_starts = resample.bin_points_plain(coords, H, W)
    assert torch.equal(starts, want_starts)
    used = torch.arange(lists.shape[-2], device=cuda) < starts[:, -1:, :].transpose(1, 2)
    points = lists.view(torch.int32)[..., 3]
    assert torch.equal(points[used], want_lists[used]) and (want_lists[~used] == -1).all()


def train_chain(trainer, batch, state, steps=3):
    """``steps`` train steps from ``state``: every tensor a step updates
    (parameters, Adam moments, counters), each step's loss and grad_norm,
    and the dropout generator's state."""
    out = []
    for _ in range(steps):
        _, loss, _, gnorm = trainer.train_step(state, batch)
        out += [loss, gnorm]
    torch.cuda.synchronize()
    return [t.detach().clone() for t in state.opt.tensors()] + out + [
        state.generator.get_state()]


@pytest.mark.parametrize("path", ["graph", "eager"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_chains_are_bitwise_repeatable(cuda, dtype, path):
    """Two chains of 3 train steps from one seed (dropout on), replayed from
    their CUDA graphs or run eagerly on the kernels, end in the same bits:
    parameters, Adam moments and counters, every loss and grad_norm, the
    dropout generator."""
    trainer, spec = small_trainer(cuda, max_iter=3, dropout=0.05, dtype=dtype)
    batch = synthetic_batch(9, 4, spec, device=cuda)
    with eager() if path == "eager" else contextlib.nullcontext():
        a, b = (train_chain(trainer, batch, trainer.init_state(6)) for _ in range(2))
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resumed_train_step_is_bitwise_equal(cuda, tmp_path, dtype):
    """A state saved after one step and restored into a fresh state gives
    the same next step, bit for bit, as the uninterrupted run (each replayed
    from its own CUDA graph)."""
    trainer, spec = small_trainer(cuda, max_iter=3, dropout=0.05, dtype=dtype)
    trainer = Trainer(dataclasses.replace(trainer.cfg, train=dataclasses.replace(
        trainer.cfg.train, checkpoint_dir=str(tmp_path))), cuda)
    batch = synthetic_batch(10, 4, spec, device=cuda)
    state = trainer.init_state(7)
    trainer.train_step(state, batch)
    trainer.save(state, "step_1")
    want = train_chain(trainer, batch, state, steps=1)
    resumed = trainer.restore(trainer.init_state(8), "step_1")
    got = train_chain(trainer, batch, resumed, steps=1)
    for i, (x, y) in enumerate(zip(got, want)):
        assert torch.equal(x, y), i


# P2's tensor-core variants and P4's bfloat16 kernel at every timing shape
# (P4's with ndot 1 and 3), and past them: a ragged W (no multiple of any tile, no 16-byte copies) with
# Ci 3 and Co 5, Ci 1, Ci 3; P4 also at its check shapes, with ndot 3 and
# with Ci 40 (three chunks of 16) and Co 72 (two channel groups) under ReLU.
P2_BF16 = [Case("P2", B, H, W, Ci, Co, TH, variant=v) for v in ("row2", "tap-dots", "asm-only")
           for B, H, W, Ci, Co, TH in [(c.B, c.H, c.W, c.Ci, c.Co, c.TH) for c in TIMES["P2"]
                                        if c.variant == "full"]
           + [(1, 16, 130, 3, 5, 8), (2, 16, 128, 1, 8, 8), (2, 16, 64, 3, 8, 8)]]
P4_BF16 = (TIMES["P4"] + [dataclasses.replace(c, ndot=3) for c in TIMES["P4"][2:]]
           + CHECKS["P4"] + [Case("P4", 2, 24, 130, 3, 5, 8, ndot=nd) for nd in (1, 3)]
           + [Case("P4", 2, 16, 64, 3, 8, 16), Case("P4", 1, 16, 64, 40, 72, 8, relu=True)])


@pytest.mark.parametrize("case", [c for c in P2_BF16 if c.variant != "asm-only"],
                         ids=lambda c: c.label.replace(" ", "-"))
def test_p2_bf16_matches_plain_and_float64(cuda, case):
    """P2's row2 and tap-dots on the tensor cores (hold_bf16_tensor_cores)."""
    hold_bf16_tensor_cores(cuda, case)


@pytest.mark.parametrize("case", P4_BF16, ids=lambda c: c.label.replace(" ", "-"))
def test_p4_bf16_matches_plain_and_float64(cuda, case):
    """P4's bfloat16 kernel, P3's implicit GEMM on NCHW, ndot 1 and 3
    (hold_bf16_tensor_cores)."""
    hold_bf16_tensor_cores(cuda, case)


@pytest.mark.parametrize("case", [c for c in P2_BF16 if c.variant == "asm-only"],
                         ids=lambda c: c.label.replace(" ", "-"))
def test_p2_asm_only_bf16_is_the_plain_copy(cuda, case):
    """asm-only in bfloat16 builds the stack and stores its first Co rows:
    bit for bit the plain version's copy; dot-only, on the same shape, has
    the conv's shape and type (its value is undefined)."""
    x, k = inputs(case, torch.bfloat16, cuda)
    run, plain, _ = calls(case, x, k)
    reset_launch_counts()
    got = run()
    assert launch_counts()["conv3x3_nhcw_run:asm-only"] == 1
    assert torch.equal(got, plain())
    dot = dataclasses.replace(case, variant="dot-only")
    run, plain, _ = calls(dot, x, k)
    got = run()
    assert launch_counts()["conv3x3_nhcw_run:dot-only"] == 1
    assert got.shape == plain().shape and got.dtype == torch.bfloat16


# P3's bfloat16 kernel at every timing shape (with and without the ring) and
# check shape, and at shapes past the probes': a ragged W with Ci 3 and Co 5,
# and Ci 40 (three chunks of 16) with Co 72 (two channel groups) under ReLU.
P3_BF16 = (TIMES["P3"] + CHECKS["P3"]
           + [Case("P3", 2, 40, 130, 3, 5, 8), Case("P3", 1, 16, 64, 40, 72, 8, relu=True)])


def hold_bf16_tensor_cores(cuda, case):
    """A bfloat16 tensor-core probe kernel, launched once, against its plain
    version within 1e-2 of max |y| (one rounding of the output to 8 bits),
    and elementwise against a float64 conv of the same bf16 values within
    2^-8 |y64| + 1e-5 max |y64|, as K2's bfloat16 kernel is held; a second
    run equal bit for bit."""
    x, k = inputs(case, torch.bfloat16, cuda)
    run, plain, to_nchw = calls(case, x, k)
    reset_launch_counts()
    got = run()
    assert launch_counts()[COUNTER.get(case.probe, f"conv3x3_nhcw_run:{case.variant}")] == 1
    assert torch.equal(run(), got)
    assert rel_err(got, plain()) <= 1e-2
    ref = torch.nn.functional.conv2d(x.double(), k.permute(3, 2, 0, 1).double(), padding=1)
    ref = torch.relu(ref) if case.relu else ref
    limit = 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()
    assert ((to_nchw(got).double() - ref).abs() <= limit).all()


@pytest.mark.parametrize("case", P3_BF16, ids=lambda c: c.label.replace(" ", "-"))
def test_p3_bf16_matches_plain_and_float64(cuda, case):
    """P3's bfloat16 tensor-core kernel (hold_bf16_tensor_cores)."""
    hold_bf16_tensor_cores(cuda, case)


# P1's bfloat16 kernel (P2's full) at every P1 and P2 timing shape and check
# shape, and past them: a ragged W with Ci 3 and Co 5, Ci 40 (K = 360, three
# groups of fresh sums) with Co 72 (two channel groups) under ReLU.
P1_BF16 = (TIMES["P1"] + [c for c in TIMES["P2"] if c.variant == "full"] + CHECKS["P1"]
           + [Case("P1", 2, 40, 130, 3, 5, 8), Case("P1", 1, 16, 64, 40, 72, 8, relu=True)])


@pytest.mark.parametrize("case", P1_BF16, ids=lambda c: c.label.replace(" ", "-"))
def test_p1_bf16_matches_plain_and_float64(cuda, case):
    """P1's bfloat16 tensor-core kernel, also as P2's full
    (hold_bf16_tensor_cores)."""
    hold_bf16_tensor_cores(cuda, case)
