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
    relu_bias_bwd,
    relu_bias_bwd_plain,
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
    # old budget of window // tm + 1 blocks, and still scan their own runs.
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


def mixed_stripe_case(device, seed=12, B=3, N=256, M=2048):
    """A sorted map for each of B items (1900 real points in a 120 m square,
    an exact duplicate, pad rows at 1000) and a scan: item 0's is unsorted,
    so each of its tiles spans the whole map; the others' are map points
    moved ~0.5 m, grouped by key. Returns (p, q_sorted, key_sorted, use_x)
    on ``device``."""
    rng = np.random.default_rng(seed)
    q = np.full((B, M, 3), 1000.0, np.float32)
    q[:, :1900, :2] = rng.uniform(-60, 60, (B, 1900, 2))
    q[:, :1900, 2] = 0.0
    q[:, 700] = q[:, 300]  # an exact duplicate: the first occurrence must win
    q_s, key_s, use_x = tnn.stripe_sort_target(torch.from_numpy(q))
    p = torch.from_numpy(rng.uniform(-60, 60, (B, N, 3)).astype(np.float32))
    p[..., 2] = 0.0
    p[1:] = q_s[1:, :1900:7][:, :N] + torch.from_numpy(
        rng.normal(0, 0.5, (B - 1, N, 3)).astype(np.float32))
    key = torch.where(use_x[:, None], p[..., 0], p[..., 1])
    p[1:] = torch.gather(p[1:], 1, key[1:].argsort(dim=1, stable=True)[..., None].expand(-1, -1, 3))
    return tuple(t.contiguous().to(device) for t in (p, q_s, key_s, use_x))


@pytest.mark.parametrize("refresh", [None, [True, False, True]])
def test_stripe_dispatcher_scans_each_tiles_run(cuda, refresh):
    """The dispatcher's case of ``tests/test_torch_kernels.py`` (item 0's
    tiles over the old budget, the others grouped by key) on the card: one
    K4 launch and no synchronising call; every searching row K4's idx and d2
    bits against the plain version's; within trim, and in the tiles whose
    run is the whole map, K1's."""
    p, q_s, key_s, use_x = mixed_stripe_case(cuda)
    B, N, M = p.shape[0], p.shape[1], q_s.shape[1]
    trim, tn, window, tm = 3.0, 64, 512, 512
    gate = None if refresh is None else torch.tensor(refresh, device=cuda)
    live = torch.ones(B, dtype=torch.bool, device=cuda) if gate is None else gate

    def call():
        return tnn.nn_argmin_stripe_presorted(p, q_s, key_s, use_x, trim, window=window,
                                              tn=tn, refresh=gate)

    call()  # builds the kernels and makes the device counters
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, d2 = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert launch_counts()["nn_stripe"] == 1 and sum(launch_counts().values()) == 1
    with plain_versions():
        idx_p, d2_p = call()
    rows = live[:, None].expand(B, N)
    assert torch.equal(idx[rows], idx_p[rows]) and same_bits(d2[rows], d2_p[rows])
    idx_d, d2_d = tnn.nn_argmin(p, q_s)
    near = rows & (d2_d < trim ** 2)
    assert near[live].float().mean() > 0.9
    assert torch.equal(idx[near], idx_d[near]) and same_bits(d2[near], d2_d[near])
    start, nblk = tnn.stripe_blocks(p, key_s, use_x, trim, tn, tm)
    assert (nblk[0] > window // tm + 1).all()
    whole = ((start == 0) & (nblk == M // tm)).repeat_interleave(tn, dim=1) & rows
    assert whole[0].all() and not whole[1:].all()
    assert torch.equal(idx[whole], idx_d[whole]) and same_bits(d2[whole], d2_d[whole])


def test_full_range_stripe_scan_is_the_dense_kernel(cuda):
    """K4 over every block from block 0 (a tile whose run is the whole map)
    gives the dense kernel's indices and the same d2 bits; ties go to the first map
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


POLAR = (400, 3360)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Ci,Co,H,W", sorted(set(conv3x3_shapes(width=POLAR))))
def test_conv3x3_kernels_match_plain_at_the_polar_stages(cuda, Ci, Co, H, W, dtype):
    """K2 (forward, dx) and K3 (dk) at every stage of the polar UNet, 400 x
    3360 ... 25 x 210, widths no multiple of the kernels' tiles: against the
    plain versions (1e-4 of max, 2e-2 in bf16 for the forward and dx), dk
    within 1e-5 of a float64 sum and bitwise across two runs."""
    g = torch.Generator(device=cuda).manual_seed(40)
    x = torch.randn(2, Ci, H, W, generator=g, device=cuda).to(dtype)
    dy = torch.randn(2, Co, H, W, generator=g, device=cuda).to(dtype)
    w = (torch.randn(Co, Ci, 3, 3, generator=g, device=cuda) * (2.0 / (9 * (Ci + Co))) ** 0.5
         ).to(dtype)
    b = torch.linspace(-0.1, 0.1, Co, device=cuda).to(dtype)
    lim = 1e-4 if dtype == torch.float32 else 2e-2
    assert rel_err(conv3x3(x, w, b, True), conv3x3_plain(x, w, b, True)) <= lim
    assert rel_err(conv3x3_dx(dy, w), conv3x3_dx_plain(dy, w)) <= lim
    dk = conv3x3_dk(x, dy)
    assert torch.equal(dk, conv3x3_dk(x, dy))
    dk64 = torch.nn.grad.conv2d_weight(x.double(), dk.shape, dy.double(), padding=1)
    assert rel_err(dk, dk64) <= 1e-5


def mask_shapes(width) -> list[tuple[int, int, int]]:
    """(Co, H, W) of each conv output of the UNet on ``width``."""
    return sorted({(s[1], s[2], s[-1]) for s in conv3x3_shapes(width=width)})


BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Co,H,W", [(2, *s) for s in mask_shapes(640) + mask_shapes(POLAR)]
                         + [(16, 16, 640, 640)])
def test_relu_bias_bwd_kernel_matches_plain(cuda, monkeypatch, B, Co, H, W, dtype):
    """The conv backward's mask and bias gradient at every conv output of
    the cartesian 640² and the polar 400 x 3360 UNet (B = 2), and at B = 16,
    16 x 640², with and without ReLU, on dy contiguous and as a channel
    slice of a wider tensor (read in place: the kernel gets its pointer):
    dy_m is the plain version's bit for bit (signed zeros, NaN and
    infinities planted, polar planes no multiple of 16 bytes), db within
    1e-5 of a float64 sum of it, non-finite where that is, and a second call
    gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(Co * H + W)
    y = torch.randn(B, Co, H, W, generator=g, device=cuda).to(dtype)
    wide = torch.randn(B, Co + 2, H, W, generator=g, device=cuda).to(dtype)
    nan, inf = float("nan"), float("inf")
    y[-1, -1, -1, :8] = torch.tensor([1.0, 1.0, 1.0, 0.0, -0.0, nan, 2.0, -2.0])
    wide[-1, -1, -1, :8] = torch.tensor([-0.0, 0.0, nan, inf, -inf, 3.0, -inf, -1.0])
    real, pointers = tconv.launch, []

    def spy(name, device, *args):
        pointers.append(args[1])
        return real(name, device, *args)

    monkeypatch.setattr(tconv, "launch", spy)
    bits = BITS[dtype]
    for dy in (wide[:, 2:], wide[:, 2:].contiguous()):
        for relu in (True, False):
            pointers.clear()
            got, db = relu_bias_bwd(y, dy, relu)
            assert pointers == [dy.data_ptr()]
            want, _ = relu_bias_bwd_plain(y, dy, relu)
            assert got.dtype == dtype and got.is_contiguous()
            assert torch.equal(got.view(bits), want.view(bits)), (dy.is_contiguous(), relu)
            db64 = want.double().sum((0, 2, 3))
            finite = db64.isfinite()
            assert torch.equal(db.isfinite(), finite) and finite[:-1].all()
            assert rel_err(db[finite], db64[finite]) <= 1e-5
            got2, db2 = relu_bias_bwd(y, dy, relu)
            assert torch.equal(got2.view(bits), got.view(bits))
            assert torch.equal(db2.view(torch.int32), db.view(torch.int32))


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
    assert counts["relu_bias_bwd"] == 2 * n_conv  # one a conv backward
    reset_launch_counts()
    trainer.train_step(state, batch)
    counts = launch_counts()
    assert (counts["conv3x3"], counts["conv3x3_dx"], counts["conv3x3_dk"]) == want
    assert counts["relu_bias_bwd"] == n_conv
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
        # another order can flip that rounding. grad_norm is not compared
        # here (the bf16 mask's ties at its max made it reach ~1e7 until the
        # head computed in float32, ROADMAP §3 fault 4); chip_smoke.py's e2e
        # and implicit phases compare it at full width.
        assert abs(loss.item() - loss_p.item()) <= 2e-2 * abs(loss_p.item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unet_train_step_masks_each_conv_once(cuda, dtype):
    """The full-width UNet (8 ... 256, 32 convs) in a replayed train step:
    one launch of the mask and bias gradient a conv backward."""
    spec = SyntheticSpec(n_scan=1024, n_map=4096, polar_shape=(128, 512),
                         cart_pixel_width=128, res=0.25, cart_resolution=0.5,
                         max_range=30.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
    cfg = Config(model=ModelConfig(cart_pixel_width=128, cart_resolution=0.5, res=0.25,
                                   polar_shape=(128, 512), max_iter=3, dtype=dtype))
    trainer = Trainer(cfg, cuda)
    batch = synthetic_batch(5, 2, spec, device=cuda)
    state = trainer.init_state(2)
    n_conv = len(conv3x3_shapes(cfg.model.enc_channels, 128))
    assert n_conv == 32
    trainer.train_step(state, batch)
    reset_launch_counts()
    _, loss, _, _ = trainer.train_step(state, batch)
    counts = launch_counts()
    assert counts["relu_bias_bwd"] == counts["conv3x3_dk"] == n_conv
    assert torch.isfinite(loss)


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


@pytest.mark.parametrize("icp_type", ["pt2pt", "pt2pl"])
def test_implicit_train_step_matches_the_cpu_and_plain(cuda, icp_type):
    """icp_diff_mode="implicit" on the card: the step is one CUDA graph, the
    forward's solve (50 iterations, items frozen on the device) runs K4 and
    the backward's dense association K1, once a step; its first step equals
    the plain path's (loss 1e-5, grad_norm 1e-3 relative, chip_smoke.py's
    implicit limits) and the CPU port's (loss 1e-5; grad_norm 1e-2, the
    limit test_train_step_runs_the_kernels holds at these widths: the
    mask-points BCE's gradient at the mask's max moves with the convs' order
    of summation, ROADMAP §3 open fault 2; 4.2e-3 measured)."""
    trainer, spec = small_trainer(cuda, max_iter=3, dropout=0.0, icp_diff_mode="implicit",
                                  icp_type=icp_type)
    batch = synthetic_batch(6, 4, spec, device=cuda)
    state = trainer.init_state(3)
    trainer.capture_train_step(state, batch)
    reset_launch_counts()
    _, loss, _, gn = trainer.train_step(state, batch)
    counts = launch_counts()
    assert len(state.graphs) == 1 and counts["nn_argmin"] == 1 and counts["nn_stripe"] == 50
    cpu = Trainer(trainer.cfg, "cpu")
    _, loss_c, _, gn_c = cpu.train_step(cpu.init_state(3), synthetic_batch(6, 4, spec))
    with plain_versions():
        _, loss_p, _, gn_p = trainer.train_step(trainer.init_state(3), batch)
    for want_loss, want_gn, limit in ((loss_p, gn_p, 1e-3), (loss_c, gn_c, 1e-2)):
        d_loss = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
        d_gn = abs(gn.item() - want_gn.item()) / want_gn.item()
        assert d_loss <= 1e-5 and d_gn <= limit, (d_loss, d_gn, limit)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_head_on_the_card_matches_the_cpu(cuda, dtype):
    """The UNet's float32 head (ROADMAP §3 fault 4) on the card: a float32
    mask within 1e-4 (float32) or 5e-2 (bfloat16, each activation rounded to
    8 bits on both devices) of the CPU's, and in bfloat16 no pixel tied at
    an image's max."""
    trainer, spec = small_trainer(cuda, dtype=dtype)
    params = trainer.init_state(3).params
    batch = synthetic_batch(6, 4, spec)
    loc = batch["loc_data"]
    cpu = Trainer(trainer.cfg, "cpu")
    with torch.inference_mode():
        mask = trainer.policy.compute_mask(params, loc["fft_data"].to(cuda),
                                           loc["fft_cfar"].to(cuda))
        want = cpu.policy.compute_mask(cpu.init_state(3).params, loc["fft_data"],
                                       loc["fft_cfar"])
    assert mask.dtype == want.dtype == torch.float32
    limit = 1e-4 if dtype == "float32" else 5e-2
    assert (mask.cpu() - want).abs().max().item() <= limit
    ties = (mask >= mask.amax(dim=(1, 2), keepdim=True)).sum((1, 2))
    assert dtype == "float32" or (ties == 1).all()


def png_pixels(path) -> tuple[int, int, int]:
    """(width, height, bytes of pixel data) of a PNG, decompressed."""
    import struct
    import zlib

    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    width, height = struct.unpack(">II", data[16:24])
    idat, pos = b"", 8
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        idat += data[pos + 8:pos + 8 + n] if tag == b"IDAT" else b""
        pos += 12 + n
    return width, height, len(zlib.decompress(idat))


def test_fit_writes_the_artifacts_on_the_card(cuda, tmp_path):
    """fit on cuda writes the JAX package's artifact set as 8-bit grayscale
    PNGs of the mask's size."""
    import os

    trainer, spec = small_trainer(cuda, max_iter=2, inference_max_iter=4)
    trainer = Trainer(dataclasses.replace(trainer.cfg, train=dataclasses.replace(
        trainer.cfg.train, checkpoint_dir=str(tmp_path), num_epochs=1)), cuda)
    train = [synthetic_batch(1, 4, spec)]
    val = [synthetic_batch(2, 4, spec)]
    trainer.fit(lambda epoch: train, lambda: val)
    names = sorted(os.listdir(tmp_path / "run_artifacts"))
    assert names == sorted(f"{n}.png" for n in ("learned_mask_epre", "learned_mask_e0",
                                                "raw_scan", "cfar_mask", "fft_mask",
                                                "map_mask"))
    for name in names:
        assert png_pixels(tmp_path / "run_artifacts" / name) == (128, 128, 128 * 129), name


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
                   (3, 4, 11, 6, 4, 2)]
                # The polar UNet's upsamples, 12 x 105 -> 25 x 210 ... 200 x 1680
                # -> 400 x 3360, at B = 4.
                + [(4, c, H, W, w, 3) for c, h, w, H, W in upsample_shapes(width=POLAR)]
                + [(4, c, H, w, h, 2) for c, h, w, H, W in upsample_shapes(width=POLAR)])


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
def test_polar_train_step_chains_are_bitwise_repeatable(cuda, dtype):
    """Polar network input and output (the mask warped to cartesian, its
    gradient by the lookup kernel, no float atomics), mask_pts = 0: two
    chains of 3 graph steps from one seed end in the same bits."""
    trainer, spec = small_trainer(cuda, max_iter=3, dropout=0.05, dtype=dtype,
                                  network_input_type="polar", network_output_type="polar")
    trainer = Trainer(dataclasses.replace(trainer.cfg, loss=dataclasses.replace(
        trainer.cfg.loss, mask_pts=0.0)), cuda)
    batch = synthetic_batch(9, 4, dataclasses.replace(spec, network_input_type="polar"),
                            device=cuda)
    assert batch["loc_data"]["fft_data"].shape == (4, 128, 512)
    reset_launch_counts()
    a, b = (train_chain(trainer, batch, trainer.init_state(6)) for _ in range(2))
    assert launch_counts()["bilinear_points_bwd"] >= 2 * 6
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


@pytest.mark.parametrize("stripe", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_solve_matches_the_cpu_port(cuda, dtype, stripe):
    """The motion-gated eval solve (nn_refresh_dist 0.05) on the card,
    replayed from its chunk graphs, against the same solve on the CPU from
    the same weights (the card's mask, in the model's dtype): T within
    1e-4 m / 1e-5 rad on items converged on both, iterations within one,
    at most 10 stop-test reads."""
    overrides = () if stripe else ("nn_stripe=false",)
    trainer, spec = small_trainer(cuda, dtype=dtype, nn_refresh_dist=0.05,
                                  icp_overrides=overrides)
    params = trainer.init_state(5).params
    batch = synthetic_batch(8, 8, spec, device=cuda)
    loc, mp, T0 = batch["loc_data"], batch["map_data"], batch["transforms"]["T_ml_init"]
    cfg = dataclasses.replace(trainer.policy._icp_inference, dim=2)
    assert cfg.nn_refresh_dist == 0.05 and cfg.nn_stripe == (None if stripe else False)
    from mm_masking_tpu_torch.dicp import icp
    from mm_masking_tpu_torch.ops import extract_weights

    with torch.inference_mode():
        mask = trainer.policy.apply(params, loc, mp, T0, mask_only=True)
        w, _ = extract_weights(mask, loc["raw_pc"], cart_resolution=0.5, cart_pixel_width=128)
        args = (loc["filtered_pc"], mp["pc"], T0)
        icp(*args, weight=w, cfg=cfg)  # captures the chunk
        reset_launch_counts()
        got = icp(*args, weight=w, cfg=cfg)
        counts = launch_counts()
        want = icp(*(a.cpu() for a in args), weight=w.cpu(), cfg=cfg)
    assert counts["nn_stripe" if stripe else "nn_argmin"] >= 1
    assert got["stop_tests"] <= 10
    assert abs(int(got["iterations"]) - int(want["iterations"])) <= 1
    conv = ((got["delta_norm"].cpu() < 1e-5) & (want["delta_norm"] < 1e-5)).numpy()
    assert conv.any()
    T_g, T_w = got["T"].cpu().numpy()[conv], want["T"].numpy()[conv]
    np.testing.assert_allclose(T_g[:, :3, 3], T_w[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(T_g[:, :3, :3], T_w[:, :3, :3], rtol=0, atol=1e-5)


def test_gated_stripe_keeps_the_ids_of_items_that_skip(cuda, monkeypatch):
    """One gated iteration at a time, eagerly on the card: an item whose
    gate is closed (need false, so the stripe call gives it no blocks)
    keeps its cached ids bit for bit; at least one item skips."""
    import importlib

    from mm_masking_tpu_torch.dicp import ICPConfig, icp

    icp_module = importlib.import_module("mm_masking_tpu_torch.dicp.icp")
    trainer, spec = small_trainer(cuda)
    batch = synthetic_batch(9, 8, spec, device=cuda)
    cfg = ICPConfig(max_iterations=50, differentiable=False, nn_refresh_dist=0.05, dim=2)
    seen = []
    step = icp_module._iterate_gated

    def spy(st, inp, cfg, stripe, n, mesh=None):
        for _ in range(n):
            go = (st["done"] < cfg.max_iterations) & (st["dn"].amax() >= cfg.tolerance)
            need = go & ((st["done"] == 0) | (st["moved"] >= cfg.nn_refresh_dist))
            before = st["idx"].clone()
            step(st, inp, cfg, stripe, 1, mesh)
            seen.append((need.clone(), before, st["idx"].clone()))

    monkeypatch.setattr(icp_module, "_iterate_gated", spy)
    with eager(), torch.inference_mode():
        icp(batch["loc_data"]["filtered_pc"], batch["map_data"]["pc"],
            batch["transforms"]["T_ml_init"], cfg=cfg)
    skipped = 0
    for need, before, after in seen:
        keep = ~need
        assert torch.equal(after[keep], before[keep])
        skipped += int(keep.sum())
    assert seen[0][0].all() and skipped > 0


def write_tree(root, frames: int = 1, val_frames: int = 4) -> None:
    """A tiny tree under the default Config()'s pair names."""
    from mm_masking_tpu_torch.data.testing import write_synthetic_dataset

    for i, (map_seq, loc_seq) in enumerate(Config().train_loc_pairs):
        write_synthetic_dataset(str(root), map_seq, loc_seq, n_frames=frames, n_scan=128,
                                n_map=512, polar_shape=(64, 256), seed=i)
    for map_seq, loc_seq in Config().val_loc_pairs:
        write_synthetic_dataset(str(root), map_seq, loc_seq, n_frames=val_frames, n_scan=128,
                                n_map=512, polar_shape=(64, 256), seed=99)


def test_preprocess_batch_on_the_card_matches_the_cpu(cuda, tmp_path):
    """One collated batch of the tree: u8/255 equal bit for bit (one table
    of numpy's divide on both), the cfar plane exactly; the warp within its
    float32 conditioning, two ulps of a sampling coordinate (up to R − 1
    along range, A + 1 along azimuth) times the largest step between
    neighbouring polar pixels: the card's fused multiply-adds round a
    coordinate apart from the CPU's (9.3e-6 of max measured here, where 1e-6
    was asked)."""
    from mm_masking_tpu_torch.data import ICPWeightDataset
    from mm_masking_tpu_torch.data.loader import _collate, preprocess_batch, to_tensors

    write_tree(tmp_path)
    cfg = dataclasses.replace(Config(), data=dataclasses.replace(
        Config().data, data_dir=str(tmp_path)), model=dataclasses.replace(
        Config().model, polar_shape=(64, 256), cart_pixel_width=64, cart_resolution=0.5,
        res=0.25))
    ds = ICPWeightDataset(list(cfg.train_loc_pairs), cfg, "train")
    batch = _collate([ds[i] for i in range(4)])
    planes = {}
    for kind in ("polar", "cartesian"):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               network_input_type=kind))
        got = preprocess_batch(to_tensors(batch, cuda), c)["loc_data"]
        want = preprocess_batch(to_tensors(batch, "cpu"), c)["loc_data"]
        for key in ("fft_data", "fft_cfar"):
            g, w = got[key].cpu(), want[key]
            if kind == "polar":
                assert torch.equal(g, w), key
                planes[key] = w
                continue
            A, R = planes[key].shape[-2:]
            steps = ((R - 1) * (planes[key][..., 1:] - planes[key][..., :-1]).abs().max()
                     + (A + 1) * (planes[key][:, 1:] - planes[key][:, :-1]).abs().max())
            d = (g - w).abs().max().item()
            assert d <= 2 * 2.0 ** -23 * steps.item(), (key, d)
        assert got["timestamp"].dtype == torch.int64


def test_cli_trains_on_a_written_tree_on_the_card(cuda, tmp_path):
    """The training CLI without --synthetic on cuda at a tiny size: the
    dataset-fed train step captured and replayed, finite losses, the
    checkpoints written."""
    import json
    import os

    from mm_masking_tpu_torch.train import train_icp_weights

    write_tree(tmp_path)
    out = tmp_path / "cli"
    train_icp_weights.main([
        "--set", f"data.data_dir={tmp_path}",
        "--set", "model.enc_channels=4,8", "--set", "model.cart_pixel_width=64",
        "--set", "model.cart_resolution=0.5", "--set", "model.res=0.25",
        "--set", "model.polar_shape=64,256", "--set", "model.max_iter=2",
        "--set", "model.inference_max_iter=4", "--set", "data.pos_std=0.4",
        "--set", "data.rot_std=0.15", "--set", "train.batch_size_train=4",
        "--set", "train.batch_size_test=4", "--set", "train.num_epochs=1",
        "--set", f"train.checkpoint_dir={out}",
    ])
    records = [json.loads(line) for line in open(out / "run_metrics.jsonl")]
    assert [r["event"] for r in records] == ["baseline", "pretrain_val", "epoch", "final_val"]
    assert all(np.isfinite(records[2][k]) for k in ("loss", "grad_norm", "acc"))
    assert {"best_policy.pt", "epoch_0.pt"} <= set(os.listdir(out))


def loc_scene(device, seed=3, batch=4):
    """Polar scans (128 x 1400 at 0.0596 m) of 1024 points against maps of
    8192 (the stripe association), near initial guesses."""
    spec = SyntheticSpec(network_input_type="polar", n_scan=1024, n_map=8192,
                         polar_shape=(128, 1400), pos_std=0.3, rot_std=0.1)
    return synthetic_batch(seed, batch, spec, device=device)


def test_localize_frame_on_the_kernels_matches_plain(cuda):
    from mm_masking_tpu_torch.localization import LocalizationConfig, localize_frame

    b = loc_scene(cuda)
    args = (b["loc_data"]["fft_data"], b["loc_data"]["azimuths"], b["loc_data"]["az_times"],
            b["map_data"]["pc"], b["transforms"]["T_ml_init"])
    cfg = LocalizationConfig(beta=0.0, max_points=1024)
    localize_frame(*args, cfg)  # captures the refined solve's graph
    reset_launch_counts()
    got = localize_frame(*args, cfg)
    counts = launch_counts()
    assert counts["nn_stripe"] > 0 and counts["nn_argmin"] > 0, counts
    with plain_versions():
        want = localize_frame(*args, cfg)
    # Uniform weights: the NN kernels are bit-identical to their plain versions.
    assert (got["T"] - want["T"]).abs().max().item() <= 1e-6
    assert torch.equal(got["matched_ratio"], want["matched_ratio"])
    assert torch.equal(got["ok"], want["ok"])


def teach_scans(device, n_frames=10, n=1024):
    rng = np.random.default_rng(5)
    r, a = rng.uniform(5, 40, 4000), rng.uniform(0, 2 * np.pi, 4000)
    world = np.stack([r * np.cos(a), r * np.sin(a), np.zeros(4000)], -1)
    scans, T = [], np.eye(4)
    step = np.eye(4)
    step[:2, :2] = [[np.cos(0.02), -np.sin(0.02)], [np.sin(0.02), np.cos(0.02)]]
    step[:2, 3] = (0.6, 0.05)
    for _ in range(n_frames):
        Ti = np.linalg.inv(T)
        s = (world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        s += rng.normal(0, 0.01, s.shape).astype(np.float32)
        s[:, 2] = 0.0
        scans.append(s[np.hypot(s[:, 0], s[:, 1]) < 45][:n])
        T = step @ T
    return torch.from_numpy(np.stack(scans)).to(device)


def test_teach_passes_are_bitwise_equal(cuda):
    from mm_masking_tpu_torch.localization import OdometryConfig, TeachPass

    scans = teach_scans(cuda)

    def run():
        tp = TeachPass(OdometryConfig(max_map_pts=4096))
        for s in scans:
            tp.process(s)
        return tp

    one, two = run(), run()
    assert torch.equal(one.map_pts, two.map_pts) and torch.equal(one.map_w, two.map_w)
    assert torch.equal(torch.stack(one._poses), torch.stack(two._poses))
    with plain_versions():
        plain = run()
    assert plain.n_keyframes == one.n_keyframes
    dt = (torch.stack(one._poses) - torch.stack(plain._poses))[:, :3, 3].norm(dim=-1)
    assert dt.max().item() <= 1e-4


def scan_times(scans: torch.Tensor) -> torch.Tensor:
    """Per-point times of the sweep: each scan's points in azimuth order."""
    az = torch.atan2(scans[..., 1], scans[..., 0]) % (2 * torch.pi)
    return az / (2 * torch.pi) * 0.25


@pytest.mark.parametrize("mode", ["continuous_time", "use_mcransac"])
def test_teach_pass_modes_on_the_card_match_the_cpu_port(cuda, mode):
    """The continuous-time teach pass (the joint pose and twist solve, K1 in
    every GN iteration) and the MC-RANSAC one (K1's pre-association, then
    the ICP): two passes on the card bitwise equal, the card against the
    plain path and against the CPU port (keyframes equal, poses 1e-4 m)."""
    from mm_masking_tpu_torch.localization import OdometryConfig, TeachPass

    scans = teach_scans(cuda)
    times = scan_times(scans)

    def run(device):
        tp = TeachPass(OdometryConfig(max_map_pts=4096, **{mode: True}))
        for k, s in enumerate(scans):
            tp.process(s.to(device), stamp_us=250_000 * k, times=times[k].to(device))
        return tp

    reset_launch_counts()
    one = run(cuda)
    assert launch_counts()["nn_argmin"] >= len(scans) - 1
    two = run(cuda)
    assert torch.equal(one.map_pts, two.map_pts)
    assert torch.equal(torch.stack(one._poses), torch.stack(two._poses))
    with plain_versions():
        plain = run(cuda)
    cpu = run("cpu")
    for other in (plain, cpu):
        assert other.n_keyframes == one.n_keyframes
        dt = (torch.stack(one._poses).cpu() - torch.stack(other._poses).cpu())[:, :3, 3]
        assert dt.norm(dim=-1).max().item() <= 1e-4
    if mode == "continuous_time":
        T, w = one.pose_at(250_000 * 4 + 125_000)
        T_cpu, _ = cpu.pose_at(250_000 * 4 + 125_000)
        assert (T.cpu() - T_cpu)[:3, 3].norm().item() <= 1e-4 and torch.isfinite(w).all()


def test_knn_ties_on_cuda_in_index_order(cuda):
    from mm_masking_tpu_torch.ops.preprocessing import knn_indices

    pts = np.random.default_rng(0).integers(-3, 4, (2, 700, 3)).astype(np.float32)
    got = knn_indices(torch.from_numpy(pts).to(cuda), k=9, chunk=256).cpu().numpy()
    d2 = ((pts[:, :, None].astype(np.float64) - pts[:, None]) ** 2).sum(-1)
    np.testing.assert_array_equal(got, np.argsort(d2, axis=-1, kind="stable")[..., :9])


def test_voxel_downsample_on_cuda_is_the_cpu_result(cuda):
    """The sequential segment sum gives the CPU's bits on the card."""
    from mm_masking_tpu_torch.ops.preprocessing import voxel_downsample

    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(-60, 60, (20000, 3)).astype(np.float32))
    w = torch.from_numpy(rng.integers(0, 5, 20000).astype(np.float32))
    center = torch.tensor([3.0, -2.0, 0.0])
    for kw in (dict(), dict(center=center), dict(weights=w), dict(center=center, weights=w)):
        want = voxel_downsample(pts, voxel=0.7, max_out=4096, pad_val=1000.0, **kw)
        got = voxel_downsample(pts.to(cuda), voxel=0.7, max_out=4096, pad_val=1000.0,
                               **{k: v.to(cuda) for k, v in kw.items()})
        for g, t in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g.cpu(), t)


def test_localization_cli_runs_on_the_card_by_default(cuda, tmp_path):
    from mm_masking_tpu_torch.localization.__main__ import main

    scans = teach_scans("cpu", n_frames=4, n=512).numpy()
    d = tmp_path / "scans"
    d.mkdir()
    for i, s in enumerate(scans):
        np.savez_compressed(d / f"frame_{1_000_000 + 100_000 * i}.npz", filt_pc=s, raw_pc=s)
    assert main(["teach", "--scans", str(d), "--out-map", str(tmp_path / "map.npz"),
                 "--max-points", "512", "--max-map-pts", "4096"]) == 0
    assert main(["localize", "--scans", str(d), "--map", str(tmp_path / "map.npz"),
                 "--out-traj", str(tmp_path / "traj.txt"), "--max-points", "512",
                 "--icp-type", "pt2pt", "--normal-threshold", "1.0"]) == 0
    assert len(open(tmp_path / "traj.txt").read().splitlines()) == 4


def recipe_batch(cuda, tmp_path):
    """The product recipe's first training batch at the tiny scale's widths
    (UNet 4, 8 at 64², 512 / 2048 points) in bf16 pt2pl: the tree
    synthesized, its shards written by datagen on the card, the batch
    loaded (detector-extracted clouds, a lidar map with normals); and the
    recipe's trainer (lr 1e-4, clip 10)."""
    from mm_masking_tpu_torch.benchmarks import e2e_product as e2e
    from mm_masking_tpu_torch.data import ICPWeightDataset, epoch_batches
    from mm_masking_tpu_torch.localization.datagen import DatagenConfig, generate_pair

    sc = dataclasses.replace(e2e.TINY, dtype="bfloat16", batch_train=4)
    root = str(tmp_path / "tree")
    e2e.synthesize_tree(root, sc)
    generate_pair(root, e2e.MAP_SEQ, e2e.TRAIN_SEQ, DatagenConfig(
        map_sensor="lidar", loc_sensor="radar", max_points=sc.max_loc_pts,
        max_map_pts=sc.max_map_pts, radar_resolution=sc.res, voxel_size=0.3, batch_size=8),
        device=cuda)
    args = e2e.build_parser().parse_args(["--scale", "tiny", "--lr", "1e-4", "--clip", "10"])
    cfg = e2e.make_config(args, sc, root, ((e2e.MAP_SEQ, e2e.TRAIN_SEQ),))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(tmp_path / "ckpt")))
    assert (cfg.model.dtype, cfg.model.icp_type, cfg.train.clip_value) == ("bfloat16", "pt2pl",
                                                                           10.0)
    ds = ICPWeightDataset(list(cfg.train_loc_pairs), cfg, "train")
    batches = epoch_batches(ds, sc.batch_train, cfg, seed=0, device=cuda)
    batch = next(batches)
    batches.close()
    return Trainer(cfg, cuda), batch


def test_recipe_bf16_pt2pl_train_step_matches_eager_and_plain(cuda, tmp_path):
    """The recipe's train step (bf16, pt2pl, clip 10) on its own first
    batch: two replays of the captured graph, each against an eager
    kernel-path step from the state it started from (loss and grad_norm
    1e-6 relative, parameters 1e-5 of the largest |p|), and the first step
    against the plain path: the loss within 2e-2 relative (bf16 rounds each
    activation to 8 bits on both paths, and a sum in another order can flip
    a rounding). grad_norm is not compared with the plain path here (it
    reached 1e7 while the bf16 mask tied at its max, before the head
    computed in float32, ROADMAP §3 fault 4); ``chip_smoke.py``'s e2e phase
    compares it at full width."""
    trainer, batch = recipe_batch(cuda, tmp_path)
    graph_state, eager_state = trainer.init_state(), trainer.init_state()
    trainer.capture_train_step(graph_state, batch)
    scale = max(v.abs().max().item() for v in graph_state.params.values())
    reset_launch_counts()
    losses = []
    for step in range(2):
        with torch.no_grad():
            for a, b in zip(eager_state.opt.tensors(), graph_state.opt.tensors()):
                a.copy_(b)
        eager_state.generator.set_state(graph_state.generator.get_state())
        _, loss, _, gn = trainer.train_step(graph_state, batch)
        with eager():
            _, loss_e, _, gn_e = trainer.train_step(eager_state, batch)
        assert torch.isfinite(loss) and torch.isfinite(gn)
        assert abs(loss.item() - loss_e.item()) <= 1e-6 * abs(loss_e.item()), step
        assert abs(gn.item() - gn_e.item()) <= 1e-6 * gn_e.item(), step
        for k, v in eager_state.params.items():
            assert (graph_state.params[k] - v).abs().max().item() <= 1e-5 * scale, (step, k)
        losses.append(loss.item())
    counts = launch_counts()
    n_conv = len(conv3x3_shapes(trainer.cfg.model.enc_channels,
                                trainer.cfg.model.cart_pixel_width))
    assert counts["conv3x3_dk"] == 4 * n_conv  # two replays and two eager steps
    assert counts["nn_stripe"] + counts["nn_argmin"] >= 4 * trainer.cfg.model.max_iter
    with plain_versions():
        _, loss_p, _, gn_p = trainer.train_step(trainer.init_state(), batch)
    assert torch.isfinite(loss_p) and torch.isfinite(gn_p)
    assert abs(losses[0] - loss_p.item()) <= 2e-2 * abs(loss_p.item())
    assert int(graph_state.opt.total_notfinite) == 0
