"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch; ``tests/conftest.py``
imports JAX, so run it with::

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from mm_masking_tpu_torch.benchmarks.probe_conv import CHECKS, FULL, Case, check
from mm_masking_tpu_torch.config import Config, ModelConfig
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.models.unet import conv3x3_shapes
from mm_masking_tpu_torch.ops.kernels import (
    eager,
    launch_counts,
    plain_versions,
    reset_launch_counts,
)
from mm_masking_tpu_torch.ops.kernels import conv2d as tconv
from mm_masking_tpu_torch.ops.kernels import nn_assoc as tnn
from mm_masking_tpu_torch.ops.kernels._build import library
from mm_masking_tpu_torch.ops.kernels.conv_probes import (
    LANE_CHUNKS,
    SMEM_LIMIT,
    SMEM_TWO,
    W_TILES,
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
# the 32-column tile).
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
    not handed to the direct kernel or to cuDNN."""
    x = torch.zeros((1, 8, 16, 16), device=cuda)
    w, b = torch.zeros((8, 8, 3, 3), device=cuda), torch.zeros(8, device=cuda)
    monkeypatch.setattr(tconv, "SMEM_LIMIT", 1024)
    reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        conv3x3(x, w, b)
    assert not any(launch_counts().values())


@pytest.mark.parametrize("Ci,Co,H,W", [(1, 8, 320, 320), (256, 256, 40, 40)])
def test_conv3x3_dk_is_bitwise_reproducible(cuda, Ci, Co, H, W):
    g = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn(4, Ci, H, W, device=cuda, generator=g)
    dy = torch.randn(4, Co, H, W, device=cuda, generator=g)
    assert torch.equal(conv3x3_dk(x, dy), conv3x3_dk(x, dy))


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
    the eager state from the graph's, so that the atomics of the backward's
    sums, which differ between any two runs, do not accumulate.) The
    capture's warm-up leaves the state as it was."""
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
    assert pick_size(W_TILES, lambda t: nhcw(0, 16, 16, 8, t, 2), "x") == 32
    # 320², 32 -> 32, TH 8, f32: a whole-width tile would need far more.
    assert pick_size(W_TILES, lambda t: nhcw(0, 32, 32, 8, t, 4), "x") == 16
    assert SMEM_TWO < nhcw(0, 32, 32, 8, 16, 4) <= SMEM_LIMIT
    # P3 at TH 32 in f32 with its two ring slots: only 8 columns fit.
    assert pick_size(W_TILES, lambda t: halo(16, 16, 32, t, 4), "x") == 8
    flat = lib.mm_probe_flat_smem_bytes
    assert pick_size(LANE_CHUNKS, lambda c: flat(16, 16, 640, c, 2), "x") == 1024
    # tap-dots builds no im2col stack, so it takes a wider tile than full.
    assert nhcw(4, 16, 16, 16, 32, 2) < nhcw(0, 16, 16, 16, 32, 2)
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
