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
from mm_masking_tpu_torch.ops.kernels import launch_counts, plain_versions, reset_launch_counts
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Ci,Co,H", [(1, 8, 96), (16, 32, 50), (64, 64, 40), (256, 128, 20)])
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
    # window 2048: stripe mode; 256: the tiles outgrow the budget → dense.
    for window, mode in ((2048, "nn_stripe"), (256, "nn_argmin")):
        reset_launch_counts()
        idx, d2 = tnn.nn_argmin_stripe_presorted(p, q_s, key_s, use_x, 5.0,
                                                 window=window, tn=128, refresh=gate)
        assert launch_counts()[mode] == 1 and sum(launch_counts().values()) == 1
        with plain_versions():
            idx_p, d2_p = tnn.nn_argmin_stripe_presorted(
                p, q_s, key_s, use_x, 5.0, window=window, tn=128, refresh=gate)
        assert torch.equal(idx[gate], idx_p[gate]) and torch.equal(d2[gate], d2_p[gate])


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Ci,Co,H", [(1, 8, 96), (3, 8, 50), (8, 1, 33), (8, 16, 40),
                                     (16, 32, 50), (64, 64, 40), (256, 128, 20)])
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
    reset_launch_counts()
    _, loss, _, gnorm = trainer.train_step(state, batch)
    counts = launch_counts()
    n_conv = 2 * 3 + 4 * 2
    assert (counts["conv3x3"], counts["conv3x3_dx"], counts["conv3x3_dk"]) == (
        n_conv, n_conv - 1, n_conv)
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
