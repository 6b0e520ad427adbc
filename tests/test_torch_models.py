"""PyTorch port vs the JAX package: UNet mask and the policy's normalised
mask, with flax parameters converted by ``params_from_flax``. atol 1e-5."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from mm_masking_tpu.models.policy import LearnICPWeightPolicy as JPolicy
from mm_masking_tpu.models.unet import UNet as JUNet, upsample_bilinear_align_corners as jup
from mm_masking_tpu_torch.config import Config, ModelConfig
from mm_masking_tpu_torch.models import LearnICPWeightPolicy, UNet, params_from_flax
from mm_masking_tpu_torch.models.unet import (
    conv1x1,
    conv3x3_shapes,
    upsample_bilinear_align_corners,
    upsample_shapes,
)
from mm_masking_tpu_torch.ops.kernels.resample import (
    resize_bwd_plain,
    resize_offsets,
    resize_tables,
)

ATOL = 1e-5


def jiggle(tree, seed):
    """Random non-zero values in every leaf, so biases are exercised too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32)),
        tree)


@pytest.mark.parametrize(
    "enc,H,conv_impl,leaky,batch_norm",
    [
        ((8, 16, 32), 32, "xla", False, False),
        ((4, 8), 24, "xla", True, False),
        ((4, 8), 16, "xla", False, True),
        # W = 128 takes the Pallas NHCW conv (interpret mode) at both levels.
        ((4, 8), 128, "pallas_nhcw", False, False),
    ],
)
def test_unet_matches_flax(enc, H, conv_impl, leaky, batch_norm):
    rng = np.random.default_rng(0)
    x = rng.random((2, H, H, 1)).astype(np.float32)
    ju = JUNet(enc_channels=enc, leaky=leaky, batch_norm=batch_norm, dropout=0.05,
               conv_impl=conv_impl)
    variables = ju.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {k: jiggle(v, 1) for k, v in variables.items()}
    if batch_norm:
        variables["batch_stats"] = jax.tree_util.tree_map(jnp.abs, variables["batch_stats"])
    want = np.asarray(ju.apply(variables, jnp.asarray(x)))

    net = UNet(in_channels=1, enc_channels=enc, leaky=leaky, batch_norm=batch_norm,
               dropout=0.05).eval()
    net.load_state_dict(params_from_flax(variables["params"], variables.get("batch_stats")))
    with torch.inference_mode():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet_head_sums_and_takes_its_sigmoid_in_float32(dtype):
    """The 1×1 head (ROADMAP §3 fault 4). In bfloat16 it multiplies the
    bf16 activations by the weight and bias rounded to bf16, exactly, and
    sums, adds and takes the sigmoid in float32: a float32 mask within
    float32 rounding of a float64 head of the same bf16 values, with no
    rounding of the logits to 8 bits. In float32 it is the matrix product,
    bias and sigmoid it always was, bit for bit, gradients included."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 24, 24, generator=g).to(dtype).requires_grad_(True)
    w = torch.randn(1, 8, 1, 1, generator=g).requires_grad_(True)
    b = torch.randn(1, generator=g).requires_grad_(True)
    y = torch.sigmoid(conv1x1(x, w, b))
    assert y.dtype == torch.float32 and y.shape == (2, 1, 24, 24)
    gx, gw, gb = torch.autograd.grad(y.sum(), (x, w, b))
    if dtype == torch.float32:
        want = torch.sigmoid((torch.matmul(w[:, :, 0, 0], x.reshape(2, 8, -1))
                              + b[:, None]).reshape(2, 1, 24, 24))
        assert torch.equal(y, want)
        for got, ref in zip((gx, gw, gb), torch.autograd.grad(want.sum(), (x, w, b))):
            assert torch.equal(got, ref)
        return
    xd, wd, bd = (t.detach().to(dtype).double() for t in (x, w, b))
    want = torch.sigmoid(torch.einsum("oc,bchw->bohw", wd[:, :, 0, 0], xd)
                         + bd[None, :, None, None])
    np.testing.assert_allclose(y.detach().numpy(), want.numpy(), rtol=2e-7, atol=1e-7)
    rounded = y.detach().to(torch.bfloat16).float()
    assert not torch.equal(rounded, y.detach())  # not a bf16 result
    assert torch.unique(y.detach()).numel() > 1000  # no 8-bit bins
    assert gx.dtype == dtype and gw.dtype == torch.float32 and torch.isfinite(gw).all()


def test_upsample_matches_jax():
    x = np.random.default_rng(2).random((2, 3, 5, 7)).astype(np.float32)
    want = jup(jnp.asarray(x), (9, 13), axes=(2, 3))
    got = upsample_bilinear_align_corners(torch.from_numpy(x), (9, 13))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize(
    "normalize,conv_impl,W",
    [("minmax", "xla", 32), ("standardize", "xla", 32), ("minmax", "pallas_nhcw", 128)],
)
def test_policy_mask_matches_jax(normalize, conv_impl, W):
    kw = dict(enc_channels=(4, 8), cart_pixel_width=W, cart_resolution=0.5,
              cfar_input=True, normalize=normalize, dropout=0.0, conv_impl=conv_impl)
    jpol = JPolicy(JConfig(model=JModelConfig(**kw)))
    tpol = LearnICPWeightPolicy(Config(model=ModelConfig(**kw)), "cpu")
    variables = {"params": jiggle(jpol.init(jax.random.PRNGKey(3))["params"], 4)}
    rng = np.random.default_rng(5)
    scan = {"fft_data": rng.random((2, W, W)).astype(np.float32),
            "fft_cfar": (rng.random((2, W, W)) > 0.9).astype(np.float32)}
    want = jpol.apply(variables, {k: jnp.asarray(v) for k, v in scan.items()}, {}, None,
                      mask_only=True)
    with torch.inference_mode():
        got = tpol.apply(params_from_flax(variables["params"]),
                         {k: torch.from_numpy(v) for k, v in scan.items()}, {}, None,
                         mask_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert float(got.max()) == 1.0



@pytest.mark.parametrize("enc,H", [((8, 16, 32), 32), ((4, 8, 16, 32), 48)])
def test_conv3x3_shapes_are_the_unets(enc, H, monkeypatch):
    """conv3x3_shapes lists the (Ci, Co, H) of every 3×3 conv a forward runs,
    in order: the shapes the conv kernels are checked and timed at."""
    import mm_masking_tpu_torch.models.unet as unet_module

    seen, real = [], unet_module.conv3x3

    def spy(x, weight, bias, relu=False):
        seen.append((x.shape[1], weight.shape[0], x.shape[2]))
        return real(x, weight, bias, relu)

    monkeypatch.setattr(unet_module, "conv3x3", spy)
    net = UNet(1, enc, dropout=0.0)
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        net(torch.rand(1, 1, H, H))
    assert seen == conv3x3_shapes(enc, H)


@pytest.mark.parametrize("enc,H", [((8, 16, 32), 32), ((4, 8, 16, 32), 48)])
def test_upsample_shapes_are_the_unets(enc, H, monkeypatch):
    """upsample_shapes lists the (C, h, H) of every upsample a forward runs,
    in order: the shapes the resize backward kernel is checked and timed at."""
    import mm_masking_tpu_torch.models.unet as unet_module

    seen, real = [], unet_module.upsample_bilinear_align_corners

    def spy(x, size, axes=(2, 3)):
        assert x.shape[2] == x.shape[3] and size[0] == size[1]
        seen.append((x.shape[1], x.shape[2], size[0]))
        return real(x, size, axes)

    monkeypatch.setattr(unet_module, "upsample_bilinear_align_corners", spy)
    net = UNet(1, enc, dropout=0.0)
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        net(torch.rand(1, 1, H, H))
    assert seen == upsample_shapes(enc, H)


# (x shape, output size): the UNet's 2x upsample, odd sizes, an axis of size 1
# (the repeat) on either side, and a shrinking axis.
UPSAMPLE_CASES = [((1, 2, 20, 20), (40, 40)), ((2, 3, 5, 7), (9, 13)),
                  ((2, 3, 1, 7), (9, 13)), ((2, 3, 5, 1), (4, 6))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,size", UPSAMPLE_CASES)
def test_upsample_gradient_matches_jax(shape, size, dtype):
    """The port's autograd of the upsample (on the CPU the gather-form
    backward's plain version, index_add) against jax.vjp of the JAX
    upsample, on the same numpy x and cotangent. Limits: float32 within 1e-6
    of max |g| (the same products summed in another order); bfloat16 within
    1e-2 of max |g| (both round each product and partial sum to 8 bits, in
    other orders)."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(lambda a: jup(a, size, axes=(2, 3)), jnp.asarray(x).astype(jdt))
    cot = rng.standard_normal(y.shape).astype(np.float32)
    (want,) = vjp(jnp.asarray(cot).astype(jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    yt = upsample_bilinear_align_corners(xt, size)
    (got,) = torch.autograd.grad(yt, xt, torch.from_numpy(cot).to(tdt))
    assert got.dtype == tdt and got.shape == xt.shape
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("n_in,n_out", [(5, 9), (20, 40), (320, 640), (7, 3), (1, 6)])
def test_resize_offsets_give_each_rows_ascending_runs(n_in, n_out):
    """The resize backward kernel's order, emulated: input row j sums dy over
    the output rows [off[j - 1], off[j]) with w1, then [off[j], off[j + 1])
    with w0, each product and partial sum rounded to float32. Its runs are
    exactly the rows that read j, and the sums agree with the plain version
    (index_add) within 1e-6 of max |dx|."""
    i0, w0, w1 = resize_tables(n_in, n_out, torch.float32, torch.device("cpu"))
    off = resize_offsets(i0, n_in)
    assert off.dtype == torch.int32 and off.tolist() == [int((i0 < j).sum())
                                                         for j in range(n_in + 1)]
    dy = torch.from_numpy(np.random.default_rng(22).standard_normal((3, n_out)).astype(
        np.float32))
    dx = torch.zeros(3, n_in)
    for j in range(n_in):
        runs = ([(i, w1) for i in range(off[j - 1], off[j])] if j else []) + [
            (i, w0) for i in range(off[j], off[j + 1])]
        assert sorted({i for i, _ in runs}) == [i for i in range(n_out) if i0[i] == j or (
            n_in > 1 and i0[i] + 1 == j)]
        for i, w in runs:
            dx[:, j] += dy[:, i] * w[i]
    want = resize_bwd_plain(dy, i0, w0, w1, n_in, 1)
    assert (dx - want).abs().max() <= 1e-6 * want.abs().max()
