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
from mm_masking_tpu_torch.models.unet import upsample_bilinear_align_corners

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
