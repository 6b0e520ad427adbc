"""The port's polar network I/O against the JAX package's on the CPU:
``ops/radar.py``'s ``pol_2_cart``, ``form_polar_range_grid`` and
``radar_cartesian_to_polar``; the policy at ``("polar", "polar")`` on an odd
polar shape, (50, 210) with ``enc_channels=(4, 8, 16, 32)``, so that the
max-pools floor (25 × 105 → 12 × 52 → 6 × 26) and the decoder resizes to
odd skips; one train step's loss and UNet gradient against ``jax.grad`` with
``loss.mask_pts=0``; the warp's gather-form gradient against ``jax.vjp``.

Limits: the radar functions 1e-5 of their values' scale; the polar mask
1e-5 (the UNet's float32 sums in another order); the loss 1e-5 relative and
each UNet gradient 1e-3 of its max, as ``tests/test_torch_train.py``; the
warp's gradient 1e-5 of its max.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mm_masking_tpu.ops.radar as jradar
from mm_masking_tpu.config import (
    Config as JConfig,
    LossWeights as JLossWeights,
    ModelConfig as JModelConfig,
)
from mm_masking_tpu.data.synthetic import SyntheticSpec as JSpec, synthetic_batch as jbatch
from mm_masking_tpu.models.policy import LearnICPWeightPolicy as JPolicy
from mm_masking_tpu.train.loss import eval_training_loss as jtrain_loss
from mm_masking_tpu_torch.config import Config, LossWeights, ModelConfig, TrainConfig
from mm_masking_tpu_torch.models import LearnICPWeightPolicy, UNet, params_from_flax
from mm_masking_tpu_torch.models.unet import conv3x3_shapes, upsample_shapes
from mm_masking_tpu_torch.ops import radar
from mm_masking_tpu_torch.train import Trainer, eval_training_loss

POLAR = (50, 210)
ENC = (4, 8, 16, 32)
SPEC = dict(n_scan=128, n_map=512, polar_shape=POLAR, cart_pixel_width=64, res=0.25,
            cart_resolution=0.5, max_range=15.0, min_range=2.0, pos_std=0.4, rot_std=0.15,
            network_input_type="polar")
MODEL = dict(enc_channels=ENC, dropout=0.0, cart_pixel_width=64, cart_resolution=0.5,
             res=0.25, polar_shape=POLAR, max_iter=3, inference_max_iter=8,
             network_input_type="polar", network_output_type="polar", range_input=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_radar_functions_match_jax():
    rng = np.random.default_rng(0)
    pc = np.stack([rng.uniform(0, 60, (3, 40)), rng.uniform(0, 2 * np.pi, (3, 40)),
                   rng.normal(size=(3, 40))], -1).astype(np.float32)
    np.testing.assert_allclose(radar.pol_2_cart(torch.from_numpy(pc)).numpy(),
                               np.asarray(jradar.pol_2_cart(jnp.asarray(pc))), rtol=0,
                               atol=1e-5 * 60)
    for args in ((), (0.0596, (400, 3360)), (0.25, POLAR)):
        got = radar.form_polar_range_grid(*args).numpy()
        want = np.asarray(jradar.form_polar_range_grid(*args))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    cart = rng.random((2, 64, 64)).astype(np.float32)
    az = np.sort(rng.uniform(0, 2 * np.pi, (2, POLAR[0])), axis=1).astype(np.float32)
    got = radar.radar_cartesian_to_polar(torch.from_numpy(cart), torch.from_numpy(az), 0.25, 0.5,
                                         POLAR).numpy()
    want = np.asarray(jradar.radar_cartesian_to_polar(jnp.asarray(cart), jnp.asarray(az), 0.25,
                                                      0.5, POLAR))
    assert got.shape == (2, *POLAR)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def warp_inputs(seed=1):
    rng = np.random.default_rng(seed)
    mask = rng.random((2, *POLAR)).astype(np.float32)
    az = np.sort(rng.uniform(0, 2 * np.pi, (2, POLAR[0])), axis=1).astype(np.float32)
    return mask, az


def test_polar_mask_warp_and_its_gradient_match_jax():
    """The lookup-form warp equals ``radar_polar_to_cartesian`` (the port's
    and JAX's), and its mask gradient JAX's VJP of the warp."""
    mask, az = warp_inputs()
    dy = np.random.default_rng(2).normal(size=(2, 64, 64)).astype(np.float32)
    want, vjp = jax.vjp(lambda m: jradar.radar_polar_to_cartesian(m, jnp.asarray(az), 0.25, 0.5,
                                                                  64), jnp.asarray(mask))
    (want_g,) = vjp(jnp.asarray(dy))
    m = torch.from_numpy(mask).requires_grad_(True)
    got = radar.polar_mask_to_cartesian(m, torch.from_numpy(az), 0.25, 0.5, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    plain = radar.radar_polar_to_cartesian(m.detach(), torch.from_numpy(az), 0.25, 0.5, 64)
    np.testing.assert_allclose(got.detach().numpy(), plain.numpy(), rtol=0, atol=1e-6)
    (g,) = torch.autograd.grad(got, m, torch.from_numpy(dy))
    scale = np.abs(np.asarray(want_g)).max()
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=0, atol=1e-5 * scale)


def test_unet_shapes_at_an_odd_polar_size(monkeypatch):
    """conv3x3_shapes and upsample_shapes at (H, W) list what the UNet runs."""
    import mm_masking_tpu_torch.models.unet as unet_module

    convs, ups = [], []
    real_conv, real_up = unet_module.conv3x3, unet_module.upsample_bilinear_align_corners

    def conv_spy(x, weight, bias, relu=False):
        convs.append((x.shape[1], weight.shape[0], x.shape[2], x.shape[3]))
        return real_conv(x, weight, bias, relu)

    def up_spy(x, size, axes=(2, 3)):
        ups.append((x.shape[1], x.shape[2], x.shape[3], *size))
        return real_up(x, size, axes)

    monkeypatch.setattr(unet_module, "conv3x3", conv_spy)
    monkeypatch.setattr(unet_module, "upsample_bilinear_align_corners", up_spy)
    net = UNet(1, ENC, dropout=0.0)
    net.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert net(torch.rand(1, 1, *POLAR)).shape == (1, *POLAR)
    assert convs == conv3x3_shapes(ENC, POLAR)
    assert ups == upsample_shapes(ENC, POLAR)
    assert ups[0][1:3] == (6, 26)  # 50 x 210 pooled three times, floored


@pytest.fixture(scope="module")
def policies():
    jcfg = JConfig(model=JModelConfig(**MODEL), loss=JLossWeights(mask_pts=0.0))
    jpol = JPolicy(jcfg)
    variables = jax.jit(jpol.init)(jax.random.PRNGKey(3))
    cfg = Config(model=ModelConfig(**MODEL), loss=LossWeights(mask_pts=0.0))
    return jpol, variables, LearnICPWeightPolicy(cfg, "cpu"), params_from_flax(
        variables["params"])


def test_polar_apply_matches_jax(policies):
    jpol, variables, tpol, params = policies
    batch = jbatch(0, 3, JSpec(**SPEC))
    tb = to_torch(batch)
    args = (batch["loc_data"], batch["map_data"], batch["transforms"]["T_ml_init"])
    targs = (tb["loc_data"], tb["map_data"], tb["transforms"]["T_ml_init"])
    assert batch["loc_data"]["fft_data"].shape == (3, *POLAR)
    np.testing.assert_allclose(tpol.range_mask.numpy(), np.asarray(jpol.range_mask), rtol=0,
                               atol=1e-5 * 52.5)
    want_mask = jax.jit(lambda v, *a: jpol.apply(v, *a, mask_only=True))(variables, *args)
    want = jax.jit(jpol.apply)(variables, *args)
    with torch.inference_mode():
        got_mask = tpol.apply(params, *targs, mask_only=True)
        got = tpol.apply(params, *targs)
    assert got_mask.shape == (3, *POLAR)
    np.testing.assert_allclose(got_mask.numpy(), np.asarray(want_mask), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.stats.mean_w.numpy(), np.asarray(want.stats.mean_w),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.T_pred.numpy()[:, :3, 3], np.asarray(want.T_pred)[:, :3, 3],
                               rtol=0, atol=1e-4)
    # The deployment path: raw polar scans in, the cartesian mask out.
    want_scan = jax.jit(jpol.mask_for_scan)(variables, batch["loc_data"]["fft_data"],
                                            batch["loc_data"]["azimuths"])
    with torch.inference_mode():
        got_scan = tpol.mask_for_scan(params, tb["loc_data"]["fft_data"],
                                      tb["loc_data"]["azimuths"])
    assert got_scan.shape == (3, 64, 64)
    np.testing.assert_allclose(got_scan.numpy(), np.asarray(want_scan), rtol=0, atol=1e-5)


def test_polar_train_step_matches_jax(policies, tmp_path):
    """The training forward's loss (mask_pts = 0: ICP, fft and num_pts terms)
    and every UNet gradient against jax.grad, then one Trainer step."""
    jpol, variables, tpol, params = policies
    batch = jbatch(0, 3, JSpec(**SPEC))
    jcfg = jpol.cfg

    def jloss(p):
        out = jpol.apply({"params": p}, batch["loc_data"], batch["map_data"],
                         batch["transforms"]["T_ml_init"], train=True)
        return jtrain_loss(out.T_pred, out.weight_mask, out.diff_mean_num_non0,
                           out.mean_all_pts, batch["transforms"]["T_ml_gt"],
                           batch["loc_data"], batch["map_data"], jcfg.loss,
                           cart_pixel_width=64, cart_resolution=0.5)[0]

    want_loss, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    cfg = Config(model=ModelConfig(**MODEL), loss=LossWeights(mask_pts=0.0),
                 train=TrainConfig(batch_size_train=3, checkpoint_dir=str(tmp_path)))
    trainer = Trainer(cfg, "cpu")
    state = trainer.init_state(0)
    with torch.no_grad():
        for k, v in params.items():
            state.params[k].copy_(v)
    tb = to_torch(batch)
    out = trainer.policy.apply(state.params, tb["loc_data"], tb["map_data"],
                               tb["transforms"]["T_ml_init"], train=True)
    loss, _ = eval_training_loss(out.T_pred, out.weight_mask, out.diff_mean_num_non0,
                                 out.mean_all_pts, tb["transforms"]["T_ml_gt"], tb["loc_data"],
                                 tb["map_data"], cfg.loss, cart_pixel_width=64,
                                 cart_resolution=0.5)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    names = list(state.params)
    tgrads = dict(zip(names, torch.autograd.grad(loss, [state.params[k] for k in names])))
    for k, want in params_from_flax(jgrads).items():
        scale = want.abs().max().item()
        assert scale > 0, k
        np.testing.assert_allclose(tgrads[k].numpy(), want.numpy(), rtol=0, atol=1e-3 * scale,
                                   err_msg=k)
    state, step_loss, _, gn = trainer.train_step(state, tb)
    np.testing.assert_allclose(step_loss.item(), float(want_loss), rtol=1e-5)
    assert np.isfinite(gn.item()) and state.opt.count == 1


def test_polar_output_with_mask_points_term_raises(tmp_path):
    """With a polar mask the mask-points BCE would compare (B, A, R) with the
    cartesian BEV; JAX's shapes do not broadcast either. The port names the
    term and the shapes."""
    cfg = Config(model=ModelConfig(**MODEL),
                 train=TrainConfig(batch_size_train=2, checkpoint_dir=str(tmp_path)))
    assert cfg.loss.mask_pts > 0
    trainer = Trainer(cfg, "cpu")
    state = trainer.init_state(0)
    tb = to_torch(jbatch(0, 2, JSpec(**SPEC)))
    with pytest.raises(ValueError, match=r"mask_pts.*\(2, 50, 210\).*\(2, 64, 64\)"):
        trainer.train_step(state, tb)
    batch = jbatch(0, 2, JSpec(**SPEC))
    polar_mask = jnp.full((2, *POLAR), 0.5, jnp.float32)
    with pytest.raises((ValueError, TypeError)):
        jtrain_loss(batch["transforms"]["T_ml_init"], polar_mask, jnp.float32(1.0),
                    jnp.float32(1.0), batch["transforms"]["T_ml_gt"], batch["loc_data"],
                    batch["map_data"], JConfig().loss, cart_pixel_width=64,
                    cart_resolution=0.5)
