"""The port's training path vs the JAX package on the CPU: the loss pieces,
the policy's training forward, the optimizer against optax, one whole
train step against the JAX ``Trainer._train_step`` from the same converted
parameters, and the fit/resume/CLI loop at a tiny size."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mm_masking_tpu.config import (
    Config as JConfig,
    LossWeights as JLossWeights,
    ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from mm_masking_tpu.data.synthetic import SyntheticSpec as JSpec, synthetic_batch as jbatch
from mm_masking_tpu.models.policy import _safe_amax_hw as jsafe_amax
from mm_masking_tpu.parallel import make_mesh
from mm_masking_tpu.train.loss import bce as jbce, eval_training_loss as jtrain_loss
from mm_masking_tpu.train.metrics import MetricsLogger as JMetricsLogger
from mm_masking_tpu.train.trainer import Trainer as JTrainer, make_optimizer as jmake_optimizer
from mm_masking_tpu_torch.config import Config, LossWeights, ModelConfig, TrainConfig
from mm_masking_tpu_torch.data import (
    ICPWeightDataset,
    SyntheticSpec,
    epoch_batches,
    synthetic_batch,
)
from mm_masking_tpu_torch.data.testing import write_synthetic_dataset
from mm_masking_tpu_torch.models import UNet, params_from_flax
from mm_masking_tpu_torch.models.policy import _safe_amax_hw
from mm_masking_tpu_torch.train import Trainer, bce, eval_training_loss, make_optimizer
from mm_masking_tpu_torch.train import profile_step, train_icp_weights
from mm_masking_tpu_torch.train.metrics import MetricsLogger

SPEC = dict(n_scan=128, n_map=512, polar_shape=(64, 256), cart_pixel_width=64, res=0.25,
            cart_resolution=0.5, max_range=15.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
MODEL = dict(enc_channels=(4, 8), dropout=0.0, cart_pixel_width=64, cart_resolution=0.5,
             res=0.25, polar_shape=(64, 256), max_iter=3, inference_max_iter=8)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def tiny_config(tmp_path, **model) -> Config:
    return Config(model=ModelConfig(**{**MODEL, **model}),
                  train=TrainConfig(batch_size_train=4, batch_size_test=4, num_epochs=2,
                                    checkpoint_dir=str(tmp_path)))


def test_safe_amax_backward_matches_jax():
    """Ties split the cotangent evenly; an image whose max no element
    reaches (NaN here) gets a zero gradient, not NaN."""
    x = np.random.default_rng(0).random((3, 5, 6)).astype(np.float32)
    x[0, 1, 2] = x[0, 3, 4] = x[0, 0, 0] = 2.0  # a three-way tie
    x[2, 2, 2] = np.nan
    g = np.array([1.5, -0.5, 2.0], np.float32)[:, None, None]
    _, vjp = jax.vjp(jsafe_amax, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(_safe_amax_hw(t), (t,), torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isfinite(got).all() and got[0, 1, 2] == 0.5


def test_bce_matches_jax_at_saturated_predictions():
    pred = np.array([[0.0, 1.0, 0.3], [1.0, 0.0, 0.999]], np.float32)
    target = np.array([[0.0, 1.0, 1.0], [0.0, 1.0, 0.0]], np.float32)
    want, (jp, jt) = jax.value_and_grad(jbce, argnums=(0, 1))(jnp.asarray(pred),
                                                              jnp.asarray(target))
    p = torch.from_numpy(pred).requires_grad_(True)
    t = torch.from_numpy(target).requires_grad_(True)
    got = bce(p, t)
    gp, gt = torch.autograd.grad(got, (p, t))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    assert torch.isfinite(gp).all()
    np.testing.assert_allclose(gp.numpy(), np.asarray(jp), rtol=1e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(jt), rtol=1e-5)


def test_dropout_is_seeded_and_leaves_the_global_generator_alone():
    net = UNet(enc_channels=(4, 8), dropout=0.3)
    net.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(2, 1, 16, 16, generator=torch.Generator().manual_seed(1))
    before = torch.random.get_rng_state()
    a = net(x, train=True, generator=torch.Generator().manual_seed(5))
    b = net(x, train=True, generator=torch.Generator().manual_seed(5))
    c = net(x, train=True, generator=torch.Generator().manual_seed(6))
    assert torch.equal(torch.random.get_rng_state(), before)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, net(x))  # inference: no dropout
    with pytest.raises(ValueError, match="Generator"):
        net(x, train=True)


def test_unported_training_modes_raise(tmp_path):
    """Batch-norm training runs since it was ported: a training forward
    normalises with the batch's statistics and moves the running ones in
    place, an inference forward uses them and moves nothing
    (``test_batch_norm_train_steps_match_flax`` holds the values)."""
    batch = to_torch(jbatch(0, 2, JSpec(**SPEC)))
    args = (batch["loc_data"], batch["map_data"], batch["transforms"]["T_ml_init"])
    bn = Trainer(tiny_config(tmp_path, batch_norm=True), "cpu")
    params = bn.init_state(0).params
    running = {k: v.clone() for k, v in params.items() if "running" in k}
    out = bn.policy.apply(params, *args, train=True)
    assert torch.isfinite(out.T_pred).all() and torch.isfinite(out.weight_mask).all()
    assert all(not torch.equal(params[k], v) for k, v in running.items())
    moved = {k: params[k].clone() for k in running}
    bn.policy.apply(params, *args)
    assert all(torch.equal(params[k], v) for k, v in moved.items())


# Batch-norm training against flax. In bfloat16 the JAX head rounds its
# logits and its backward to 8 bits where the port's head keeps float32
# (ROADMAP §3, fault 4), and every conv output is rounded to 8 bits after
# sums in other orders: the loss within 2e-2, the gradients within 1e-1 of
# their max |g| (the head's bias sums 512 such cotangents). The running
# statistics are float32 sums of the same values in both: 1e-5.
BN_TOL = {"float32": dict(loss=1e-5, grad=1e-4, stats=1e-5),
          "bfloat16": dict(loss=2e-2, grad=1e-1, stats=1e-5)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_steps_match_flax(dtype):
    """Two training applications of a batch-norm UNet (flax's
    ``mutable=["batch_stats"]``; each decoder block's statistics update
    twice, in order) from the same parameters and input: after each, the
    loss Σ mask·c, every parameter's gradient (within BN_TOL of its max |g|)
    and the running statistics (biased variance, decay 0.99)."""
    from mm_masking_tpu.models.unet import UNet as JUNet
    from torch.func import functional_call

    rng = np.random.default_rng(3)
    x = rng.random((2, 16, 16, 1)).astype(np.float32)
    cot = rng.standard_normal((2, 16, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ju = JUNet(enc_channels=(4, 8), batch_norm=True, dropout=0.0, dtype=jdt)
    variables = ju.init(jax.random.PRNGKey(0), jnp.asarray(x))
    net = UNet(in_channels=1, enc_channels=(4, 8), batch_norm=True, dropout=0.0, dtype=tdt)
    params = params_from_flax(variables["params"], variables["batch_stats"])
    for k in params:
        params[k].requires_grad_("running" not in k and "num_batches" not in k)
    trained = [k for k in params if params[k].requires_grad]
    tol = BN_TOL[dtype]

    def jloss(p, stats):
        y, upd = ju.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), upd["batch_stats"]

    stats = variables["batch_stats"]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    for _ in range(2):
        (want, stats), jgrads = jax.value_and_grad(jloss, has_aux=True)(variables["params"],
                                                                         stats)
        y = functional_call(net, params, (xt,), {"train": True})
        got = (y * torch.from_numpy(cot)).sum()
        grads = dict(zip(trained, torch.autograd.grad(got, [params[k] for k in trained])))
        np.testing.assert_allclose(got.item(), float(want), rtol=tol["loss"])
        for k, g in params_from_flax(jgrads, stats).items():
            if k in grads:
                np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=0,
                                           atol=tol["grad"] * g.abs().max().item(), err_msg=k)
            elif "running" in k:
                np.testing.assert_allclose(params[k].detach().numpy(), g.numpy(), rtol=0,
                                           atol=tol["stats"] * g.abs().max().item(), err_msg=k)


def test_batch_norm_trainer_steps_match_jax(tmp_path):
    """Two whole train steps with batch norm (policy, ICP, loss, Adam) from
    the same parameters and running statistics as the JAX Trainer's: the
    loss and its components, grad_norm, and after each step the parameters
    and the running statistics, updated in place in the port. The ICP terms
    alone: the batch-norm mask reaches its max where the map's BEV is 0, and
    there the mask-points BCE's gradient is rounding noise of a 1e12 term in
    both packages (ROADMAP §3, fault 2)."""
    jcfg = JConfig(model=JModelConfig(**MODEL, batch_norm=True),
                   loss=JLossWeights(mask_pts=0.0),
                   train=JTrainConfig(batch_size_train=4, checkpoint_dir=str(tmp_path / "j")))
    jtr = JTrainer(jcfg, mesh=make_mesh(1), logger=JMetricsLogger(str(tmp_path / "j")))
    jstate = jtr.init_state()
    batch = jbatch(0, 4, JSpec(**SPEC))
    trainer = Trainer(dataclasses.replace(tiny_config(tmp_path / "t", batch_norm=True),
                                          loss=LossWeights(mask_pts=0.0)), "cpu")
    state = trainer.init_state()
    running = {k: state.params[k] for k in state.params if "running" in k}
    with torch.no_grad():
        for k, v in params_from_flax(jstate.variables["params"],
                                     jstate.variables["batch_stats"]).items():
            state.params[k].copy_(v)
    for step in range(2):
        jstate, jl, jcomp, jgn = jtr._train_step(jstate, batch, mask_losses_active=True)
        state, loss, comp, gn = trainer.train_step(state, to_torch(batch))
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
        for f in comp._fields:
            np.testing.assert_allclose(getattr(comp, f).item(), float(getattr(jcomp, f)),
                                       rtol=1e-5, atol=1e-7, err_msg=f)
        np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-3)
        want = params_from_flax(jstate.variables["params"], jstate.variables["batch_stats"])
        for k, v in want.items():
            # After the second step a parameter whose gradient is near 0 may
            # move by up to lr on an ulp-level difference (Adam's g / |g|).
            atol = 1e-6 if step == 0 or "running" in k else 1e-4
            np.testing.assert_allclose(state.params[k].detach().numpy(), v.numpy(), rtol=0,
                                       atol=atol, err_msg=k)
        assert all(state.params[k] is t for k, t in running.items())  # in place


def test_training_forward_options(tmp_path):
    batch = to_torch(jbatch(0, 2, JSpec(**SPEC)))
    args = (batch["loc_data"], batch["map_data"], batch["transforms"]["T_ml_init"])
    # Without both ICP loss terms the solver is skipped.
    cfg = dataclasses.replace(tiny_config(tmp_path), loss=LossWeights(icp_rot=0.0))
    tr = Trainer(cfg, "cpu")
    out = tr.policy.apply(tr.init_state(0).params, *args, train=True)
    assert out.T_pred is args[2] and out.icp_info is None
    # icp_overrides reach the training solver too.
    tr = Trainer(tiny_config(tmp_path, icp_overrides=("trim_dist=3", "nn_stripe=false")), "cpu")
    assert tr.policy._icp_train.trim_dist == 3.0 and tr.policy._icp_train.nn_stripe is False
    out = tr.policy.apply(tr.init_state(0).params, *args, train=True)
    assert out.icp_info["delta_norms"].shape == (3, 2)


@pytest.mark.parametrize("kind", ["adam_cosine_clip", "sgd_constant", "sgd_cosine_clip"])
def test_optimizer_matches_optax(kind):
    """Five updates, the third with a NaN gradient (dropped by both); the
    schedule's rate is taken on the device from the count of applied
    updates."""
    if kind == "sgd_constant":
        kw = dict(optimizer="sgd", learning_rate=1e-2)
    else:
        kw = dict(learning_rate=1e-2, lr_schedule="cosine", lr_decay_steps=6,
                  lr_warmup_steps=2, clip_value=0.05)
        if kind.startswith("sgd"):
            kw["optimizer"] = "sgd"
    tx = jmake_optimizer(JConfig(train=JTrainConfig(**kw)))
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((2, 3)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(p0[k].copy()).requires_grad_(True) for k in ("a", "b")]
    opt = make_optimizer(TrainConfig(**kw), tparams)
    for step in range(5):
        grads = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
                 for k, v in p0.items()}
        if step == 2:
            grads["b"][1] = np.nan
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        applied = opt.step([torch.from_numpy(grads[k]) for k in ("a", "b")])
        assert applied == (step != 2)
        for k, t in zip(("a", "b"), tparams):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6)
    assert opt.total_notfinite == int(jstate.total_notfinite) == 1
    assert opt.count == 4
    assert opt.count.dtype == opt.total_notfinite.dtype == torch.int64
    if kind != "sgd_constant":
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)
        np.testing.assert_allclose([opt.schedule(c) for c in range(9)],
                                   [float(sched(c)) for c in range(9)], rtol=1e-6, atol=1e-9)
        rates = [opt.schedule(torch.tensor(c)) for c in range(9)]  # from a count tensor
        assert all(r.dtype == torch.float32 and r.shape == () for r in rates)
        np.testing.assert_allclose([float(r) for r in rates],
                                   [float(sched(jnp.int32(c))) for c in range(9)],
                                   rtol=1e-6, atol=1e-9)


@contextlib.contextmanager
def no_host_reads():
    """Every Python-level read of a tensor's value raises inside the block."""
    def refuse(self, *args, **kwargs):
        raise AssertionError("a tensor's value was read on the host")

    with contextlib.ExitStack() as stack:
        for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist"):
            stack.enter_context(mock.patch.object(torch.Tensor, name, refuse))
        yield


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_skips_a_non_finite_step_on_the_device(kind, bad):
    """apply_if_finite's contract with no read from the device: a step
    whose gradients hold a non-finite value leaves the parameters, the
    moments and the count bit for bit as they were and adds 1 to
    total_notfinite; the next finite step updates as usual."""
    rng = np.random.default_rng(2)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_(True)
              for s in ((3, 2), (5,))]
    opt = make_optimizer(TrainConfig(optimizer=kind, learning_rate=1e-2, lr_schedule="cosine",
                                     lr_decay_steps=8, lr_warmup_steps=1, clip_value=0.5),
                         params)

    def grads(poison=False):
        g = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for p in params]
        if poison:
            g[1][2] = bad
        return g

    with no_host_reads():
        opt.step(grads())
        before = [t.clone() for t in opt.tensors()]
        applied = opt.step(grads(poison=True))
    assert applied.dtype == torch.bool and not bool(applied)
    after = opt.tensors()
    assert int(opt.total_notfinite) == int(before[-1]) + 1 == 1
    for a, b in zip(after[:-1], before[:-1]):  # parameters, moments, count
        assert torch.equal(a, b)
        assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                           b.view(torch.int32) if b.is_floating_point() else b)
    with no_host_reads():
        applied = opt.step(grads())
    assert bool(applied) and int(opt.count) == 2 and int(opt.total_notfinite) == 1
    assert not torch.equal(params[0], before[0])


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_optimizer_state_dict_keeps_the_checkpoint_format(kind):
    """state_dict() as before (torch.optim's ``inner``, int counters), so
    checkpoints written by the torch.optim-based optimizer still load, and
    new ones load into torch.optim."""
    rng = np.random.default_rng(3)
    shapes = ((4, 3), (2,))
    p_old = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_(True)
             for s in shapes]
    if kind == "adam":
        old = torch.optim.Adam(p_old, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    else:
        old = torch.optim.SGD(p_old, lr=1e-3, momentum=1.0, nesterov=True)
    for _ in range(2):
        for p in p_old:
            p.grad = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
        old.step()
    ckpt = {"inner": old.state_dict(), "count": 2, "total_notfinite": 1}
    params = [p.detach().clone().requires_grad_(True) for p in p_old]
    opt = make_optimizer(TrainConfig(optimizer=kind, learning_rate=1e-3), params)
    opt.load_state_dict(ckpt)
    keys = ("exp_avg", "exp_avg_sq") if kind == "adam" else ("momentum_buffer",)
    for i, p in enumerate(p_old):
        for key, moments in zip(keys, opt.moments):
            assert torch.equal(moments[i], old.state[p][key])
    assert int(opt.count) == 2 and int(opt.total_notfinite) == 1
    saved = opt.state_dict()
    assert saved["count"] == 2 and saved["total_notfinite"] == 1
    assert isinstance(saved["count"], int) and isinstance(saved["total_notfinite"], int)
    fresh = torch.optim.Adam(p_old) if kind == "adam" else torch.optim.SGD(
        p_old, lr=1e-3, momentum=1.0, nesterov=True)
    fresh.load_state_dict(saved["inner"])
    for i, p in enumerate(p_old):
        for key, moments in zip(keys, opt.moments):
            assert torch.equal(fresh.state[p][key], moments[i])
    before_first = make_optimizer(TrainConfig(optimizer=kind), params)
    before_first.load_state_dict({"inner": {"state": {}, "param_groups": []}, "count": 0,
                                  "total_notfinite": 0})
    assert all(not m.any() for ms in before_first.moments for m in ms)


def test_train_step_reads_nothing_from_the_device(tmp_path):
    """A whole train step (dense association at this size) with no
    Python-level read of a tensor's value: what the step captured as a CUDA
    graph on the card runs here eagerly."""
    trainer = Trainer(tiny_config(tmp_path, dropout=0.05), "cpu")
    state = trainer.init_state(0)
    batch = synthetic_batch(0, 4, SyntheticSpec(**SPEC))
    with no_host_reads():
        _, loss, comp, grad_norm = trainer.train_step(state, batch)
        trainer.train_step(state, batch)
    assert np.isfinite(float(loss)) and np.isfinite(float(grad_norm))
    assert int(state.opt.count) == 2 and state.step == 2


def test_train_step_matches_jax(tmp_path):
    """One step from the same parameters and batch, dropout off: loss,
    per-parameter gradients, grad_norm and the updated parameters."""
    jcfg = JConfig(model=JModelConfig(**MODEL),
                   train=JTrainConfig(batch_size_train=4, checkpoint_dir=str(tmp_path / "j")))
    jtr = JTrainer(jcfg, mesh=make_mesh(1), logger=JMetricsLogger(str(tmp_path / "j")))
    jstate = jtr.init_state()
    batch = jbatch(0, 4, JSpec(**SPEC))

    def jloss(params):
        out = jtr.policy.apply({"params": params}, batch["loc_data"], batch["map_data"],
                               batch["transforms"]["T_ml_init"], train=True)
        return jtrain_loss(out.T_pred, out.weight_mask, out.diff_mean_num_non0,
                           out.mean_all_pts, batch["transforms"]["T_ml_gt"],
                           batch["loc_data"], batch["map_data"], jcfg.loss,
                           cart_pixel_width=64, cart_resolution=0.5)[0]

    jgrads = jax.jit(jax.grad(jloss))(jstate.variables["params"])
    jnew, jl, jcomp, jgn = jtr._train_step(jstate, batch, mask_losses_active=True)

    trainer = Trainer(tiny_config(tmp_path / "t"), "cpu")
    state = trainer.init_state()
    with torch.no_grad():
        for k, v in params_from_flax(jstate.variables["params"]).items():
            state.params[k].copy_(v)
    tbatch = to_torch(batch)
    out = trainer.policy.apply(state.params, tbatch["loc_data"], tbatch["map_data"],
                               tbatch["transforms"]["T_ml_init"], train=True)
    loss_fwd, _ = eval_training_loss(out.T_pred, out.weight_mask, out.diff_mean_num_non0,
                                     out.mean_all_pts, tbatch["transforms"]["T_ml_gt"],
                                     tbatch["loc_data"], tbatch["map_data"],
                                     trainer.cfg.loss, cart_pixel_width=64,
                                     cart_resolution=0.5)
    names = list(state.params)
    tgrads = dict(zip(names, torch.autograd.grad(loss_fwd, [state.params[k] for k in names])))
    for k, want in params_from_flax(jgrads).items():
        scale = want.abs().max().item()
        np.testing.assert_allclose(tgrads[k].numpy(), want.numpy(), rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=k)

    state, loss, comp, gn = trainer.train_step(state, tbatch)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for f in comp._fields:
        np.testing.assert_allclose(getattr(comp, f).item(), float(getattr(jcomp, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-3)
    for k, want in params_from_flax(jnew.variables["params"]).items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert state.step == 1 and state.opt.count == 1


def test_implicit_train_step_matches_jax(tmp_path):
    """icp_diff_mode="implicit" (the solve to tolerance at max(5·3, 50)
    iterations, its weight gradient by the implicit function theorem): one
    step from the same parameters and batch, dropout off, against the JAX
    Trainer's: loss and its components within 1e-5, grad_norm within 1e-3,
    with no host read in the step. (The updated parameters are not compared:
    Adam's first step is g / (|g| + 1e-8) · lr, so a gradient entry near 0
    moves its parameter by up to lr on an ulp-level difference.)"""
    model = dict(MODEL, icp_diff_mode="implicit")
    jcfg = JConfig(model=JModelConfig(**model),
                   train=JTrainConfig(batch_size_train=4, checkpoint_dir=str(tmp_path / "j")))
    jtr = JTrainer(jcfg, mesh=make_mesh(1), logger=JMetricsLogger(str(tmp_path / "j")))
    jstate = jtr.init_state()
    batch = jbatch(0, 4, JSpec(**SPEC))
    _, jl, jcomp, jgn = jtr._train_step(jstate, batch, mask_losses_active=True)

    trainer = Trainer(tiny_config(tmp_path / "t", icp_diff_mode="implicit"), "cpu")
    state = trainer.init_state()
    with torch.no_grad():
        for k, v in params_from_flax(jstate.variables["params"]).items():
            state.params[k].copy_(v)
    with no_host_reads():
        state, loss, comp, gn = trainer.train_step(state, to_torch(batch))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for f in comp._fields:
        np.testing.assert_allclose(getattr(comp, f).item(), float(getattr(jcomp, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-3)
    assert state.step == 1 and int(state.opt.count) == 1


def test_fit_and_resume(tmp_path):
    cfg = dataclasses.replace(tiny_config(tmp_path / "fit"), model=dataclasses.replace(
        tiny_config(tmp_path).model, dropout=0.05))
    train = [synthetic_batch(i, 4, SyntheticSpec(**SPEC)) for i in range(2)]
    val = [synthetic_batch(100, 4, SyntheticSpec(**SPEC))]
    trainer = Trainer(cfg, "cpu")
    assert not os.path.exists(trainer.logger.path)  # nothing written before a record
    state = trainer.fit(lambda epoch: train, lambda: val)
    assert (state.epoch, state.step) == (2, 4)
    files = set(os.listdir(tmp_path / "fit"))
    assert {"best_policy.pt", "epoch_0.pt", "epoch_1.pt", "config.json",
            "run_metrics.jsonl"} <= files
    events = [json.loads(line)["event"] for line in open(trainer.logger.path)]
    assert events == ["baseline", "pretrain_val", "epoch", "epoch", "final_val"]
    recs = [json.loads(line) for line in open(trainer.logger.path)]
    assert all(np.isfinite(r["loss"]) for r in recs if r["event"] == "epoch")

    resumed = Trainer(cfg, "cpu").resume()
    assert (resumed.epoch, resumed.step, resumed.opt.count) == (2, 4, 4)
    for k, v in state.params.items():
        assert torch.equal(resumed.params[k], v), k
    assert torch.equal(resumed.generator.get_state(), state.generator.get_state())
    # The same next step from the resumed state as from the live one.
    _, loss_a, *_ = trainer.train_step(state, train[0])
    _, loss_b, *_ = trainer.train_step(resumed, train[0])
    assert loss_a.item() == loss_b.item()


@pytest.mark.parametrize("fixed", [False, True])
def test_cli_trains_on_synthetic_data(tmp_path, fixed):
    out = tmp_path / "cli"
    train_icp_weights.main([
        "--synthetic", "--synthetic-frames", "4", "--device", "cpu",
        *(["--synthetic-fixed"] if fixed else []),
        "--set", "model.enc_channels=4,8", "--set", "model.cart_pixel_width=64",
        "--set", "model.cart_resolution=0.5", "--set", "model.res=0.25",
        "--set", "model.polar_shape=64,256", "--set", "model.max_iter=2",
        "--set", "model.inference_max_iter=4", "--set", "data.max_loc_pts=128",
        "--set", "data.max_map_pts=512", "--set", "data.pos_std=0.4",
        "--set", "data.rot_std=0.15", "--set", "train.batch_size_train=4",
        "--set", "train.batch_size_test=4", "--set", "train.num_epochs=1",
        "--set", f"train.checkpoint_dir={out}",
    ])
    events = [json.loads(line)["event"] for line in open(out / "run_metrics.jsonl")]
    assert events[-1] == "final_val" and "epoch" in events


def write_default_tree(root, frames_per_pair: int = 1, val_frames: int = 4) -> Config:
    """A Boreas-layout tree under the default Config()'s pair names, at the
    tiny size: one frame for each training pair (12) and ``val_frames`` for
    the validation pair."""
    for i, (map_seq, loc_seq) in enumerate(Config().train_loc_pairs):
        write_synthetic_dataset(str(root), map_seq, loc_seq, n_frames=frames_per_pair,
                                n_scan=128, n_map=512, polar_shape=(64, 256), seed=i)
    for map_seq, loc_seq in Config().val_loc_pairs:
        write_synthetic_dataset(str(root), map_seq, loc_seq, n_frames=val_frames,
                                n_scan=128, n_map=512, polar_shape=(64, 256), seed=99)
    return dataclasses.replace(tiny_config(root / "ckpt"), data=dataclasses.replace(
        Config().data, data_dir=str(root), pos_std=0.4, rot_std=0.15))


@pytest.mark.parametrize("mask_pts", [1.0, 0.0])
def test_dataset_fed_train_step_matches_jax(tmp_path, mask_pts):
    """The slice as a whole: a batch of the written tree, collated and
    preprocessed by the port's loader (int64 timestamps among its leaves),
    through one train step of each package from the same parameters: the
    loss within 1e-5. grad_norm is held to 1e-3 with the ICP loss terms
    only (mask_pts 0): on this tree the mask-points BCE is ill-conditioned
    in both packages, its largest pixels a few float32 ulps under 1 after
    the max normalisation, where 1/(p(1−p)) moves by up to 2× with one ulp
    of the division's rounding (ROADMAP.md §3)."""
    cfg = dataclasses.replace(write_default_tree(tmp_path),
                              loss=LossWeights(mask_pts=mask_pts))
    ds = ICPWeightDataset(list(cfg.train_loc_pairs), cfg, "train")
    assert len(ds) == 12
    batch = next(epoch_batches(ds, 4, cfg, seed=0, device="cpu"))
    assert batch["loc_data"]["timestamp"].dtype == torch.int64
    assert batch["loc_data"]["fft_data"].shape == (4, 64, 64)
    jcfg = JConfig(model=JModelConfig(**MODEL), loss=JLossWeights(mask_pts=mask_pts),
                   train=JTrainConfig(batch_size_train=4, checkpoint_dir=str(tmp_path / "j")))
    jtr = JTrainer(jcfg, mesh=make_mesh(1), logger=JMetricsLogger(str(tmp_path / "j")))
    jstate = jtr.init_state()
    jbatch_np = jax.tree_util.tree_map(lambda t: t.numpy(), batch)
    _, jl, _, jgn = jtr._train_step(jstate, jbatch_np, mask_losses_active=True)
    trainer = Trainer(cfg, "cpu")
    state = trainer.init_state()
    with torch.no_grad():
        for k, v in params_from_flax(jstate.variables["params"]).items():
            state.params[k].copy_(v)
    state, loss, _, gn = trainer.train_step(state, batch)
    assert torch.isfinite(loss) and gn.item() > 0
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    if mask_pts == 0.0:
        np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-3)


def test_cli_trains_on_a_written_tree(tmp_path):
    """Without --synthetic the CLI trains on a tree in the converted layout
    (ICPWeightDataset, epoch_batches): baseline, pre-training validation,
    one epoch of 3 steps, final validation, checkpoints."""
    write_default_tree(tmp_path)
    out = tmp_path / "cli"
    train_icp_weights.main([
        "--device", "cpu", "--set", f"data.data_dir={tmp_path}",
        "--set", "model.enc_channels=4,8", "--set", "model.cart_pixel_width=64",
        "--set", "model.cart_resolution=0.5", "--set", "model.res=0.25",
        "--set", "model.polar_shape=64,256", "--set", "model.max_iter=2",
        "--set", "model.inference_max_iter=4", "--set", "data.pos_std=0.4",
        "--set", "data.rot_std=0.15", "--set", "train.batch_size_train=4",
        "--set", "train.batch_size_test=4", "--set", "train.num_epochs=1",
        "--set", f"train.checkpoint_dir={out}",
    ])
    records = [json.loads(line) for line in open(out / "run_metrics.jsonl")]
    events = [r["event"] for r in records]
    assert events == ["baseline", "pretrain_val", "epoch", "final_val"]
    epoch = records[2]
    assert all(np.isfinite(epoch[k]) for k in ("loss", "grad_norm", "acc"))
    assert {"best_policy.pt", "epoch_0.pt", "config.json"} <= set(os.listdir(out))


def test_profile_step_runs_on_cpu(capsys):
    """The train-step profiler at a tiny size: every phase timed, no device
    numbers claimed for the CPU."""
    out = profile_step.main([
        "--device", "cpu", "--set", "train.batch_size_train=2",
        "--set", "data.max_loc_pts=128", "--set", "data.max_map_pts=512",
        "--set", "model.enc_channels=4,8",
        "--set", "model.cart_pixel_width=64", "--set", "model.cart_resolution=0.5",
        "--set", "model.res=0.25", "--set", "model.polar_shape=64,256",
        "--set", "model.max_iter=2", "--set", "data.pos_std=0.4", "--set", "data.rot_std=0.15",
    ])
    assert set(out["phases_ms"]) == {"unet_forward", "icp_forward", "loss", "backward",
                                     "optimizer"}
    assert out["launches"] == 0 and out["peak_mib"] is None
    assert "device time not measured" in capsys.readouterr().out


@pytest.mark.parametrize("entry", [train_icp_weights, profile_step])
def test_cli_without_a_card_raises_naming_device_cpu(monkeypatch, entry):
    """The CLIs run on the card by default and do not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        entry.main(["--synthetic"] if entry is train_icp_weights else [])


def test_cli_overrides_parse_tuples():
    """Integer tuples as in the JAX CLI; icp_overrides, whose items are
    ``field=value`` strings, can be set too (the JAX CLI parses every tuple
    item as an int)."""
    cfg = train_icp_weights.apply_overrides(Config(), [
        "model.enc_channels=4,8", "model.icp_overrides=trim_dist=3,nn_stripe=false",
        "train.learning_rate=3e-4", "model.batch_norm=true"])
    assert cfg.model.enc_channels == (4, 8)
    assert cfg.model.icp_overrides == ("trim_dist=3", "nn_stripe=false")
    assert cfg.train.learning_rate == 3e-4 and cfg.model.batch_norm is True


def test_metrics_logger_opens_no_file_before_a_record(tmp_path):
    log = MetricsLogger(str(tmp_path / "never"))
    assert not (tmp_path / "never").exists()
    log.log("x", {"v": torch.tensor(2.5)})
    assert json.loads(open(log.path).read())["v"] == 2.5
