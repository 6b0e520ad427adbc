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
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
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
    batch = to_torch(jbatch(0, 2, JSpec(**SPEC)))
    args = (batch["loc_data"], batch["map_data"], batch["transforms"]["T_ml_init"])
    bn = Trainer(tiny_config(tmp_path, batch_norm=True), "cpu")
    with pytest.raises(NotImplementedError, match="item 19"):
        bn.policy.apply(bn.init_state(0).params, *args, train=True)
    imp = Trainer(tiny_config(tmp_path, icp_diff_mode="implicit"), "cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        imp.policy.apply(imp.init_state(0).params, *args, train=True)
    with pytest.raises(NotImplementedError, match="item 11"):
        train_icp_weights.main([])


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
