"""The port's data parallelism on the CPU: two ranks of a gloo group
(spawned, one intra-op thread each, file-store rendezvous;
``tests/torch_mesh_worker.py``) against one process, and against the JAX
package's ``Trainer(mesh=make_mesh(2))`` on the same seeded numpy batches.

Tolerances: two ranks against one differ only in the order of the batch
reductions (a mean of the ranks' means, the gradients summed over ranks).
Losses are held to 1e-5 relative; parameters after 4 Adam steps of lr
1e-4 to 4e-4 absolute (4·lr: Adam moves a parameter whose gradient is near
0 by up to lr on an ulp-level change of it). Against JAX the limits of
``tests/test_train.py::test_full_fit_sharded_equals_single_device``.
Both ranks hold the same parameters bit for bit, and a run resumed on two
ranks from ``epoch_0`` ends bit for bit where the uninterrupted one does.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from mm_masking_tpu.config import (
    Config as JConfig,
    LossWeights as JLossWeights,
    ModelConfig as JModelConfig,
    TrainConfig as JTrainConfig,
)
from mm_masking_tpu.data.synthetic import SyntheticSpec as JSpec, synthetic_batch as jbatch
from mm_masking_tpu.localization import pipeline as jpipe
from mm_masking_tpu.models.policy import LearnICPWeightPolicy as JPolicy
from mm_masking_tpu.parallel import make_mesh as jmake_mesh
from mm_masking_tpu.train.metrics import MetricsLogger as JMetricsLogger
from mm_masking_tpu.train.trainer import Trainer as JTrainer
from mm_masking_tpu_torch.config import Config, LossWeights, ModelConfig, TrainConfig
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.localization import pipeline
from mm_masking_tpu_torch.models import LearnICPWeightPolicy, params_from_flax
from mm_masking_tpu_torch.parallel import Mesh, make_mesh, shard_axis, shard_batch
from mm_masking_tpu_torch.parallel.mesh import ShardedBatch
from mm_masking_tpu_torch.train import Trainer, eval_training_loss

SPEC = dict(n_scan=128, n_map=512, polar_shape=(64, 256), cart_pixel_width=64, res=0.25,
            cart_resolution=0.5, max_range=15.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
MODEL = dict(enc_channels=(4, 8), dropout=0.0, cart_pixel_width=64, cart_resolution=0.5,
             res=0.25, polar_shape=(64, 256), max_iter=3, inference_max_iter=8)
# Every loss term, the point-count hinge included.
LOSS = dict(icp_rot=1.0, icp_trans=1.0, mask_pts=1.0, fft=0.5, cfar=0.5, num_pts=0.01,
            num_pts_floor=0.9)
LR = 1e-4


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def config(directory, loss=LOSS, **model) -> Config:
    return Config(model=ModelConfig(**{**MODEL, **model}), loss=LossWeights(**loss),
                  train=TrainConfig(batch_size_train=4, batch_size_test=4, num_epochs=2,
                                    learning_rate=LR, checkpoint_dir=str(directory)))


def epochs(path) -> list[dict]:
    return [r for r in map(json.loads, open(path)) if r["event"] == "epoch"]


@pytest.fixture(scope="module")
def data():
    train = [jbatch(i, 4, JSpec(**SPEC)) for i in range(2)]
    val = [jbatch(100, 4, JSpec(**SPEC))]
    return train, val


@pytest.fixture(scope="module")
def jax_fit(data, tmp_path_factory):
    """JAX's fit on a 2-device mesh, dropout off, and its initial parameters."""
    d = tmp_path_factory.mktemp("jax_m2")
    jcfg = JConfig(model=JModelConfig(**MODEL), loss=JLossWeights(**LOSS),
                   train=JTrainConfig(batch_size_train=4, batch_size_test=4, num_epochs=2,
                                      learning_rate=LR, checkpoint_dir=str(d)))
    jtr = JTrainer(jcfg, mesh=jmake_mesh(2), logger=JMetricsLogger(str(d)))
    init = jtr.init_state()
    init_params = params_from_flax(init.variables["params"])
    state = jtr.fit(lambda epoch: data[0], lambda: data[1], state=init, num_epochs=2)
    return init_params, params_from_flax(state.variables["params"]), epochs(jtr.logger.path)


@pytest.fixture(scope="module")
def scene():
    spec = SyntheticSpec(n_scan=128, n_map=512, polar_shape=(64, 512), cart_pixel_width=64,
                         res=15.0 / 512, cart_resolution=0.5, max_range=14.0, min_range=2.0,
                         pos_std=0.3, rot_std=0.1, network_input_type="polar")
    b = jax.tree_util.tree_map(lambda x: x.numpy(), synthetic_batch(0, batch=6, spec=spec))
    cfg = dict(detector="modified_cacfar",
               detector_kwargs=(("width", 21), ("guard", 2), ("maxr", 15.0)),
               radar_resolution=spec.res, max_points=256, beta=0.0, icp_type="pt2pl")
    model = dict(enc_channels=(4, 8), res=spec.res, polar_shape=spec.polar_shape,
                 cart_pixel_width=64, cart_resolution=0.5, dropout=0.0)
    return b, cfg, model


def hinge_inputs():
    """A batch of 4 and an override mask whose hinge is active on rank 1's
    rows alone: 1.0 on rank 0's (each point counts ~1), 0.1 on rank 1's
    (~0.73), one pixel 1.0 per image so that the max normalisation keeps it."""
    batch = to_torch(jbatch(7, 4, JSpec(**SPEC)))
    mask = torch.full((4, 64, 64), 0.1)
    mask[:2] = 1.0
    mask[:, 0, 0] = 1.0
    loss = dict(icp_rot=0.0, icp_trans=0.0, mask_pts=0.0, num_pts=1.0, num_pts_floor=0.9)
    return batch, mask, loss


@pytest.fixture(scope="module")
def runs(data, jax_fit, scene, tmp_path_factory):
    """Every two-rank job, run in one spawn of the group."""
    root = tmp_path_factory.mktemp("mesh")
    train, val = (to_torch(data[0]), to_torch(data[1]))
    b, loc_cfg, loc_model = scene
    policy = LearnICPWeightPolicy(Config(model=ModelConfig(**loc_model)), "cpu")
    loc_params = policy.init(torch.Generator().manual_seed(0))
    frames = {"fft": b["loc_data"]["fft_data"][:3], "azimuths": b["loc_data"]["azimuths"][:3],
              "az_times": b["loc_data"]["az_times"][:3]}
    mask_fft, mask_cfar = minmax_inputs()
    hb, hmask, hloss = hinge_inputs()
    jobs = [
        ("fit_dropout", ("fit", dict(cfg=config(root / "a2", dropout=0.05), train=train,
                                      val=val, resume=True))),
        ("fit_jax", ("fit", dict(cfg=config(root / "b2"), train=train, val=val,
                                  init_params=jax_fit[0]))),
        ("replicated", ("step", dict(cfg=config(root / "r2", dropout=0.05),
                                     batch=to_torch(jbatch(3, 3, JSpec(**SPEC)))))),
        ("hinge", ("hinge", dict(cfg=config(root / "h2", loss=hloss),
                                 params=policy_params(), batch=hb, mask=hmask))),
        ("localize", ("localize", dict(cfg_loc=pipeline.LocalizationConfig(**loc_cfg),
                                       frames=frames,
                                       map_pc=torch.from_numpy(b["map_data"]["pc"][:1]),
                                       T0=torch.from_numpy(b["transforms"]["T_ml_init"][:3]),
                                       batch_size=2,
                                       policy_cfg=Config(model=ModelConfig(**loc_model)),
                                       params=loc_params))),
        ("bn_step", ("step", dict(cfg=config(root / "n2", batch_norm=True, dropout=0.05),
                                  batch=train[0], steps=2))),
        ("sweep", ("sweep", dict(cfg=config(root / "s2"),
                                 sequences={k: f() for k, f in sweep_sequences().items()}))),
    ] + [(f"mask_{norm}", ("mask", dict(cfg=config(root, normalize=norm, cfar_input=True),
                                        params=policy_params(cfar=True), fft=mask_fft,
                                        cfar=mask_cfar)))
         for norm in ("minmax", "standardize")]
    return worker.spawn(jobs, str(root / "out"))


def policy_params(cfar=False):
    policy = LearnICPWeightPolicy(config("unused", cfar_input=cfar), "cpu")
    return policy.init(torch.Generator().manual_seed(3))


def minmax_inputs():
    """A batch of 4 whose largest and smallest pixels lie on rank 1's rows."""
    rng = np.random.default_rng(5)
    fft = rng.random((4, 64, 64), np.float32) * 0.5 + 0.2
    fft[3, 10, 20], fft[2, 5, 5] = 3.0, 1e-3
    cfar = (rng.random((4, 64, 64)) > 0.7).astype(np.float32)
    return torch.from_numpy(fft), torch.from_numpy(cfar)


def assert_ranks_equal(results):
    a, b = results
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_two_rank_fit_equals_one_rank_fit(runs, data, tmp_path):
    """Dropout 0.05: each rank draws the global batch's masks and keeps its
    rows, so the two ranks take the one-process steps."""
    r = runs["fit_dropout"]
    assert_ranks_equal(r)
    tr = Trainer(config(tmp_path, dropout=0.05), "cpu")
    state = tr.fit(lambda epoch: to_torch(data[0]), lambda: to_torch(data[1]), num_epochs=2)
    one = epochs(tr.logger.path)
    # One log, of rank 0's records alone.
    assert len(one) == len(r[0]["records"]) == 2
    for got, want in zip(r[0]["records"], one):
        for key in ("loss", "rot", "trans", "fft", "mask_pts", "cfar", "num_pts", "grad_norm",
                    "acc", "mean_num_pc", "mean_w", "max_w", "min_w", "val_ones_baseline",
                    "train_ones_baseline"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-7, err_msg=key)
    for k, v in state.params.items():
        np.testing.assert_allclose(r[0]["params"][k].numpy(), v.detach().numpy(), rtol=0,
                                   atol=4 * LR, err_msg=k)


def test_two_rank_fit_matches_jax_two_device_fit(runs, jax_fit):
    _, jparams, jrecs = jax_fit
    r = runs["fit_jax"]
    assert_ranks_equal(r)
    assert len(r[0]["records"]) == len(jrecs) == 2
    for a, b in zip(r[0]["records"], jrecs):
        assert abs(a["loss"] - b["loss"]) < 1e-3 * max(1.0, abs(b["loss"]))
        assert abs(a["acc"] - b["acc"]) < 2e-3
    for k, v in jparams.items():
        np.testing.assert_allclose(r[0]["params"][k].numpy(), v.numpy(), atol=5e-3, rtol=1e-3,
                                   err_msg=k)


def test_two_rank_resume_from_epoch_0_is_exact(runs):
    for rank in runs["fit_dropout"]:
        assert rank["resumed_epoch"] == 1
        for k, v in rank["params"].items():
            assert torch.equal(rank["resumed"][k], v), k


@pytest.mark.parametrize("norm", ["minmax", "standardize"])
def test_normalisation_statistics_span_the_mesh(runs, norm):
    """The batch's largest and smallest pixels lie on rank 1's rows: rank 0's
    rows normalise by them too."""
    fft, cfar = minmax_inputs()
    policy = LearnICPWeightPolicy(config("unused", normalize=norm, cfar_input=True), "cpu")
    with torch.no_grad():
        want = policy.compute_mask(policy_params(cfar=True), fft, cfar)
    for got in runs[f"mask_{norm}"]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    if norm == "minmax":  # rank 0 alone would normalise by other statistics
        with torch.no_grad():
            alone = policy.compute_mask(policy_params(cfar=True), fft[:2], cfar[:2])
        assert (alone - want[:2]).abs().max() > 1e-3


def test_point_count_hinge_is_applied_to_the_global_means(runs):
    """Rank 1's rows alone are under the floor. The global hinge is active
    with a gradient on every row; a per-rank hinge would average rank 1's
    larger value with rank 0's zero and leave rank 0's rows no gradient."""
    batch, mask, loss = hinge_inputs()
    cfg = config("unused", loss=loss)
    policy = LearnICPWeightPolicy(cfg, "cpu")
    params = policy_params()

    def hinge(rows):
        own = mask[rows].clone().requires_grad_(True)
        sub = jax.tree_util.tree_map(lambda x: x[rows], batch)
        out = policy.apply(params, sub["loc_data"], sub["map_data"],
                           sub["transforms"]["T_ml_init"], train=True, override_mask=own)
        value, _ = eval_training_loss(out.T_pred, out.weight_mask, out.diff_mean_num_non0,
                                      out.mean_all_pts, sub["transforms"]["T_ml_gt"],
                                      sub["loc_data"], sub["map_data"], cfg.loss,
                                      cart_pixel_width=64, cart_resolution=0.5)
        return value, torch.autograd.grad(value, own)[0]

    want, want_grad = hinge(slice(0, 4))
    per_rank = [hinge(slice(0, 2))[0], hinge(slice(2, 4))[0]]
    assert per_rank[0] == 0.0 and per_rank[1] > 0.0
    assert abs(0.5 * (per_rank[0] + per_rank[1]) - want) > 0.1 * want
    assert (want_grad[:2].abs().sum() > 0) and want > 0
    for got in runs["hinge"]:
        # floor·mean_all_pts − diff_num_non0 cancels two means of ~100 points:
        # float32 rounding of those, 1e-6 of the 128 points a scan holds.
        np.testing.assert_allclose(got["loss"].item(), want.item(), rtol=0, atol=128e-6)
        np.testing.assert_allclose(got["grad"].numpy(), want_grad.numpy(), rtol=1e-6,
                                   atol=1e-12)


def test_a_batch_that_does_not_divide_the_mesh_is_replicated(runs):
    fake = Mesh(group=object(), rank=1, size=2, device=torch.device("cpu"))
    odd = {"a": torch.arange(3), "b": {"c": torch.zeros(3, 2)}}
    assert shard_batch(odd, fake) is odd
    even = shard_batch({"a": torch.arange(4), "b": {"c": torch.zeros(4, 2)}}, fake)
    assert isinstance(even, ShardedBatch) and (even.start, even.total) == (2, 4)
    assert even["a"].tolist() == [2, 3] and even["b"]["c"].shape == (2, 2)
    assert shard_batch(even, fake) is even
    assert shard_axis(torch.zeros(5, 4), fake, 1).shape == (5, 2)
    assert shard_axis(torch.zeros(5, 3), fake, 1).shape == (5, 3)

    batch = to_torch(jbatch(3, 3, JSpec(**SPEC)))
    tr = Trainer(config("unused", dropout=0.05), "cpu")
    state = tr.init_state(0)
    _, loss, comp, gn = tr.train_step(state, batch)
    for rank in runs["replicated"]:
        (got,) = rank
        np.testing.assert_allclose(got["loss"].item(), loss.item(), rtol=1e-6)
        np.testing.assert_allclose(got["grad_norm"].item(), gn.item(), rtol=1e-6)
        for k, v in state.params.items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.detach().numpy(), rtol=0,
                                       atol=1e-7, err_msg=k)


def test_localize_sequence_over_the_mesh_matches_one_process_and_jax(runs, scene):
    """Three frames in chunks of 2 (the last padded) with the mask in the
    loop, each rank localizing one frame of a chunk; then the chunks'
    clouds."""
    b, loc_cfg, loc_model = scene
    frames = {"fft": b["loc_data"]["fft_data"][:3], "azimuths": b["loc_data"]["azimuths"][:3],
              "az_times": b["loc_data"]["az_times"][:3]}
    T0 = b["transforms"]["T_ml_init"][:3]
    map_pc = b["map_data"]["pc"][:1]
    cfg = pipeline.LocalizationConfig(**loc_cfg)
    policy = LearnICPWeightPolicy(Config(model=ModelConfig(**loc_model)), "cpu")
    params = policy.init(torch.Generator().manual_seed(0))
    one = pipeline.localize_sequence(frames, torch.from_numpy(map_pc), cfg, T_inits=T0,
                                     batch_size=2, weight_policy=policy,
                                     policy_variables=params)
    for rank in runs["localize"]:
        for key in ("T", "weights", "matched_ratio", "ok", "points"):
            np.testing.assert_allclose(rank["seq"][key].numpy(), one[key].numpy(), rtol=0,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_array_equal(rank["seq"]["ok"].numpy(), one["ok"].numpy())
    clouds = pipeline.localize_cloud_sequence(one["points"], torch.from_numpy(map_pc), cfg,
                                              T_inits=T0, batch_size=2)
    for rank in runs["localize"]:
        np.testing.assert_allclose(rank["clouds"]["T"].numpy(), clouds["T"].numpy(), rtol=0,
                                   atol=1e-6)

    from test_torch_localization import flax_variables, hold

    jpolicy = JPolicy(JConfig(model=JModelConfig(**loc_model)))
    want = jpipe.localize_sequence(frames, jnp.asarray(map_pc),
                                   jpipe.LocalizationConfig(**loc_cfg), T_inits=jnp.asarray(T0),
                                   batch_size=2, mesh=jmake_mesh(2), weight_policy=jpolicy,
                                   policy_variables=flax_variables(params))
    got = runs["localize"][0]["seq"]
    np.testing.assert_allclose(got["weights"].numpy(), np.asarray(want["weights"]), rtol=0,
                               atol=1e-5)
    hold(got, want, fixed_point=(torch.from_numpy(map_pc).expand(3, -1, -1), cfg))


def test_batch_norm_two_rank_steps_equal_one_rank_steps(runs, data):
    """Batch norm in training over the mesh: the statistics are the global
    batch's in the forward and their cotangents summed in the backward, the
    running statistics updated with them; two steps with dropout."""
    tr = Trainer(config("unused", batch_norm=True, dropout=0.05), "cpu")
    state = tr.init_state(0)
    batch = to_torch(data[0][0])
    for step, (a, b) in enumerate(zip(*runs["bn_step"])):
        _, loss, comp, gn = tr.train_step(state, batch)
        for got in (a, b):
            np.testing.assert_allclose(got["loss"].item(), loss.item(), rtol=1e-5)
            np.testing.assert_allclose(got["comp"].numpy(), torch.stack(comp).numpy(),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(got["grad_norm"].item(), gn.item(), rtol=1e-4)
            for k, v in state.params.items():
                tol = 1e-5 if "running" in k else (step + 1) * LR
                np.testing.assert_allclose(got["params"][k].numpy(), v.detach().numpy(),
                                           rtol=0, atol=tol, err_msg=k)
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), k


def test_loader_keeps_each_ranks_rows_of_the_global_batches():
    """Every rank collates the one-device batches (the same items and
    augmentation draws) and keeps its rows; a remainder that does not divide
    the mesh comes whole."""
    from mm_masking_tpu_torch.data import epoch_batches

    class Items:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            rng = np.random.default_rng(i)
            return {"loc_data": {"fft_data": rng.random((8, 16), np.float32),
                                 "fft_cfar": np.zeros((8, 16), np.float32),
                                 "azimuths": np.zeros(8, np.float32)},
                    "index": np.int64(i)}

    cfg = config("unused", network_input_type="polar")
    kw = dict(shuffle=True, drop_last=False, seed=3, prefetch=0, device="cpu")
    whole = list(epoch_batches(Items(), 4, cfg, **kw))
    for rank in (0, 1):
        fake = Mesh(group=object(), rank=rank, size=2, device=torch.device("cpu"))
        got = list(epoch_batches(Items(), 4, cfg, mesh=fake, **kw))
        assert len(got) == len(whole) == 2
        assert isinstance(got[0], ShardedBatch) and got[0].total == 4
        rows = slice(2 * rank, 2 * rank + 2)
        assert torch.equal(got[0]["index"], whole[0]["index"][rows])
        assert torch.equal(got[0]["loc_data"]["fft_data"], whole[0]["loc_data"]["fft_data"][rows])
        assert not isinstance(got[1], ShardedBatch)  # 3 rows: replicated
        assert torch.equal(got[1]["index"], whole[1]["index"])


def test_sharded_sweep_gathers_every_frame(runs):
    """``evaluate_policy_on_sequences`` through a trainer with the mesh:
    each rank localizes its rows of each batch and returns the whole
    sequence's errors, those of one process."""
    from mm_masking_tpu_torch.evaluation import evaluate_policy_on_sequences

    tr = Trainer(config("unused"), "cpu")
    state = tr.init_state(0)
    want = evaluate_policy_on_sequences(tr, state, sweep_sequences())
    for got in runs["sweep"]:
        assert got.keys() == want.keys()
        for name in want:
            a, b = got[name].as_dict(), want[name].as_dict()
            assert a["n_frames"] == b["n_frames"] == 6
            for key in a:
                np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-7, err_msg=key)


def sweep_sequences():
    """A sequence of a batch of 4 and a last one of 2, each sharded."""
    return {"a": lambda: [to_torch(jbatch(20, 4, JSpec(**SPEC))),
                          to_torch(jbatch(21, 2, JSpec(**SPEC)))]}


def test_make_mesh_without_a_group_is_trivial():
    mesh = make_mesh()
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    x = torch.arange(3.0)
    assert mesh.sum(x) is x and mesh.gather(x) is x and mesh.max(x) is x
    assert shard_batch({"a": x}, mesh) == {"a": x}
    with pytest.raises(ValueError, match="process group"):
        make_mesh(2)
