"""JAX checkpoints into the port (``scripts/convert_jax_checkpoint.py``) on the
CPU: a tiny JAX ``Trainer`` run saves orbax checkpoints after one step; the
converted ``.pt`` gives the port JAX's mask (within the policy tests' 1e-5)
and Adam state, ``localize --checkpoint`` runs on it, one resumed step
equals JAX's resumed step, and the port's loader names the script when it
finds an orbax directory where it looks for a ``.pt``."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from mm_masking_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from mm_masking_tpu.config import LossWeights as JLossWeights, TrainConfig as JTrainConfig
from mm_masking_tpu.data.synthetic import SyntheticSpec as JSpec, synthetic_batch as jbatch
from mm_masking_tpu.parallel import make_mesh
from mm_masking_tpu.train.checkpoint import restore_checkpoint, save_checkpoint
from mm_masking_tpu.train.metrics import MetricsLogger as JMetricsLogger
from mm_masking_tpu.train.trainer import Trainer as JTrainer
from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.evaluation.gt_tools import read_traj_file
from mm_masking_tpu_torch.geom import se3_inv
from mm_masking_tpu_torch.localization import __main__ as cli
from mm_masking_tpu_torch.localization import pipeline
from mm_masking_tpu_torch.models import LearnICPWeightPolicy, params_from_flax
from mm_masking_tpu_torch.train import Trainer
from mm_masking_tpu_torch.train.checkpoint import load_checkpoint, load_policy_variables

from test_torch_cli_localization import planar_T, write_raw_scans
from test_torch_e2e_product import one_thread  # noqa: F401

RES = 15.0 / 512
MODEL = dict(enc_channels=(4, 8), dropout=0.0, res=RES, polar_shape=(64, 512),
             cart_pixel_width=64, cart_resolution=0.5, max_iter=3, inference_max_iter=8)
SPEC = dict(n_scan=128, n_map=512, polar_shape=(64, 512), cart_pixel_width=64, res=RES,
            cart_resolution=0.5, max_range=14.0, min_range=2.0, pos_std=0.4, rot_std=0.15)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def ring_and_walls() -> np.ndarray:
    """The localization CLI tests' world: a ring and two walls."""
    rng = np.random.default_rng(21)
    pts = np.zeros((800, 3), np.float32)
    r, a = rng.uniform(4, 12, 400), rng.uniform(0, 2 * np.pi, 400)
    pts[:400, 0], pts[:400, 1] = r * np.cos(a), r * np.sin(a)
    t = rng.uniform(-8, 8, 400)
    pts[400:, 0], pts[400:, 1] = t, np.where(t > 0, 6.0, -7.0)
    return pts


def load_script():
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", "convert_jax_checkpoint.py")
    spec = importlib.util.spec_from_file_location("convert_jax_checkpoint", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX run directory after one Adam step (clip 10): ``config.json``,
    orbax ``best_policy`` and ``epoch_0``, each converted into ``conv/``.
    Returns (run dir, conv dir, the JAX trainer, its state, the batch). The
    loss has the ICP terms only: after a step the mask-points BCE is
    ill-conditioned at the mask's max (ROADMAP §3 open fault 2), and the two
    packages' grad_norms then part by 10% while their losses agree to 1e-5,
    as ``tests/test_torch_train.py::test_dataset_fed_train_step_matches_jax``
    records."""
    run = tmp_path_factory.mktemp("jax_run")
    cfg = JConfig(model=JModelConfig(**MODEL), loss=JLossWeights(mask_pts=0.0),
                  train=JTrainConfig(batch_size_train=4, clip_value=10.0,
                                     checkpoint_dir=str(run)))
    jtr = JTrainer(cfg, mesh=make_mesh(1), logger=JMetricsLogger(str(run / "log")))
    batch = jbatch(0, 4, JSpec(**SPEC))
    state, *_ = jtr._train_step(jtr.init_state(), batch, mask_losses_active=True)
    state = state._replace(epoch=jax.numpy.asarray(1, jax.numpy.int32))
    for name in ("best_policy", "epoch_0"):
        save_checkpoint(str(run), name, state)
    with open(run / "config.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)
    script = load_script()
    conv = run / "conv"
    for name in ("best_policy", "epoch_0"):
        script.main([str(run), "--name", name, "--out", str(conv)])
    return run, conv, jtr, state, batch


@pytest.mark.parametrize("name", ["best_policy", "epoch_0"])
def test_converted_checkpoint_gives_the_jax_mask(jax_run, name):
    run, conv, jtr, state, batch = jax_run
    assert os.path.isfile(conv / f"{name}.pt") and os.path.isfile(conv / "config.json")
    with open(conv / "config.json") as f:
        cfg = Config.from_dict(json.load(f))
    params = load_policy_variables(str(conv), name)
    want = params_from_flax(state.variables["params"])
    assert set(params) == set(want)
    for k, v in want.items():
        assert torch.equal(params[k], v), k
    loc = batch["loc_data"]
    jmask = np.asarray(jtr.policy.compute_mask(state.variables, loc["fft_data"],
                                               loc["fft_cfar"], train=False)[0])
    with torch.no_grad():
        mask = LearnICPWeightPolicy(cfg, "cpu").compute_mask(
            params, torch.from_numpy(np.array(loc["fft_data"])),
            torch.from_numpy(np.array(loc["fft_cfar"])))
    np.testing.assert_allclose(mask.numpy(), jmask, rtol=0, atol=1e-5)


def test_localize_runs_on_a_converted_checkpoint(jax_run, tmp_path):
    """``localize --checkpoint`` on the converted run: the trajectory of the
    library call with the JAX run's mask."""
    _, conv, *_ = jax_run
    world = ring_and_walls()
    stamps = [3_000_000 + 100_000 * i for i in range(3)]
    raw = tmp_path / "raw"
    write_raw_scans(raw, world, [planar_T(0.2 * i, 0.04 * i, 0.02 * i) for i in range(3)],
                    stamps)
    np.savez_compressed(tmp_path / "map.npz", map_pc=world)
    assert cli.main(["localize", "--scans", str(raw), "--map", str(tmp_path / "map.npz"),
                     "--checkpoint", str(conv), "--max-points", "256", "--batch-size", "2",
                     "--icp-type", "pt2pt", "--normal-threshold", "1.0", "--det", "width=21",
                     "--det", "guard=2", "--det", "maxr=15.0", "--init-chain",
                     "--out-traj", str(tmp_path / "chain.txt"), "--device", "cpu"]) == 0
    with open(conv / "config.json") as f:
        policy = LearnICPWeightPolicy(Config.from_dict(json.load(f)), "cpu")
    frames = cli._load_radar_frames([str(raw / f"{s}.npy") for s in stamps])
    loc_cfg = pipeline.LocalizationConfig(
        detector_kwargs=(("width", 21), ("guard", 2), ("maxr", 15.0)), max_points=256,
        icp_type="pt2pt", normal_threshold=1.0)
    want = pipeline.localize_sequence_tracked(
        frames, torch.from_numpy(np.concatenate([world, np.zeros_like(world)], -1)), loc_cfg,
        weight_policy=policy, policy_variables=load_policy_variables(str(conv)))
    rows, times = read_traj_file(str(tmp_path / "chain.txt"))
    assert times == stamps and torch.isfinite(want["T"]).all()
    np.testing.assert_allclose(np.stack(rows)[:, :3], se3_inv(want["T"]).numpy()[:, :3],
                               rtol=0, atol=1e-6)


def test_missing_pt_names_the_conversion_script(jax_run):
    run, *_ = jax_run
    with pytest.raises(FileNotFoundError, match="scripts/convert_jax_checkpoint.py"):
        load_policy_variables(str(run))
    with pytest.raises(FileNotFoundError, match="epoch_0"):
        load_checkpoint(str(run), "epoch_0")


def test_resumed_step_matches_jax(jax_run):
    """Adam's moments and count carried one to one; one step resumed from
    epoch_0 in each package, dropout off: loss within 1e-5, grad_norm within
    1e-3 and the parameters within 1e-6 (the train tests' limits)."""
    run, conv, jtr, state, batch = jax_run
    with open(conv / "config.json") as f:
        cfg = Config.from_dict(json.load(f))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             checkpoint_dir=str(conv)))
    trainer = Trainer(cfg, "cpu")
    resumed = trainer.resume()
    adam = state.opt_state.inner_state[1][0]
    assert (resumed.step, resumed.epoch, int(resumed.opt.count)) == (1, 1, int(adam.count))
    for moments, tree in zip(resumed.opt.moments, (adam.mu, adam.nu)):
        want = params_from_flax(tree)
        for i, name in enumerate(trainer._trained):
            assert torch.equal(moments[i], want[name]), name

    jstate = restore_checkpoint(str(run), "epoch_0", jtr.init_state())
    jnew, jl, _, jgn = jtr._train_step(jstate, batch, mask_losses_active=True)
    _, loss, _, gn = trainer.train_step(resumed, to_torch(batch))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(gn.item(), float(jgn), rtol=1e-3)
    for k, want in params_from_flax(jnew.variables["params"]).items():
        np.testing.assert_allclose(resumed.params[k].detach().numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert int(resumed.opt.count) == int(adam.count) + 1
