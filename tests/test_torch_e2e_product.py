"""The port's product recipe (``mm_masking_tpu_torch.benchmarks.e2e_product``)
against the JAX package's ``benchmarks/e2e_product.py`` on the CPU.

The synthesized tree equals the JAX script's byte for byte (every CSV,
calibration file, lidar ``.bin`` and radar ``.npy``), and the full-scale
world equals JAX's exactly. The tiny recipe, run once for the module with
``--device cpu``, prints the JAX summary's 16 keys, all finite, and its
``run_metrics.jsonl`` holds the events of the JAX run's record
(``results/checkpoints/e2e_product_r5``) in their order, each with the same
keys. ``--datagen-only`` and ``--baselines-only`` print the JAX script's
keys; with ``--warmup-epochs`` the init baseline is a fresh state's. The
baselines the gate rests on (``Trainer.generate_baseline`` with
``mask_kind`` ones, cfar and auto) match JAX's on the same batches within
the ICP tests' limits (poses 1e-4 m).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from mm_masking_tpu.config import Config as JConfig
from mm_masking_tpu.parallel import make_mesh
from mm_masking_tpu.train.metrics import MetricsLogger as JMetricsLogger
from mm_masking_tpu.train.trainer import Trainer as JTrainer
from mm_masking_tpu_torch.benchmarks import e2e_product as e2e
from mm_masking_tpu_torch.data import ICPWeightDataset, epoch_batches
from mm_masking_tpu_torch.models import params_from_flax
from mm_masking_tpu_torch.train import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny runs take one intra-op thread: with eight threads in each of
    the test runner's six worker processes, the cores are oversubscribed and
    the recipe's thousands of tiny ops run several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_jax_script(name: str):
    """A JAX ``benchmarks/`` script as a module, with the persistent compile
    cache it turns on at import turned off again."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "benchmarks" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    for k, v in before.items():
        jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def jax_e2e():
    return load_jax_script("e2e_product")


def read_json(path, lines: bool = False):
    """A JSON file's object, or with ``lines`` a JSONL file's records."""
    with open(path) as f:
        return [json.loads(line) for line in f] if lines else json.load(f)


@contextlib.contextmanager
def cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def run_recipe(capsys, workdir, *flags) -> dict:
    """``main`` on the tiny scale in ``workdir``: the JSON line it printed."""
    capsys.readouterr()
    with cwd(workdir):
        e2e.main(["--scale", "tiny", "--root", str(workdir / "tree"), *flags] + CPU)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The tiny recipe, run once: (summary, its workdir)."""
    workdir = tmp_path_factory.mktemp("recipe")
    with cwd(workdir), open(workdir / "out.txt", "w") as out, contextlib.redirect_stdout(out):
        summary, _ = e2e.main(["--scale", "tiny", "--root", str(workdir / "tree")] + CPU)
    return summary, workdir


# ------------------------------------------------------------------- the tree
@pytest.fixture(scope="module")
def trees(tmp_path_factory, jax_e2e):
    """The port's and the JAX script's tiny trees with two training
    sequences: {relative path: (port bytes, JAX bytes)}."""
    base = tmp_path_factory.mktemp("trees")
    rows = {}
    for name, mod in (("port", e2e), ("jax", jax_e2e)):
        rows[name] = mod.synthesize_tree(str(base / name), mod.TINY, train_seqs=2)
    assert rows["port"] == rows["jax"]
    files = {}
    for name in ("port", "jax"):
        root = base / name
        files[name] = {str(p.relative_to(root)): p.read_bytes()
                       for p in root.rglob("*") if p.is_file()}
    assert sorted(files["port"]) == sorted(files["jax"])
    return {k: (files["port"][k], files["jax"][k]) for k in files["port"]}


@pytest.mark.parametrize("kind", ["_poses.csv", "calib/", ".bin", ".npy"])
def test_synthesized_tree_equals_jax_byte_for_byte(trees, kind):
    names = [k for k in trees if kind in k]
    assert names, kind
    for k in names:
        port, jax_bytes = trees[k]
        assert port == jax_bytes, k
    if kind == ".npy":  # the teach pass, 2 training and 1 validation sequences
        assert len(names) == 2 * e2e.TINY.n_train + e2e.TINY.n_val


def test_full_scale_world_equals_jax(jax_e2e):
    world, segs = e2e.build_world(np.random.default_rng(7), e2e.Scale())
    jworld, jsegs = jax_e2e.build_world(np.random.default_rng(7), jax_e2e.Scale())
    assert world.dtype == jworld.dtype and world.shape == jworld.shape
    assert np.array_equal(world, jworld)
    assert segs == jsegs
    assert dataclasses.asdict(e2e.Scale()) == dataclasses.asdict(jax_e2e.Scale())
    assert dataclasses.asdict(e2e.TINY) == dataclasses.asdict(jax_e2e.TINY)
    assert dataclasses.asdict(e2e.MID) == dataclasses.asdict(jax_e2e.MID)


# ----------------------------------------------------------------- the recipe
def test_tiny_recipe_prints_the_jax_summary(recipe):
    summary, _ = recipe
    assert tuple(summary) == e2e.SUMMARY_KEYS and len(summary) == 16
    numbers = [v for v in summary.values() if not isinstance(v, str)]
    assert all(math.isfinite(v) for v in numbers), summary
    assert summary["epochs"] == 2 and summary["scale"] == "tiny"
    assert (summary["train_samples"], summary["val_samples"], summary["train_pairs"]) == (
        e2e.TINY.n_train, e2e.TINY.n_val, 1)
    assert summary["notfinite_count"] == 0


def test_run_metrics_hold_the_jax_events_in_order(recipe):
    _, workdir = recipe
    ckpt = workdir / "results" / "checkpoints" / "e2e_product"
    got = read_json(ckpt / "run_metrics.jsonl", lines=True)
    want = read_json(REPO / "results" / "checkpoints" / "e2e_product_r5" / "run_metrics.jsonl",
                     lines=True)

    def shape(recs):
        """The event sequence with runs of "epoch" collapsed."""
        out = []
        for r in recs:
            if not (out and r["event"] == "epoch" == out[-1]):
                out.append(r["event"])
        return out

    assert shape(got) == shape(want) == ["baseline", "pretrain_val", "epoch", "final_val",
                                         "baseline_cfar"]
    assert sum(r["event"] == "epoch" for r in got) == 2
    keys = {r["event"]: set(r) for r in want}
    # The port's epoch record adds the seconds the step waited on the loader.
    keys["epoch"] |= {"loader_wait_s"}
    for r in got:
        assert set(r) == keys[r["event"]], r["event"]
    assert {"best_policy.pt", "epoch_0.pt", "epoch_1.pt", "config.json"} <= set(
        os.listdir(ckpt))


def test_mode_flags_print_the_jax_keys(recipe, capsys):
    _, workdir = recipe
    out = run_recipe(capsys, workdir, "--datagen-only")
    assert set(out) == {"status", "root"} and out["status"] == "datagen_done"
    assert out["root"] == str(workdir / "tree") + "_tiny"
    out = run_recipe(capsys, workdir, "--baselines-only")
    assert set(out) == {"status", "val_init", "val_ones", "val_cfar"}
    assert all(math.isfinite(out[k]) for k in ("val_init", "val_ones", "val_cfar"))


def test_warmup_takes_the_init_baseline_from_a_fresh_state(recipe, capsys):
    summary, workdir = recipe
    out = run_recipe(capsys, workdir, "--warmup-epochs", "1", "--run-name", "warm")
    assert out["val_init_baseline"] == summary["val_init_baseline"]
    assert out["val_init_from"] == "fresh_init_state"
    assert set(out) == set(e2e.SUMMARY_KEYS) | {"val_init_from"}
    assert "val_init_from" not in summary


# ------------------------------------------------------------- the baselines
@pytest.fixture(scope="module")
def baseline_inputs(recipe):
    """The recipe's config, its validation batches (preprocessed by the
    port's loader), and a JAX Trainer with the same config."""
    _, workdir = recipe
    args = e2e.build_parser().parse_args(["--scale", "tiny"])
    root = str(workdir / "tree") + "_tiny"
    cfg = e2e.make_config(args, e2e.TINY, root, ((e2e.MAP_SEQ, e2e.TRAIN_SEQ),))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=str(workdir / "baselines")))
    val_ds = ICPWeightDataset(list(cfg.val_loc_pairs), cfg, "test")
    batches = list(epoch_batches(val_ds, cfg.train.batch_size_test, cfg, shuffle=False,
                                 drop_last=False, device="cpu"))
    jcfg = JConfig.from_dict(dataclasses.asdict(cfg))
    jtr = JTrainer(jcfg, mesh=make_mesh(1), logger=JMetricsLogger(str(workdir / "jbase")))
    return cfg, batches, jtr


@pytest.mark.parametrize("mask_kind", ["ones", "cfar", "auto"])
def test_generate_baseline_matches_jax(baseline_inputs, mask_kind):
    cfg, batches, jtr = baseline_inputs
    trainer = Trainer(cfg, "cpu")
    init, base = trainer.generate_baseline(trainer.init_state(), batches, baseline_type="val",
                                           mask_kind=mask_kind)
    jbatches = [jax.tree_util.tree_map(lambda t: t.numpy(), b) for b in batches]
    jinit, jbase = jtr.generate_baseline(jtr.init_state(), jbatches, baseline_type="val",
                                         mask_kind=mask_kind)
    assert math.isfinite(base) and base > 0
    np.testing.assert_allclose(init, float(jinit), rtol=1e-6)
    np.testing.assert_allclose(base, float(jbase), rtol=0, atol=1e-4)


def test_bf16_recipe_mask_ties_at_its_max_in_both_packages(baseline_inputs):
    """ROADMAP §3 faults 1 and 4 on the recipe's own data. In the JAX
    package on the CPU the bfloat16 head's sigmoid takes a handful of values
    near its max, so pixels tie at each image's max, and one train step's
    grad_norm reaches 1e5 and more: the reference's behaviour, kept on
    record. The port's head sums, adds its bias and takes its sigmoid in
    float32 (as the TPU run effectively did), so its float32 mask is within
    two bf16 ulps of JAX's, no pixel ties at an image's max, and the step's
    grad_norm stays under 100 (the JAX r5 run on the TPU logged at most
    47.7)."""
    cfg, _, _ = baseline_inputs
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"),
                              train=dataclasses.replace(cfg.train, clip_value=10.0))
    train_ds = ICPWeightDataset(list(cfg.train_loc_pairs), cfg, "train")
    batch = next(epoch_batches(train_ds, 4, cfg, seed=0, prefetch=0, device="cpu"))
    jtr = JTrainer(JConfig.from_dict(dataclasses.asdict(cfg)), mesh=make_mesh(1),
                   logger=JMetricsLogger(cfg.train.checkpoint_dir + "_j"))
    jstate = jtr.init_state()
    jbatch = jax.tree_util.tree_map(lambda t: t.numpy(), batch)
    trainer = Trainer(cfg, "cpu")
    state = trainer.init_state()
    with torch.no_grad():
        for k, v in params_from_flax(jstate.variables["params"]).items():
            state.params[k].copy_(v)
    loc = batch["loc_data"]
    jmask = np.asarray(jtr.policy.compute_mask(jstate.variables, jbatch["loc_data"]["fft_data"],
                                               jbatch["loc_data"]["fft_cfar"], train=False)[0])
    with torch.no_grad():
        mask = trainer.policy.compute_mask(state.params, loc["fft_data"], loc["fft_cfar"])
    assert mask.dtype == torch.float32
    mask = mask.numpy()
    assert np.abs(mask - jmask).max() <= 2 * 2.0 ** -8

    def ties(m):
        return (m >= m.max(axis=(1, 2), keepdims=True)).sum((1, 2))

    assert np.unique(jmask).size <= 32 and (ties(jmask) > 1).any()
    assert np.unique(mask).size > 1000 and (ties(mask) == 1).all()
    _, _, _, jgn = jtr._train_step(jstate, jbatch, mask_losses_active=True)
    _, _, _, gn = trainer.train_step(state, batch)
    assert float(jgn) > 1e5 and gn.item() < 100.0


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        e2e.main(["--scale", "tiny", "--root", str(tmp_path / "tree")])
