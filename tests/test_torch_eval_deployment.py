"""The port's deployment protocol
(``mm_masking_tpu_torch.benchmarks.eval_deployment``) on the CPU.

``seg_dist_2d`` is bit for bit the JAX script's. On a tiny run the port
trained once for the module (``e2e_product --scale tiny``), the protocol
with ``--device cpu`` writes ``deploy_summary.json`` with the keys of the
JAX run's (``results/e2e_product_r5/deploy_summary.json``), each arm's stats
with JAX's keys (``plots``: the error plots under JAX's file names) and every number
finite; the ghost check's true, ghost and unclassified counts partition the
valid points of the scans it reads.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from mm_masking_tpu_torch.benchmarks import e2e_product as e2e
from mm_masking_tpu_torch.benchmarks import eval_deployment as deploy
from mm_masking_tpu_torch.localization import __main__ as cli
from mm_masking_tpu_torch.localization.pipeline import LocalizationConfig
from test_torch_e2e_product import cwd, load_jax_script, one_thread, read_json  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
ARMS = ("ones", "learned", "chain_ones", "chain_learned")


@pytest.mark.parametrize("seed", [0, 1])
def test_seg_dist_2d_is_the_jax_scripts(seed):
    jax_deploy = load_jax_script("eval_deployment")
    rng = np.random.default_rng(seed)
    _, segs = e2e.build_world(np.random.default_rng(7), e2e.Scale())
    pts = rng.uniform(-60.0, 120.0, (2000, 2))
    got, want = deploy.seg_dist_2d(pts, segs), jax_deploy.seg_dist_2d(pts, segs)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """A tiny run trained by the port, then the protocol on it: (workdir,
    the tree, the summary)."""
    workdir = tmp_path_factory.mktemp("deploy")
    tree = str(workdir / "tree") + "_tiny"
    with cwd(workdir), open(workdir / "out.txt", "w") as out, contextlib.redirect_stdout(out):
        e2e.main(["--scale", "tiny", "--epochs", "1", "--root", str(workdir / "tree")] + CPU)
        summary = deploy.main(["--scale", "tiny", "--root", tree, "--checkpoint",
                               "results/checkpoints/e2e_product", "--out", "out"] + CPU)
    return workdir, tree, summary


def test_protocol_writes_the_jax_summary(protocol):
    workdir, _, summary = protocol
    want = read_json(REPO / "results" / "e2e_product_r5" / "deploy_summary.json")
    on_disk = read_json(workdir / "out" / "deploy_summary.json")
    assert on_disk == json.loads(json.dumps(summary))
    assert set(summary) == set(want) - {"note"}
    for arm in ARMS:
        assert set(summary[arm]) == set(want[arm]), arm
        plots = summary[arm]["plots"]
        assert set(plots) == set(want[arm]["plots"]), arm
        for kind, path in plots.items():
            assert os.path.basename(path) == os.path.basename(want[arm]["plots"][kind])
            assert os.path.isfile(workdir / path)
        assert plt.imread(workdir / plots["png"]).ndim == 3
        assert read_json(workdir / "out" / f"stats_{arm}.json") == summary[arm]
        assert summary[arm]["n_frames"] == e2e.TINY.n_val
        assert os.path.exists(workdir / "out" / f"traj_{arm}.txt")
    assert set(summary["ghost_suppression"]) == set(want["ghost_suppression"]) | {
        "n_unclassified"}
    assert os.path.exists(workdir / "out" / "teach_map.npz")


def test_protocol_numbers_are_finite(protocol):
    _, _, summary = protocol
    numbers = [v for arm in ARMS for k, v in summary[arm].items() if k != "plots"]
    numbers += [summary[k] for k in ("rmse_ratio_gt_prior", "rmse_ratio_chain",
                                     "p50_ratio_gt_prior")]
    numbers += list(summary["ghost_suppression"].values())
    assert all(math.isfinite(v) for v in numbers), summary


def test_ghost_classes_partition_the_valid_points(protocol):
    _, tree, summary = protocol
    gs = summary["ghost_suppression"]
    scans = os.path.join(tree, "vtr_data", e2e.VAL_SEQ, "radar")
    _, paths = cli._scan_files(scans)
    clouds = cli._extract_clouds(
        cli._load_radar_frames(paths[:8]),
        LocalizationConfig(max_points=e2e.TINY.max_loc_pts, radar_resolution=e2e.TINY.res), 4,
        torch.device("cpu"))
    valid = int(((clouds[..., 0] != 0.0) | (clouds[..., 1] != 0.0)).sum())
    assert gs["n_true"] > 0 and gs["n_ghost"] > 0
    assert gs["n_true"] + gs["n_ghost"] + gs["n_unclassified"] == valid


def test_protocol_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        deploy.main(["--scale", "tiny", "--root", str(tmp_path), "--out", str(tmp_path / "o")])
