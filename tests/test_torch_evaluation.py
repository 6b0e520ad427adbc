"""The port's evaluation harness vs the JAX package's on the CPU: peak
extraction (``mean_peaks``, ``extract_pc``), the per-frame errors and their
summary, the two localizers, baselines 1–3, and the ground-truth tools.

``extract_pc``'s polar means (range, azimuth, time) are equal bit for bit;
its cartesian points go through cos and sin, which XLA and torch round
apart by up to an ulp, so they are held within 2 float32 ulps of their
magnitude. The solves are held at the ICP tests' limits on converged items:
1e-4 m and 1e-5 rad. The heading error takes atan2 where the JAX package
takes arcsin (ROADMAP.md §3): equal within ±90°, and only the port's
unfolds beyond.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from mm_masking_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from mm_masking_tpu.data.synthetic import SyntheticSpec as JSpec, synthetic_batch as jbatch
from mm_masking_tpu.evaluation import (
    baselines as jbaselines,
    frame_errors as jframe_errors,
    make_constant_weight_localizer as jconstant,
    make_masked_localizer as jmasked,
    summarize as jsummarize,
)
from mm_masking_tpu.evaluation import gt_tools as jgt
from mm_masking_tpu.models.policy import LearnICPWeightPolicy as JPolicy
from mm_masking_tpu.ops import cfar as jcfar
from mm_masking_tpu_torch.config import Config, ModelConfig
from mm_masking_tpu_torch.data.boreas import yawPitchRollToRot
from mm_masking_tpu_torch.evaluation import (
    SequenceErrors,
    baselines,
    evaluate_policy_on_sequences,
    evaluate_sequence,
    frame_errors,
    make_constant_weight_localizer,
    make_masked_localizer,
    summarize,
)
from mm_masking_tpu_torch.evaluation import gt_tools
from mm_masking_tpu_torch.models import params_from_flax
from mm_masking_tpu_torch.ops import cfar
from mm_masking_tpu_torch.train import Trainer

SPEC = dict(n_scan=128, n_map=512, polar_shape=(64, 512), cart_pixel_width=64,
            res=15.0 / 512, cart_resolution=0.5, max_range=14.0, min_range=2.0,
            pos_std=0.4, rot_std=0.15)
MODEL = dict(res=SPEC["res"], polar_shape=SPEC["polar_shape"], cart_pixel_width=64,
             cart_resolution=0.5, enc_channels=(4, 8), dropout=0.0)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def batch(seed, polar=False, B=4):
    spec = JSpec(**SPEC, network_input_type="polar" if polar else "cartesian")
    return jbatch(seed, batch=B, spec=spec)


def hold_poses(got: torch.Tensor, want, converged=None) -> None:
    """T within 1e-4 m and 1e-5 rad (the ICP tests' limits) on the items
    ``converged`` marks (all by default), and some converged."""
    g, w = got.numpy(), np.asarray(want)
    sel = np.ones(len(g), bool) if converged is None else converged
    assert sel.any()
    np.testing.assert_allclose(g[sel, :3, 3], w[sel, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g[sel, :3, :3], w[sel, :3, :3], rtol=0, atol=1e-5)


def scan_mask(seed=0, B=2, A=16, R=64):
    rng = np.random.default_rng(seed)
    fft = (rng.random((B, A, R)) ** 3).astype(np.float32)
    kw = dict(width=11, guard=2, minr=1.0, maxr=14.0)
    return {diff: np.asarray(jcfar.cfar_mask(jnp.asarray(fft), 0.25, diff=diff, **kw))
            for diff in (False, True)}


@pytest.mark.parametrize("diff", [False, True])
def test_mean_peaks_matches_jax(diff):
    mask = scan_mask()[diff] * 3.7
    np.testing.assert_array_equal(cfar.mean_peaks(torch.from_numpy(mask), diff).numpy(),
                                  np.asarray(jcfar.mean_peaks(jnp.asarray(mask), diff)))
    np.testing.assert_array_equal(cfar.hardshrink(torch.from_numpy(mask - 1), 0.3).numpy(),
                                  np.asarray(jcfar.hardshrink(jnp.asarray(mask - 1), 0.3)))


@pytest.mark.parametrize("times_dtype", [np.float32, np.int32])
@pytest.mark.parametrize("diff", [False, True])
def test_extract_pc_matches_jax(diff, times_dtype):
    """Blobs of one bin and of several, up to overflow (max_points 40 takes
    fewer pairs than the scans hold); integer times keep their dtype
    through the scatter."""
    mask = scan_mask()[diff]
    rng = np.random.default_rng(1)
    az = np.sort(rng.uniform(0, 2 * np.pi, (2, 16))).astype(np.float32)
    times = (rng.uniform(0, 1, (2, 16)) if times_dtype == np.float32
             else rng.integers(0, 10**6, (2, 16))).astype(times_dtype)
    T_ab = np.stack([np.eye(4, dtype=np.float32)] * 2)
    T_ab[1, :3, :3] = yawPitchRollToRot(0.4, 0, 0)
    T_ab[1, :3, 3] = [1.0, -2.0, 0.0]
    for max_points, T in ((40, None), (1000, None), (1000, T_ab)):
        kw = dict(max_points=max_points, diff=diff, return_times=True)
        pj, tj = jcfar.extract_pc(jnp.asarray(mask), 0.25, jnp.asarray(az), jnp.asarray(times),
                                  T_ab=None if T is None else jnp.asarray(T), **kw)
        pt, tt = cfar.extract_pc(torch.from_numpy(mask), 0.25, torch.from_numpy(az),
                                 torch.from_numpy(times),
                                 T_ab=None if T is None else torch.from_numpy(T), **kw)
        pj, tj = np.asarray(pj), np.asarray(tj)
        assert pt.shape == pj.shape == (2, max_points, 3) and tt.dtype == torch.float32
        np.testing.assert_array_equal(tt.numpy(), tj)
        np.testing.assert_array_equal(pt.numpy() == 0, pj == 0)
        np.testing.assert_allclose(pt.numpy(), pj, rtol=0,
                                   atol=2 * np.finfo(np.float32).eps * np.abs(pj).max())
        if T is not None:
            continue
        n_real = (pj[..., 0] != 0).sum(1)
        assert (n_real > 5).all()
        if max_points == 40:
            assert (n_real == 40).all()  # overflow dropped
        else:
            assert (n_real < max_points).all()  # underflow padded
    polar = np.asarray(jcfar.pol_2_cart_batched(jnp.asarray(az[..., None] * [1.0, 1.0])))
    np.testing.assert_allclose(
        cfar.pol_2_cart_batched(torch.from_numpy(az[..., None] * np.float32(1))
                                .expand(-1, -1, 2).contiguous()).numpy(),
        polar, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gt_eye", [True, False])
def test_frame_errors_and_summary_match_jax(gt_eye):
    rng = np.random.default_rng(2)
    T = np.stack([np.eye(4, dtype=np.float32)] * 5)
    T_gt = T.copy()
    for i in range(5):
        T[i, :3, :3] = yawPitchRollToRot(rng.uniform(-0.3, 0.3), 0, 0)
        T[i, :2, 3] = rng.uniform(-1, 1, 2)
        T_gt[i, :3, :3] = yawPitchRollToRot(rng.uniform(-0.3, 0.3), 0, 0)
        T_gt[i, :2, 3] = rng.uniform(-1, 1, 2)
    want = jframe_errors(jnp.asarray(T), jnp.asarray(T_gt), gt_eye=gt_eye)
    got = frame_errors(torch.from_numpy(T), torch.from_numpy(T_gt), gt_eye=gt_eye)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    r, t = (np.asarray(w) for w in want)
    assert summarize(r, t).as_dict() == jsummarize(r, t).__dict__


def test_localizers_match_jax():
    """Both localizers on a cartesian synthetic batch: constant weights, and
    weights looked up in a mask image."""
    jc, c = JConfig(model=JModelConfig(**MODEL)), Config(model=ModelConfig(**MODEL))
    b = batch(0)
    args = (b["loc_data"]["filtered_pc"], b["map_data"]["pc"], b["transforms"]["T_ml_init"])
    want = jconstant(jc)(*args)
    tb = to_torch(b)
    targs = (tb["loc_data"]["filtered_pc"], tb["map_data"]["pc"], tb["transforms"]["T_ml_init"])
    hold_poses(make_constant_weight_localizer(c)(*targs), want)
    mask = np.random.default_rng(3).random((4, 64, 64)).astype(np.float32)
    hold_poses(make_masked_localizer(c)(torch.from_numpy(mask), *targs),
               jmasked(jc)(jnp.asarray(mask), *args))


def test_evaluate_sequence_matches_jax():
    """A two-batch sequence through the constant-weight localizer: the same
    frame count and error statistics (within the solve's limits)."""
    jc, c = JConfig(model=JModelConfig(**MODEL)), Config(model=ModelConfig(**MODEL))
    seq = [batch(s) for s in (0, 1)]
    jloc, loc = jconstant(jc), make_constant_weight_localizer(c)
    from mm_masking_tpu.evaluation import evaluate_sequence as jevaluate_sequence

    want = jevaluate_sequence(seq, lambda b: jloc(
        b["loc_data"]["filtered_pc"], b["map_data"]["pc"], b["transforms"]["T_ml_init"]))
    got = evaluate_sequence([to_torch(b) for b in seq], lambda b: loc(
        b["loc_data"]["filtered_pc"], b["map_data"]["pc"], b["transforms"]["T_ml_init"]))
    assert isinstance(got, SequenceErrors) and got.n_frames == want.n_frames == 8
    for k, v in want.as_dict().items():
        assert abs(getattr(got, k) - v) <= 1e-4, k


def test_baselines_1_to_3_match_jax():
    """Config 1 (unweighted pt2pl), config 2 (CFAR peaks on the polar scan →
    constant-weight ICP) and config 3 (the UNet mask and weighted ICP from
    the same converted parameters)."""
    jc, c = JConfig(model=JModelConfig(**MODEL)), Config(model=ModelConfig(**MODEL))
    b = batch(4)
    hold_poses(baselines.config1_unweighted_pt2pl(c, to_torch(b)),
               jbaselines.config1_unweighted_pt2pl(jc, b))

    pb = batch(5, polar=True)
    T_want, pc_want = jbaselines.config2_cacfar_constant_icp(jc, pb, max_points=256)
    T_got, pc_got = baselines.config2_cacfar_constant_icp(c, to_torch(pb), max_points=256)
    pc_want = np.asarray(pc_want)
    assert (pc_want[..., 0] != 0).sum() > 100
    np.testing.assert_array_equal(pc_got.numpy() == 0, pc_want == 0)
    np.testing.assert_allclose(pc_got.numpy(), pc_want, rtol=0, atol=1e-5)
    hold_poses(T_got, T_want)

    jpolicy = JPolicy(jc)
    variables = jpolicy.init(jax.random.PRNGKey(0))
    trainer = Trainer(c, "cpu")
    params = params_from_flax(variables["params"])
    T_want, mask_want = jbaselines.config3_learned_mask_icp(jpolicy, variables, b)
    T_got, mask_got = baselines.config3_learned_mask_icp(trainer.policy, params, to_torch(b))
    np.testing.assert_allclose(mask_got.numpy(), np.asarray(mask_want), rtol=0, atol=1e-5)
    hold_poses(T_got, T_want)


def test_policy_on_sequences_and_train_step_baselines(tmp_path):
    """Configs 4 and 5 through the trainer: one train step, and the learned
    mask's errors per sequence equal the per-frame errors of the trainer's
    own policy forward."""
    c = Config(model=ModelConfig(**MODEL, max_iter=3, inference_max_iter=8))
    trainer = Trainer(c, "cpu")
    state = trainer.init_state(0)
    seqs = {"a": lambda: [to_torch(batch(6))], "b": lambda: [to_torch(batch(7)),
                                                             to_torch(batch(8))]}
    got = baselines.config5_multi_sequence(trainer, state, seqs)
    assert got == evaluate_policy_on_sequences(trainer, state, seqs)
    assert [got[k].n_frames for k in "ab"] == [4, 8]
    b = to_torch(batch(6))
    with torch.inference_mode():
        out = trainer.policy.apply(state.params, b["loc_data"], b["map_data"],
                                   b["transforms"]["T_ml_init"])
    r, t = frame_errors(out.T_pred, b["transforms"]["T_ml_gt"])
    assert got["a"] == summarize(r.numpy(), t.numpy())
    state, loss, _, grad_norm = baselines.config4_train_step(trainer, state, b)
    assert state.step == 1 and torch.isfinite(loss) and torch.isfinite(grad_norm)


def write_csv(path, rows):
    with open(path, "w") as f:
        f.write("GPSTime,easting,northing,altitude,ve,vn,vu,roll,pitch,heading\n")
        for t_us, x, y, h in rows:
            f.write(f"{t_us / 1e6:.6f},{x},{y},0,0,0,0,0,0,{h}\n")


def make_T(x, y, h):
    T = np.eye(4)
    T[:3, :3] = yawPitchRollToRot(h, 0, 0)
    T[:3, 3] = [x, y, 0]
    return T


@pytest.mark.parametrize("map_frame", ["closest_time", "first"])
def test_gt_tools_match_jax(tmp_path, map_frame):
    """An estimated trajectory with heading errors within ±90° against the
    Applanix CSVs: the same statistics and aligned GT file as JAX's, and
    with ``plots_dir`` the error plot and table under JAX's names."""
    rng = np.random.default_rng(9)
    times = [1_000_000 + 100_000 * i for i in range(8)]
    loc_rows = [(t, 10 + i, 5 - 0.5 * i, 0.1 * i) for i, t in enumerate(times)]
    map_rows = [(t - 50, 10 + i + 0.2, 5 - 0.5 * i, 0.1 * i + 0.05) for i, t in enumerate(times)]
    write_csv(tmp_path / "loc.csv", loc_rows)
    write_csv(tmp_path / "map.csv", map_rows)
    est = [make_T(*rng.uniform(-1, 1, 2), rng.uniform(-0.8, 0.8)) for _ in times]
    gt_tools.write_traj_file(str(tmp_path / "est.txt"), est, times)
    kw = dict(tol_us=0, map_frame=map_frame)
    want = jgt.eval_localization_run(str(tmp_path / "est.txt"), str(tmp_path / "map.csv"),
                                     str(tmp_path / "loc.csv"),
                                     out_gt_path=str(tmp_path / "j_gt.txt"), **kw)
    got = gt_tools.eval_localization_run(str(tmp_path / "est.txt"), str(tmp_path / "map.csv"),
                                         str(tmp_path / "loc.csv"),
                                         out_gt_path=str(tmp_path / "t_gt.txt"), **kw)
    assert got.keys() == want.keys() and got["n_frames"] == 8
    for k in want:  # the headings: atan2 against arcsin, equal up to float64 rounding
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-8), k
    assert (tmp_path / "t_gt.txt").read_bytes() == (tmp_path / "j_gt.txt").read_bytes()
    assert gt_tools.read_traj_file(str(tmp_path / "t_gt.txt"))[1] == times
    assert gt_tools.check_time_match(times, times) and not gt_tools.check_time_match(
        [times[0] + 7], times)
    # plots_dir: JAX's file names; the CSV's numbers JAX's; the PNG the port's own.
    args = [str(tmp_path / n) for n in ("est.txt", "map.csv", "loc.csv")]
    jplots = jgt.eval_localization_run(*args, plots_dir=str(tmp_path / "j"), seq_name="s",
                                       **kw)["plots"]
    plots = gt_tools.eval_localization_run(*args, plots_dir=str(tmp_path / "t"), seq_name="s",
                                           **kw)["plots"]
    assert {k: os.path.basename(v) for k, v in plots.items()} == {
        k: os.path.basename(v) for k, v in jplots.items()}
    assert plots["png"] == str(tmp_path / "t" / "s_loc_errors.png")
    np.testing.assert_allclose(np.loadtxt(plots["csv"], delimiter=",", skiprows=1),
                               np.loadtxt(jplots["csv"], delimiter=",", skiprows=1),
                               rtol=0, atol=2e-6)
    img = plt.imread(plots["png"])
    assert img.shape == (3 * 220 + 2 * 2, 900, 3) and img.min() < img.max()


def test_heading_error_unfolds_beyond_90_degrees():
    """Within ±90° atan2 and arcsin agree; beyond, the port's error is the
    heading itself where the JAX package's folds back."""
    gt = [make_T(0, 0, 0)] * 4
    est = [make_T(0.1, 0, h) for h in (0.3, -1.2, 2.0, -2.8)]
    rot, trans = gt_tools.relative_loc_errors(est, gt)
    jrot, jtrans = jgt.relative_loc_errors(est, gt)
    np.testing.assert_allclose(rot, [0.3, 1.2, 2.0, 2.8], rtol=1e-12)
    np.testing.assert_allclose(rot[:2], jrot[:2], rtol=1e-12)
    np.testing.assert_allclose(jrot[2:], np.pi - np.array([2.0, 2.8]), rtol=1e-12)
    np.testing.assert_array_equal(trans, jtrans)
    signed, lon, lat = gt_tools.relative_loc_error_components(est, gt)
    jsigned, jlon, jlat = jgt.relative_loc_error_components(est, gt)
    np.testing.assert_allclose(signed, [0.3, -1.2, 2.0, -2.8], rtol=1e-12)
    np.testing.assert_allclose(signed[:2], jsigned[:2], rtol=1e-12)
    np.testing.assert_array_equal(lon, jlon)
    np.testing.assert_array_equal(lat, jlat)
