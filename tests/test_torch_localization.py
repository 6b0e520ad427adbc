"""The port's localization pipeline vs the JAX package's on the CPU, at the
tiny scene of ``tests/test_localization.py`` (64 × 512 polar scans, 128 scan
and 512 map points) as the port's ``synthetic_batch`` makes it in numpy, and
a UNet of widths (4, 8) whose parameters both packages share.

``project_map`` is exact. Poses are held at the ICP tests' limits, 1e-4 m
and 1e-5 rad, ``matched_ratio`` and ``ok`` equal; with the mask in the loop
an item may also settle at another converged pose (``hold`` says when). The mask of
``mask_for_scan`` within 1e-5 of JAX's (float32 convolutions summed in
another order).
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from mm_masking_tpu.localization import pipeline as jpipe
from mm_masking_tpu.models.policy import LearnICPWeightPolicy as JPolicy
from mm_masking_tpu_torch.config import Config, ModelConfig
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.dicp import icp
from mm_masking_tpu_torch.localization import pipeline
from mm_masking_tpu_torch.models import LearnICPWeightPolicy, params_from_flax
from mm_masking_tpu_torch.parallel import make_mesh

SPEC = SyntheticSpec(
    n_scan=128, n_map=512, polar_shape=(64, 512), cart_pixel_width=64,
    res=15.0 / 512, cart_resolution=0.5, max_range=14.0, min_range=2.0,
    pos_std=0.3, rot_std=0.1, network_input_type="polar",
)
CFG = dict(detector="modified_cacfar", detector_kwargs=(("width", 21), ("guard", 2),
                                                          ("maxr", 15.0)),
           radar_resolution=SPEC.res, max_points=256, beta=0.0, icp_type="pt2pl")
MODEL = dict(enc_channels=(4, 8), res=SPEC.res, polar_shape=SPEC.polar_shape,
             cart_pixel_width=64, cart_resolution=0.5, dropout=0.0)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    """The scene as numpy arrays, fed to both packages."""
    b = synthetic_batch(0, batch=6, spec=SPEC)
    return jax.tree_util.tree_map(lambda x: x.numpy(), b)


def flax_variables(params: dict) -> dict:
    """The port's UNet state_dict as the JAX policy's variables (the inverse
    of ``params_from_flax``)."""
    out = {}
    for name, v in params.items():
        leaf = "kernel" if name.endswith("weight") else "bias"
        a = v.numpy().transpose(2, 3, 1, 0) if leaf == "kernel" else v.numpy()
        if name.startswith("final."):
            out.setdefault("Conv_0", {})[leaf] = a
        else:
            _, i, conv, _ = name.split(".")
            out.setdefault(f"ConvBlock_{i}", {}).setdefault(f"Conv_{conv[-1]}", {})[leaf] = a
    return {"params": out}


@pytest.fixture(scope="module")
def policies():
    policy = LearnICPWeightPolicy(Config(model=ModelConfig(**MODEL)), "cpu")
    params = policy.init(torch.Generator().manual_seed(0))
    variables = flax_variables(params)
    back = params_from_flax(variables["params"])
    assert back.keys() == params.keys() and all(torch.equal(back[k], params[k]) for k in params)
    return JPolicy(JConfig(model=JModelConfig(**MODEL))), variables, policy, params


def frames_of(b):
    return {"fft": b["loc_data"]["fft_data"], "azimuths": b["loc_data"]["azimuths"],
            "az_times": b["loc_data"]["az_times"]}


def hold(got: dict, want: dict, fixed_point=None) -> None:
    """T within 1e-4 m / 1e-5 rad; matched ratio and ok equal.

    ``fixed_point`` (map (B, M, 6), LocalizationConfig): an item may instead
    land elsewhere if JAX's pose is a fixed point of the port's refined
    solve on the port's own points and weights (a restart there moves it
    less than 1e-4 m): two converged solutions of one problem, parted by
    weights an ulp apart (the mask's float32 sums), as the reference's
    solver parts on another order of summation. Some item must agree.
    """
    g, w = got["T"], torch.from_numpy(np.array(want["T"]))
    close = (((g - w)[:, :3, 3].norm(dim=-1) <= 1e-4)
             & ((g - w)[:, :3, :3].abs().amax(dim=(1, 2)) <= 1e-5))
    if fixed_point is None or close.all():
        np.testing.assert_allclose(g[:, :3, 3].numpy(), w[:, :3, 3].numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(g[:, :3, :3].numpy(), w[:, :3, :3].numpy(), rtol=0, atol=1e-5)
    else:
        map_b, cfg = fixed_point
        refined = dataclasses.replace(pipeline._icp_configs(cfg)[1], tolerance=1e-7)
        again = icp(got["points"], pipeline.project_map(map_b, cfg), w, weight=got["weights"],
                    cfg=refined)["T"]
        assert close.any()
        assert ((again - w)[~close, :3, 3].norm(dim=-1) <= 1e-4).all()
    np.testing.assert_array_equal(got["matched_ratio"].numpy(), np.asarray(want["matched_ratio"]))
    np.testing.assert_array_equal(got["ok"].numpy(), np.asarray(want["ok"]))


def test_project_map_is_exact():
    rng = np.random.default_rng(3)
    m = rng.normal(size=(2, 300, 6)).astype(np.float32)
    m[..., :2] *= 10.0
    m[:, :50, 2] = 0.0  # in the radar's plane
    m[:, :80, 5] *= 0.2  # small z-normals
    cfg = dict(elevation_threshold=0.05, normal_threshold=0.5)
    want = np.asarray(jpipe.project_map(jnp.asarray(m), jpipe.LocalizationConfig(**cfg)))
    got = pipeline.project_map(t(m), pipeline.LocalizationConfig(**cfg)).numpy()
    assert 0 < (got[..., 0] != 1000.0).sum() < got[..., 0].size
    np.testing.assert_array_equal(got, want)


def test_localize_frame_matches_jax(scene):
    """With a matched-ratio gate that some frames fail."""
    b = scene
    cfg = dict(CFG, min_matched_ratio=0.9)
    args = (b["loc_data"]["fft_data"], b["loc_data"]["azimuths"], b["loc_data"]["az_times"],
            b["map_data"]["pc"], b["transforms"]["T_ml_init"])
    want = jpipe._localize_frame_jit(*args, jpipe.LocalizationConfig(**cfg))
    got = pipeline.localize_frame(*map(t, args), pipeline.LocalizationConfig(**cfg))
    hold(got, want)
    np.testing.assert_array_equal(got["points"].numpy() != 0, np.asarray(want["points"]) != 0)
    np.testing.assert_array_equal(got["ok"].numpy(), got["matched_ratio"].numpy() >= 0.9)


def test_localize_clouds_matches_jax(scene):
    b = scene
    cfg = dict(CFG, icp_type="pt2pt", beta=0.049, motion_undistort=True)
    pc = b["loc_data"]["filtered_pc"]
    rng = np.random.default_rng(4)
    vel = rng.uniform(-3, 3, (pc.shape[0], 2)).astype(np.float32)
    times = rng.uniform(0, 2.5e8, pc.shape[:2]).astype(np.float32)
    args = (pc, b["map_data"]["pc"], b["transforms"]["T_ml_init"])
    want = jpipe._localize_clouds_jit(*args, jpipe.LocalizationConfig(**cfg), pc_times=times,
                                      velocity=vel)
    got = pipeline.localize_clouds(*map(t, args), pipeline.LocalizationConfig(**cfg),
                                   pc_times=t(times), velocity=t(vel))
    hold(got, want)
    np.testing.assert_allclose(got["points"].numpy(), np.asarray(want["points"]), atol=1e-5)


def test_mask_for_scan_matches_jax(scene, policies):
    jpolicy, variables, policy, params = policies
    fft, az = scene["loc_data"]["fft_data"], scene["loc_data"]["azimuths"]
    want = np.asarray(jax.jit(jpolicy.mask_for_scan)(variables, fft, az))
    got = policy.mask_for_scan(params, t(fft), t(az)).detach().numpy()
    assert got.shape == (6, 64, 64) and want.shape == got.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_localize_sequence_with_mask_matches_jax_and_the_manual_chain(scene, policies):
    """Five frames in chunks of 2 (the last padded with the last frame) with
    the mask in the loop: equal to JAX's fused program, and to the manual
    ``mask_for_scan`` → ``localize_frame`` chain per chunk."""
    jpolicy, variables, policy, params = policies
    b = scene
    frames = {k: np.asarray(v)[:5] for k, v in frames_of(b).items()}
    T0 = np.asarray(b["transforms"]["T_ml_init"])[:5]
    map_pc = np.asarray(b["map_data"]["pc"])[:1]
    cfg = pipeline.LocalizationConfig(**CFG)
    want = jpipe.localize_sequence(frames, jnp.asarray(map_pc), jpipe.LocalizationConfig(**CFG),
                                   T_inits=jnp.asarray(T0), batch_size=2, weight_policy=jpolicy,
                                   policy_variables=variables)
    got = pipeline.localize_sequence(frames, t(map_pc), cfg, T_inits=T0, batch_size=2,
                                     weight_policy=policy, policy_variables=params)
    np.testing.assert_allclose(got["weights"].numpy(), np.asarray(want["weights"]), rtol=0,
                               atol=1e-5)
    hold(got, want, fixed_point=(t(map_pc).expand(5, -1, -1), cfg))
    pad = {k: np.concatenate([v, v[-1:]]) for k, v in frames.items()}
    T_pad = np.concatenate([T0, T0[-1:]])
    manual = []
    for s in range(0, 6, 2):
        f, a, z = (t(pad[k][s:s + 2]) for k in ("fft", "azimuths", "az_times"))
        wm = policy.mask_for_scan(params, f, a)
        manual.append(pipeline.localize_frame(f, a, z, t(map_pc).expand(2, -1, -1),
                                              t(T_pad[s:s + 2]), cfg, weight_mask=wm,
                                              mask_cart_resolution=0.5, mask_cart_width=64))
    for key in ("T", "weights", "matched_ratio", "ok"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      torch.cat([m[key] for m in manual])[:5].numpy())


def test_localize_cloud_sequence_matches_jax(scene):
    b = scene
    clouds = np.asarray(b["loc_data"]["filtered_pc"])[:5]
    T0 = np.asarray(b["transforms"]["T_ml_init"])[:5]
    map3 = np.asarray(b["map_data"]["pc"])[0, :, :3]  # no normals: zero normals, pt2pt
    cfg = dict(CFG, icp_type="pt2pt", normal_threshold=1.0)
    want = jpipe.localize_cloud_sequence(clouds, jnp.asarray(map3),
                                         jpipe.LocalizationConfig(**cfg), T_inits=T0,
                                         batch_size=2)
    got = pipeline.localize_cloud_sequence(clouds, t(map3), pipeline.LocalizationConfig(**cfg),
                                           T_inits=T0, batch_size=2)
    hold(got, want)


@pytest.mark.parametrize("source", ["clouds", "frames"])
def test_localize_sequence_tracked_matches_jax(scene, source):
    """Frames 0..3 of one item's scan seen from a drifting pose: each frame
    starts from the extrapolation of the two before."""
    b = scene
    cfg = dict(CFG, icp_type="pt2pt", normal_threshold=1.0)
    map_pc = np.asarray(b["map_data"]["pc"])[:1]
    T0 = np.asarray(b["transforms"]["T_ml_init"])[0]
    if source == "clouds":
        data = dict(clouds=np.repeat(np.asarray(b["loc_data"]["filtered_pc"])[:1], 4, 0))
        want = jpipe.localize_sequence_tracked(None, jnp.asarray(map_pc),
                                               jpipe.LocalizationConfig(**cfg), T0=T0, **data)
        got = pipeline.localize_sequence_tracked(None, t(map_pc),
                                                 pipeline.LocalizationConfig(**cfg), T0=T0, **data)
    else:
        frames = {k: np.asarray(v)[:4] for k, v in frames_of(b).items()}
        want = jpipe.localize_sequence_tracked(frames, jnp.asarray(map_pc),
                                               jpipe.LocalizationConfig(**cfg), T0=T0)
        got = pipeline.localize_sequence_tracked(frames, t(map_pc),
                                                 pipeline.LocalizationConfig(**cfg), T0=T0)
    hold(got, want)


def test_localize_sequence_to_traj_writes_T_loc_map(scene, tmp_path):
    b = scene
    frames = {k: np.asarray(v)[:3] for k, v in frames_of(b).items()}
    T0 = np.asarray(b["transforms"]["T_ml_init"])[:3]
    path = str(tmp_path / "traj.txt")
    out = pipeline.localize_sequence_to_traj(frames, t(np.asarray(b["map_data"]["pc"])[:1]),
                                             [10, 20, 30], path,
                                             pipeline.LocalizationConfig(**CFG), T_inits=T0,
                                             batch_size=2)
    rows = np.loadtxt(path)
    assert rows.shape == (3, 13) and rows[:, 0].tolist() == [10, 20, 30]
    T = out["T"].numpy()
    for row, Ti in zip(rows, T):
        np.testing.assert_allclose(row[1:].reshape(3, 4), np.linalg.inv(Ti)[:3], atol=1e-5)


def test_unported_paths_raise(scene, policies):
    """``mesh=`` runs since the mesh was ported: the trivial mesh of one
    process gives the call without a mesh (``tests/test_torch_mesh.py``
    holds two ranks). A tracked sequence of clouds with a policy still
    raises: the mask needs the raw scans."""
    _, _, policy, params = policies
    b = scene
    map_pc = t(np.asarray(b["map_data"]["pc"])[:1])
    frames = {k: np.asarray(v)[:2] for k, v in frames_of(b).items()}
    cfg = pipeline.LocalizationConfig(**CFG)
    got = pipeline.localize_sequence(frames, map_pc, cfg, batch_size=2, mesh=make_mesh())
    want = pipeline.localize_sequence(frames, map_pc, cfg, batch_size=2)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    clouds = want["points"]
    got = pipeline.localize_cloud_sequence(clouds, map_pc, cfg, batch_size=2, mesh=make_mesh())
    assert torch.equal(got["T"], pipeline.localize_cloud_sequence(clouds, map_pc, cfg,
                                                                  batch_size=2)["T"])
    with pytest.raises(ValueError, match="raw frames"):
        pipeline.localize_sequence_tracked(None, map_pc, clouds=np.zeros((1, 8, 3), np.float32),
                                           weight_policy=policy, policy_variables=params)


def test_port_imports_without_jax():
    """The port's localization, in a process where importing jax fails."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import mm_masking_tpu_torch.localization, mm_masking_tpu_torch.localization.__main__, "
            "mm_masking_tpu_torch.ops.lidar; "
            "assert not [m for m in sys.modules if m.startswith('mm_masking_tpu.')]")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
