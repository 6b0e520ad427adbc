"""The port's localization CLI (``python -m mm_masking_tpu_torch.localization``)
vs the JAX package's on the CPU (``--device cpu``), on the synthetic worlds
of ``tests/test_cli_localization.py`` and ``tests/test_datagen.py``.

teach → localize: the map within 4e-4 m of JAX's (the teach poses' limits at
the world's radius), the stats' keys equal and their values within 1e-3.
datagen: the same shards, the scan clouds bit for bit and the map points
within 1e-3 m, and the port's ``ICPWeightDataset`` loads them. The learned
mask through ``--checkpoint`` (a port ``Trainer.save``) and ``--init-chain`` /
``--init-gt`` equal the library calls they stand for. The raw-scan loader
keeps its two regression fixes (the /255 scale, epoch times relative to the
scan), and the unported options refuse.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from mm_masking_tpu.localization import __main__ as jcli
from mm_masking_tpu.localization.datagen import DatagenConfig as JDatagenConfig
from mm_masking_tpu.localization.datagen import generate_pair as jgenerate_pair
from mm_masking_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mm_masking_tpu_torch.data import ICPWeightDataset
from mm_masking_tpu_torch.evaluation.gt_tools import read_traj_file
from mm_masking_tpu_torch.geom import se3_inv
from mm_masking_tpu_torch.localization import __main__ as cli
from mm_masking_tpu_torch.localization import pipeline
from mm_masking_tpu_torch.train import Trainer
from mm_masking_tpu_torch.train.checkpoint import load_policy_variables

CPU = ["--device", "cpu"]


def planar_T(x, y, h):
    T = np.eye(4)
    T[:2, :2] = [[np.cos(h), -np.sin(h)], [np.sin(h), np.cos(h)]]
    T[:2, 3] = [x, y]
    return T


@pytest.fixture(scope="module")
def world():
    """A ring and two walls (the JAX CLI tests' world)."""
    rng = np.random.default_rng(21)
    n = 800
    pts = np.zeros((n, 3), np.float32)
    r = rng.uniform(4, 12, n // 2)
    a = rng.uniform(0, 2 * np.pi, n // 2)
    pts[: n // 2, 0], pts[: n // 2, 1] = r * np.cos(a), r * np.sin(a)
    t = rng.uniform(-8, 8, n - n // 2)
    pts[n // 2:, 0] = t
    pts[n // 2:, 1] = np.where(t > 0, 6.0, -7.0)
    return pts


def write_shards(d, world, poses, stamps, rng):
    d.mkdir(parents=True, exist_ok=True)
    for T_wr, st in zip(poses, stamps):
        Ti = np.linalg.inv(T_wr)
        s = (world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        s += rng.normal(0, 0.01, s.shape).astype(np.float32)
        s[:, 2] = 0.0
        np.savez_compressed(d / f"frame_{st}.npz", filt_pc=s, raw_pc=s)


def write_csv(path, rows):
    with open(path, "w") as f:
        f.write("GPSTime,easting,northing,altitude,vel_e,vel_n,vel_u,roll,pitch,heading\n")
        for t_us, x, y, h in rows:
            f.write(f"{t_us / 1e6:.6f},{x},{y},0.0,0,0,0,0.0,0.0,{h}\n")


def raw_image(A, R, stamp_us, fft, az_step_us=400):
    """A raw Navtech byte image: int64 stamp bytes 0-7 (µs), uint16 encoder
    bytes 8-9, power in columns 11+."""
    img = np.zeros((A, 11 + R), np.uint8)
    ts = np.arange(A, dtype=np.int64) * az_step_us + stamp_us
    img[:, :8] = np.frombuffer(ts.tobytes(), np.uint8).reshape(A, 8)
    enc = (np.arange(A, dtype=np.float64) / A * 5600).astype(np.uint16)
    img[:, 8:10] = np.frombuffer(enc.tobytes(), np.uint8).reshape(A, 2)
    img[:, 11:] = np.clip(fft * 255, 0, 255).astype(np.uint8)
    return img


def write_raw_scans(d, world, poses, stamps, A=64, R=512, res=15.0 / 512):
    """Raw scans rendered from the world: bright two-bin returns over noise."""
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    for T_wr, st in zip(poses, stamps):
        Ti = np.linalg.inv(T_wr)
        s = world @ Ti[:3, :3].T + Ti[:3, 3]
        rr = np.hypot(s[:, 0], s[:, 1])
        aa = np.mod(np.arctan2(s[:, 1], s[:, 0]), 2 * np.pi)
        keep = (rr > 2.0) & (rr < (R - 4) * res)
        ai = np.clip((aa[keep] / (2 * np.pi / A)).astype(int), 0, A - 1)
        ri = np.clip((rr[keep] / res).astype(int), 0, R - 3)
        fft = (0.03 * rng.random((A, R))).astype(np.float32)
        for dd in range(2):
            fft[ai, ri + dd] = np.maximum(fft[ai, ri + dd], 0.85 - 0.2 * dd)
        np.save(d / f"{st}.npy", raw_image(A, R, 0, fft))


def test_teach_then_localize_match_jax(tmp_path, world):
    rng = np.random.default_rng(5)
    teach_stamps = [1_000_000 + 100_000 * i for i in range(3)]
    write_shards(tmp_path / "teach", world, [planar_T(0.2 * i, 0, 0) for i in range(3)],
                 teach_stamps, rng)
    reps = [(0.3 * i, 0.05 * i, 0.03 * i) for i in range(4)]
    rep_stamps = [2_000_000 + 100_000 * i for i in range(4)]
    write_shards(tmp_path / "repeat", world, [planar_T(*r) for r in reps], rep_stamps, rng)
    write_csv(tmp_path / "map_gt.csv", [(1_000_000, 0.0, 0.0, 0.0)])
    write_csv(tmp_path / "loc_gt.csv", [(t, *r) for t, r in zip(rep_stamps, reps)])

    outs = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, CPU)):
        d = tmp_path / name
        d.mkdir()
        assert main(["teach", "--scans", str(tmp_path / "teach"), "--out-map",
                     str(d / "map.npz"), "--out-traj", str(d / "odo.txt"), "--max-points", "1024",
                     "--max-map-pts", "1024", "--interp-period-us", "30000"] + extra) == 0
        assert main(["localize", "--scans", str(tmp_path / "repeat"), "--map",
                     str(d / "map.npz"), "--out-traj", str(d / "traj.txt"), "--map-gt",
                     str(tmp_path / "map_gt.csv"), "--loc-gt", str(tmp_path / "loc_gt.csv"),
                     "--stats", str(d / "stats.json"), "--max-points", "1024", "--batch-size",
                     "2", "--icp-type", "pt2pt", "--normal-threshold", "1.0"] + extra) == 0
        outs[name] = (np.load(d / "map.npz")["map_pc"], json.load(open(d / "stats.json")),
                      read_traj_file(str(d / "odo.txt")),
                      read_traj_file(str(d / "odo_interp.txt")))
    (jmap, jstats, jodo, jint), (pmap, pstats, podo, pint) = outs["jax"], outs["port"]
    # The export: 1 000 000 … 1 200 000 µs every 30 000 µs, within the poses' limits.
    assert pint[1] == jint[1] == list(range(1_000_000, 1_200_001, 30_000))
    np.testing.assert_allclose(np.stack(pint[0]), np.stack(jint[0]), rtol=0, atol=1e-4)
    assert pmap.shape == jmap.shape == (1024, 6)
    np.testing.assert_allclose(pmap[:, :3], jmap[:, :3], rtol=0, atol=4e-4)
    np.testing.assert_allclose(np.stack(podo[0]), np.stack(jodo[0]), rtol=0, atol=1e-4)
    assert podo[1] == jodo[1] == teach_stamps
    assert sorted(pstats) == sorted(jstats) and pstats["n_frames"] == 4
    for k in jstats:
        assert abs(pstats[k] - jstats[k]) <= 1e-3, (k, pstats[k], jstats[k])
    assert pstats["trans_rmse"] < 0.08 and pstats["rot_rmse"] < 0.02


A, R = 64, 256
RES = 15.0 / R
MAP_SEQ, LOC_SEQ = "gen-map", "gen-loc"


@pytest.fixture(scope="module")
def gen_tree(tmp_path_factory, world):
    """The JAX datagen test's tree: GT CSVs and calibration, teach and repeat
    scans as shards, raw images of the repeat for the dataset."""
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("datagen")
    teach_rows = [(1_000_000 + 250_000 * i, 0.5 * i, 0.0, 0.0) for i in range(3)]
    loc_rows = [(2_000_000 + 250_000 * i, 0.1 + 0.3 * i, 0.05 * i, 0.02 * i) for i in range(4)]
    for seq, rows in ((MAP_SEQ, teach_rows), (LOC_SEQ, loc_rows)):
        d = root / "vtr_data" / seq
        (d / "applanix").mkdir(parents=True)
        (d / "calib").mkdir()
        np.savetxt(d / "calib" / "T_applanix_lidar.txt", np.eye(4))
        np.savetxt(d / "calib" / "T_radar_lidar.txt", np.eye(4))
        write_csv(d / "applanix" / "radar_poses.csv", rows)
        write_csv(d / "applanix" / "lidar_poses.csv", rows)
    write_shards(root / "scans_teach", world, [planar_T(*r[1:]) for r in teach_rows],
                 [r[0] for r in teach_rows], rng)
    write_shards(root / "scans_loc", world, [planar_T(*r[1:]) for r in loc_rows],
                 [r[0] for r in loc_rows], rng)
    (root / "vtr_data" / LOC_SEQ / "radar").mkdir()
    for t_us, *_ in loc_rows:
        np.save(root / "vtr_data" / LOC_SEQ / "radar" / f"{t_us}.npy",
                raw_image(A, R, t_us, (0.05 * rng.random((A, R))).astype(np.float32)))
    return root, loc_rows


def test_datagen_matches_jax_and_loads(gen_tree):
    root, loc_rows = gen_tree
    kw = dict(max_points=1024, max_map_pts=2048, voxel_size=0.3, batch_size=4)
    jout = root / "jax_shards"
    jindex = jgenerate_pair(str(root), MAP_SEQ, LOC_SEQ, JDatagenConfig(**kw),
                            map_scan_dir=str(root / "scans_teach"),
                            loc_scan_dir=str(root / "scans_loc"), out_dir=str(jout))
    assert cli.main(["datagen", "--data-root", str(root), "--map-seq", MAP_SEQ, "--loc-seq",
                     LOC_SEQ, "--map-scans", str(root / "scans_teach"), "--loc-scans",
                     str(root / "scans_loc"), "--max-points", "1024", "--max-map-pts", "2048",
                     "--voxel-size", "0.3", "--batch-size", "4"] + CPU) == 0
    pout = root / "vtr_results" / "radar" / MAP_SEQ / LOC_SEQ / "shards"
    pindex = json.load(open(pout / "index.json"))
    assert pindex == jindex and len(pindex["frames"]) == len(loc_rows)
    for name in pindex["frames"]:
        p, j = np.load(pout / name), np.load(jout / name)
        assert sorted(p.files) == sorted(j.files)
        for key in ("raw_pc", "filt_pc", "loc_stamp", "map_stamp"):
            np.testing.assert_array_equal(p[key], j[key])
        np.testing.assert_allclose(p["map_pc"][:, :3], j["map_pc"][:, :3], rtol=0, atol=1e-3)
        np.testing.assert_allclose(np.linalg.norm(p["map_pc"][:, 3:], axis=-1), 1.0, atol=1e-4)

    cfg = Config(model=ModelConfig(enc_channels=(4, 8), dropout=0.0, res=RES, polar_shape=(A, R),
                                   cart_pixel_width=64, cart_resolution=2 * 15.0 / 64),
                 data=DataConfig(map_sensor="radar", loc_sensor="radar", data_dir=str(root),
                                 pos_std=0.3, rot_std=0.1, max_loc_pts=1024, max_map_pts=2048))
    ds = ICPWeightDataset([(MAP_SEQ, LOC_SEQ)], cfg, "train")
    assert len(ds) == len(loc_rows)
    item = ds[0]
    assert item["loc_data"]["raw_pc"].shape == (pindex["max_loc"], 3)
    assert item["map_data"]["pc"].shape == (pindex["max_map"], 6)
    assert np.isfinite(item["transforms"]["T_ml_gt"]).all()


def write_lidar_frames(d, world, stamps):
    """Boreas lidar frames: float32 (N, 6) binaries."""
    d.mkdir(parents=True, exist_ok=True)
    for st in stamps:
        np.concatenate([world, np.zeros_like(world)], 1).astype(np.float32).tofile(
            d / f"{st}.bin")


@pytest.mark.parametrize("side", ["map", "loc"])
def test_datagen_refuses_lidar_frames_for_a_radar_sensor(gen_tree, tmp_path, world, side):
    """A directory of .bin lidar frames given as the radar teach or repeat
    scans raises, naming the directory and the sensor, before any shard is
    written (the JAX package reads .bin for sensor == "lidar" only)."""
    root, loc_rows = gen_tree
    bins = tmp_path / "bins"
    write_lidar_frames(bins, world, [r[0] for r in loc_rows])
    scans = {"map": str(root / "scans_teach"), "loc": str(root / "scans_loc"), side: str(bins)}
    with pytest.raises(ValueError, match=re.escape(f"{bins}: lidar frames (*.bin) found but "
                                                   "sensor=radar")):
        cli.main(["datagen", "--data-root", str(root), "--map-seq", MAP_SEQ, "--loc-seq",
                  LOC_SEQ, "--map-scans", scans["map"], "--loc-scans", scans["loc"],
                  "--max-points", "256", "--max-map-pts", "2048"] + CPU)


def test_datagen_refuses_raw_scans_for_a_lidar_sensor(gen_tree, tmp_path):
    """The other direction: raw Navtech scans given as lidar frames raise,
    naming the directory and the sensor."""
    root, _ = gen_tree
    scans = str(root / "vtr_data" / LOC_SEQ / "radar")
    with pytest.raises(ValueError, match=re.escape(f"{scans}: raw Navtech scans found but "
                                                   "sensor=lidar")):
        cli.main(["datagen", "--data-root", str(root), "--map-seq", MAP_SEQ, "--loc-seq",
                  LOC_SEQ, "--map-scans", scans, "--map-sensor", "lidar", "--loc-sensor",
                  "radar", "--max-points", "256"] + CPU)


def test_localize_with_checkpoint_chain_and_gt_priors(tmp_path, world):
    """--checkpoint (a port Trainer.save and config.json) with --init-chain,
    then with --init-gt: the trajectories equal the library calls' on the
    same inputs."""
    reps = [(0.2 * i, 0.04 * i, 0.02 * i) for i in range(4)]
    stamps = [3_000_000 + 100_000 * i for i in range(4)]
    raw = tmp_path / "raw"
    write_raw_scans(raw, world, [planar_T(*r) for r in reps], stamps)
    np.savez_compressed(tmp_path / "map.npz", map_pc=world)
    write_csv(tmp_path / "loc_gt.csv", [(t, *r) for t, r in zip(stamps, reps)])
    ck = tmp_path / "run"
    cfg = Config(model=ModelConfig(enc_channels=(4, 8), dropout=0.0, res=15.0 / 512,
                                   polar_shape=(64, 512), cart_pixel_width=64,
                                   cart_resolution=0.5),
                 train=TrainConfig(checkpoint_dir=str(ck)))
    trainer = Trainer(cfg, "cpu")
    trainer.save(trainer.init_state(seed=3), "best_policy")
    with open(ck / "config.json", "w") as f:
        json.dump(dataclasses.asdict(cfg), f)

    common = ["--scans", str(raw), "--map", str(tmp_path / "map.npz"), "--checkpoint", str(ck),
              "--max-points", "256", "--batch-size", "2", "--icp-type", "pt2pt",
              "--normal-threshold", "1.0", "--det", "width=21", "--det", "guard=2",
              "--det", "maxr=15.0"] + CPU
    loc_cfg = pipeline.LocalizationConfig(
        detector_kwargs=(("width", 21), ("guard", 2), ("maxr", 15.0)), max_points=256,
        icp_type="pt2pt", normal_threshold=1.0)
    frames = cli._load_radar_frames([str(raw / f"{s}.npy") for s in stamps])
    params = load_policy_variables(str(ck))
    map_t = torch.from_numpy(np.concatenate([world, np.zeros_like(world)], -1))

    assert cli.main(["localize", *common, "--out-traj", str(tmp_path / "chain.txt"),
                     "--init-chain"]) == 0
    want = pipeline.localize_sequence_tracked(frames, map_t, loc_cfg,
                                              weight_policy=trainer.policy,
                                              policy_variables=params)
    rows, times = read_traj_file(str(tmp_path / "chain.txt"))
    assert times == stamps
    np.testing.assert_allclose(np.stack(rows)[:, :3], se3_inv(want["T"]).numpy()[:, :3],
                               rtol=0, atol=1e-6)

    assert cli.main(["localize", *common, "--out-traj", str(tmp_path / "gt.txt"), "--init-gt",
                     "--loc-gt", str(tmp_path / "loc_gt.csv"), "--init-pos-std", "0.2"]) == 0
    args = argparse.Namespace(
        loc_gt=str(tmp_path / "loc_gt.csv"), init_seed=99, init_pos_std=0.2, init_rot_std=0.0)
    T_inits = cli._gt_inits(args, stamps)
    want = pipeline.localize_sequence(frames, map_t, loc_cfg, T_inits=T_inits, batch_size=2,
                                      weight_policy=trainer.policy, policy_variables=params)
    rows, _ = read_traj_file(str(tmp_path / "gt.txt"))
    np.testing.assert_allclose(np.stack(rows)[:, :3], se3_inv(want["T"]).numpy()[:, :3],
                               rtol=0, atol=1e-6)


def test_load_radar_frames_epoch_times_survive_f32(tmp_path):
    """Epoch-µs stamps (~1.7e15 µs) are taken relative to the scan before the
    float32 cast: 250 µs azimuth steps survive."""
    base_us = 1_700_000_000_000_000
    img = raw_image(16, 64, base_us, np.zeros((16, 64), np.float32), az_step_us=250)
    np.save(tmp_path / f"{base_us}.npy", img)
    azt = cli._load_radar_frames([str(tmp_path / f"{base_us}.npy")])["az_times"][0]
    np.testing.assert_allclose(np.diff(azt), 250_000.0, rtol=0, atol=0.5)
    assert azt[0] == 0.0
    np.testing.assert_array_equal(
        azt, jcli._load_radar_frames([str(tmp_path / f"{base_us}.npy")])["az_times"][0])


def test_load_radar_frames_normalizes_fft_scale(tmp_path):
    """The loader divides the u8 power by 255: the detector's [0, 1]-scale
    thresholds then fire about once per azimuth over the whole sweep."""
    rng = np.random.default_rng(0)
    fft = 0.05 * rng.random((64, 256)) ** 2
    fft[np.arange(64), (64 + (np.arange(64) * 3) % 128).astype(int)] = 0.9
    np.save(tmp_path / "1000000.npy", raw_image(64, 256, 0, fft))
    frames = cli._load_radar_frames([str(tmp_path / "1000000.npy")])
    assert 0.85 <= float(frames["fft"].max()) <= 1.0
    np.testing.assert_array_equal(
        frames["fft"], jcli._load_radar_frames([str(tmp_path / "1000000.npy")])["fft"])
    cfg = pipeline.LocalizationConfig(max_points=256, radar_resolution=0.1)
    clouds = cli._extract_clouds(frames, cfg, 1, "cpu")[0].numpy()
    valid = (clouds[:, 0] != 0) | (clouds[:, 1] != 0)
    assert 0 < valid.sum() <= 3 * 64
    ang = np.mod(np.arctan2(clouds[valid, 1], clouds[valid, 0]), 2 * np.pi)
    assert ang.max() - ang.min() > 4.0
    want = np.asarray(jcli._extract_clouds(frames, cfg, 1))[0]
    np.testing.assert_allclose(clouds, want, rtol=0, atol=1e-5)


def test_teach_trajectory_export_at_epoch_stamps(tmp_path, world):
    """At Boreas's epoch stamps (~1.6e15 µs) JAX's float32 seconds put every
    knot on one time (a 128 s ulp); the port's export at epoch stamps equals
    its export at the same stamps less the first."""
    poses = [planar_T(0.2 * i, 0.01 * i, 0.01 * i) for i in range(3)]
    epoch = 1606417230036848
    out = {}
    for name, t0 in (("small", 0), ("epoch", epoch)):
        stamps = [t0 + 100_000 * i for i in range(3)]
        write_shards(tmp_path / name, world, poses, stamps, np.random.default_rng(5))
        assert cli.main(["teach", "--scans", str(tmp_path / name), "--out-map",
                         str(tmp_path / f"{name}.npz"), "--out-traj", str(tmp_path / f"{name}.txt"),
                         "--max-points", "1024", "--max-map-pts", "1024", "--interp-period-us",
                         "25000"] + CPU) == 0
        out[name] = read_traj_file(str(tmp_path / f"{name}_interp.txt"))
    assert out["epoch"][1] == [epoch + s for s in out["small"][1]]
    assert len(out["small"][1]) == 9
    np.testing.assert_array_equal(np.stack(out["epoch"][0]), np.stack(out["small"][0]))
    knots = np.asarray([epoch + 100_000 * i for i in range(3)], np.float64)
    assert len(set(knots.astype(np.float32) * np.float32(1e-6))) == 1  # JAX's cast


def test_cli_refusals(tmp_path, world):
    write_shards(tmp_path / "s", world, [np.eye(4)], [1], np.random.default_rng(6))
    np.savez_compressed(tmp_path / "bad.npz", map_pc=world)  # no normals
    loc = ["localize", "--scans", str(tmp_path / "s"), "--out-traj", str(tmp_path / "t.txt")]
    with pytest.raises(SystemExit, match="normals"):
        cli.main(loc + ["--map", str(tmp_path / "bad.npz")] + CPU)
    with pytest.raises(SystemExit, match="loc-gt"):
        cli.main(loc + ["--map", str(tmp_path / "bad.npz"), "--icp-type", "pt2pt",
                        "--init-gt"] + CPU)
    with pytest.raises(SystemExit, match="raw radar"):
        cli.main(loc + ["--map", str(tmp_path / "bad.npz"), "--icp-type", "pt2pt",
                        "--checkpoint", str(tmp_path)] + CPU)
    # The trajectory export needs the trajectory file, as the JAX CLI's does.
    assert cli.main(["teach", "--scans", str(tmp_path / "s"), "--out-map",
                     str(tmp_path / "m.npz"), "--interp-period-us", "50000"] + CPU) == 2
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(loc + ["--map", str(tmp_path / "bad.npz"), "--icp-type", "pt2pt"])
