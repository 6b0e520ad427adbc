"""Training-data generation: raw scans → teach map → converter shards.

Counterpart of ``mm_masking_tpu.localization.datagen``:

    teach scans ──detector──► clouds ──TeachPass odometry──► map (+normals)
    repeat scans ─detector──► raw/filt clouds ─closest teach keyframe──►
        frame_<t>.npz shards {raw_pc, filt_pc, map_pc, loc_stamp, map_stamp}
        + index.json, the ``data/convert.py`` layout that ICPWeightDataset
        loads.

As in the JAX package: one global teach map, a voxel mean over every teach
frame's world points (numpy, float64), with normals from
:func:`estimate_normals`, expressed per shard in the chosen keyframe's robot
frame; the closest keyframe by ground-truth position; ``filt_pc`` equal to
``raw_pc``; odometry drift enters the map as it does in VTR.
"""
from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp

import numpy as np
import torch

from mm_masking_tpu_torch.data.boreas import get_inverse_tf, load_calib, read_traj_file_gt2
from mm_masking_tpu_torch.dicp import TARGET_PAD_VAL
from mm_masking_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DatagenConfig:
    """The data-generation settings; fields and defaults as in the JAX package."""

    # sensor pair → output branch: radar/radar → "radar", lidar/radar →
    # "radar_lidar", lidar/lidar → "lidar"
    map_sensor: str = "radar"
    loc_sensor: str = "radar"
    detector: str = "modified_cacfar"
    detector_kwargs: tuple = ()
    max_points: int = 1024
    batch_size: int = 8
    radar_resolution: float = 0.0596
    max_map_pts: int = 16384
    voxel_size: float = 0.5
    odometry_iterations: int = 30
    limit: int = -1  # cap frames per sequence (<= 0: all)


def _sensor_dir(cfg: DatagenConfig) -> str:
    pairs = {("lidar", "radar"): "radar_lidar", ("radar", "radar"): "radar",
             ("lidar", "lidar"): "lidar"}
    if (cfg.map_sensor, cfg.loc_sensor) not in pairs:
        raise ValueError(f"unsupported sensor pair {cfg.map_sensor}/{cfg.loc_sensor}")
    return pairs[cfg.map_sensor, cfg.loc_sensor]


def _load_clouds_any(scan_dir: str, cfg: DatagenConfig, sensor: str, device):
    """(stamps, clouds (F, N, 3) numpy) from raw Navtech scans (detector
    extraction on ``device``), lidar .bin frames or converter shards."""
    from mm_masking_tpu_torch.localization.__main__ import (
        _clouds_for,
        _extract_clouds,
        _load_radar_frames,
        _scan_files,
        _stamp_of,
    )
    from mm_masking_tpu_torch.localization.pipeline import LocalizationConfig

    bins = sorted(f for f in os.listdir(scan_dir) if f.endswith(".bin"))
    if sensor == "lidar" and bins:
        kind, paths = "lidar", [osp.join(scan_dir, f) for f in bins]
    else:
        kind, paths = _scan_files(scan_dir)
    if kind == "lidar" and sensor != "lidar":
        raise ValueError(f"{scan_dir}: lidar frames (*.bin) found but sensor={sensor}")
    if cfg.limit > 0:
        paths = paths[: cfg.limit]
    stamps = [_stamp_of(p) for p in paths]
    if kind == "radar":
        if sensor != "radar":
            raise ValueError(f"{scan_dir}: raw Navtech scans found but sensor={sensor}")
        loc_cfg = LocalizationConfig(detector=cfg.detector,
                                     detector_kwargs=tuple(cfg.detector_kwargs),
                                     max_points=cfg.max_points,
                                     radar_resolution=cfg.radar_resolution)
        clouds = _extract_clouds(_load_radar_frames(paths), loc_cfg, cfg.batch_size, device)
        return stamps, clouds.cpu().numpy()
    return stamps, _clouds_for(kind, paths, cfg.max_points)


def generate_pair(root: str, map_seq: str, loc_seq: str, cfg: DatagenConfig = DatagenConfig(),
                  map_scan_dir: str | None = None, loc_scan_dir: str | None = None,
                  out_dir: str | None = None, device: str | torch.device = "cuda") -> dict:
    """Generate training shards for one (teach, repeat) sequence pair on
    ``device``.

    Reads the Boreas-style tree the dataset reads
    (``<root>/vtr_data/<seq>/applanix/<sensor>_poses.csv``, ``calib/``), the
    scans from ``<root>/vtr_data/<seq>/<sensor>/`` unless scan directories
    are given; writes shards and index.json under
    ``<root>/vtr_results/<sensor_dir>/<map_seq>/<loc_seq>/shards/`` and
    returns the index.
    """
    from mm_masking_tpu_torch.data.convert import _write_shard
    from mm_masking_tpu_torch.localization.odometry import OdometryConfig, TeachPass
    from mm_masking_tpu_torch.ops.preprocessing import estimate_normals

    device = resolve_device(str(device))
    dataset_dir = osp.join(root, "vtr_data")
    map_scan_dir = map_scan_dir or osp.join(dataset_dir, map_seq, cfg.map_sensor)
    loc_scan_dir = loc_scan_dir or osp.join(dataset_dir, loc_seq, cfg.loc_sensor)
    out_dir = out_dir or osp.join(root, "vtr_results", _sensor_dir(cfg), map_seq, loc_seq,
                                  "shards")
    os.makedirs(out_dir, exist_ok=True)

    # --- teach: odometry over the map sequence ---------------------------
    map_stamps, map_clouds = _load_clouds_any(map_scan_dir, cfg, cfg.map_sensor, device)
    teach = TeachPass(OdometryConfig(max_map_pts=cfg.max_map_pts, voxel_size=cfg.voxel_size,
                                     max_iterations=cfg.odometry_iterations))
    clouds_dev = torch.as_tensor(map_clouds, device=device)
    for i in range(map_clouds.shape[0]):
        teach.process(clouds_dev[i], stamp_us=map_stamps[i])
    T_world_sensor = np.stack(teach.trajectory)  # (K, 4, 4), world = frame 0

    # The global map: every frame's world points (not the odometry's sliding
    # local buffer), one exact voxel mean over the route.
    world_pts = []
    for c, T in zip(map_clouds, T_world_sensor):
        valid = ~((c[:, 0] == 0.0) & (c[:, 1] == 0.0))
        world_pts.append(c[valid] @ T[:3, :3].T + T[:3, 3])
    allw = np.concatenate(world_pts).astype(np.float64)
    cells = np.floor(allw / cfg.voxel_size).astype(np.int64)
    _, inv, counts = np.unique(cells, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], 3))
    np.add.at(sums, inv.reshape(-1), allw)
    map_world = (sums / counts[:, None]).astype(np.float32)
    if map_world.shape[0] > cfg.max_map_pts:
        print(f"datagen: global map {map_world.shape[0]} voxels > cap {cfg.max_map_pts} — even "
              "subsample (raise max_map_pts to keep the full route)")
        sel = np.random.default_rng(0).permutation(map_world.shape[0])[: cfg.max_map_pts]
        map_world = map_world[np.sort(sel)]
    pad_n = int(cfg.max_map_pts) - map_world.shape[0]
    padded = np.concatenate([map_world, np.full((pad_n, 3), TARGET_PAD_VAL, np.float32)]
                            ) if pad_n > 0 else map_world
    with torch.no_grad():
        nrm, _ = estimate_normals(torch.as_tensor(padded, device=device)[None],
                                  k=teach.cfg.normals_k)
    nrm = nrm[0].cpu().numpy()
    map_world = np.concatenate([map_world, nrm[: map_world.shape[0]]], axis=-1)

    # --- GT and calibration (the files the dataset reads) -----------------
    gt_map_poses, gt_map_times = read_traj_file_gt2(
        osp.join(dataset_dir, map_seq, "applanix", cfg.map_sensor + "_poses.csv"), dim=2)
    gt_loc_poses, gt_loc_times = read_traj_file_gt2(
        osp.join(dataset_dir, loc_seq, "applanix", cfg.loc_sensor + "_poses.csv"), dim=2)
    gt_map_times, gt_loc_times = list(gt_map_times), list(gt_loc_times)
    keyframe_rows = []
    for k, st in enumerate(map_stamps):
        if st not in gt_map_times:
            raise ValueError(f"teach stamp {st} missing from {map_seq} GT CSV — datagen needs "
                             "a GT row per teach scan (the dataset asserts map_stamp equality "
                             "at load time)")
        keyframe_rows.append((k, st, gt_map_poses[gt_map_times.index(st)]))
    T_msr_inv = np.asarray(get_inverse_tf(np.asarray(
        load_calib(osp.join(dataset_dir, map_seq), cfg.map_sensor))))

    # --- repeat: raw/filt clouds and the map in the keyframe's frame ------
    loc_stamps, loc_clouds = _load_clouds_any(loc_scan_dir, cfg, cfg.loc_sensor, device)
    index = {"frames": [], "max_loc": 0, "max_map": 0}
    kf_xy = np.stack([p[:2, 3] for _, _, p in keyframe_rows])
    for i, stamp in enumerate(loc_stamps):
        if stamp not in gt_loc_times:
            print(f"datagen: skipping frame {stamp} — no GT row")
            continue
        T_enu_loc = gt_loc_poses[gt_loc_times.index(stamp)]
        k, map_stamp, _ = keyframe_rows[
            int(np.argmin(np.linalg.norm(kf_xy - T_enu_loc[:2, 3], axis=-1)))]
        # world → keyframe sensor frame → keyframe robot frame
        T_sw = get_inverse_tf(T_world_sensor[k])
        R = (T_msr_inv[:3, :3] @ T_sw[:3, :3]).astype(np.float32)
        t = (T_msr_inv[:3, :3] @ T_sw[:3, 3] + T_msr_inv[:3, 3]).astype(np.float32)
        pts = map_world[:, :3] @ R.T + t
        nrm = map_world[:, 3:6] @ R.T
        scan = loc_clouds[i]
        scan = scan[~((scan[:, 0] == 0.0) & (scan[:, 1] == 0.0))].astype(np.float32)
        _write_shard(out_dir, index, {
            "raw_pc": scan, "filt_pc": scan, "loc_stamp": np.int64(stamp),
            "map_pc": np.concatenate([pts, nrm], axis=-1).astype(np.float32),
            "map_stamp": np.int64(map_stamp)})

    with open(osp.join(out_dir, "index.json"), "w") as f:
        json.dump(index, f)
    print(f"datagen: {len(index['frames'])} shards ({map_clouds.shape[0]} teach frames, map "
          f"{map_world.shape[0]} pts) → {out_dir}")
    return index
