"""Synthetic on-disk dataset fixtures in the exact converted layout.

A copy of ``mm_masking_tpu.data.testing`` (numpy and the standard library
only), so that the port imports nothing of the JAX package.

Writes a miniature Boreas-style tree (GT CSVs, calib, radar scans as .npy,
pose-graph shards + index) so :class:`~mm_masking_tpu_torch.data.dataset.ICPWeightDataset`
and the converter can be exercised end to end without the real 5 GB sequences.
"""
from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from mm_masking_tpu_torch.data.boreas import YFWD2XFWD, get_inverse_tf, yawPitchRollToRot


def write_synthetic_dataset(
    root: str,
    map_seq: str = "synth-map",
    loc_seq: str = "synth-loc",
    n_frames: int = 4,
    n_scan: int = 200,
    n_map: int = 400,
    polar_shape: tuple[int, int] = (64, 256),
    sensor_dir: str = "radar_lidar",
    seed: int = 0,
) -> dict:
    """Create the full directory tree; returns info incl. frame stamps."""
    rng = np.random.default_rng(seed)
    A, R = polar_shape

    dataset_dir = osp.join(root, "vtr_data")
    shard_dir = osp.join(root, "vtr_results", sensor_dir, map_seq, loc_seq, "shards")
    os.makedirs(shard_dir, exist_ok=True)

    # Calibration: identity lidar↔applanix for simplicity.
    for seq in (map_seq, loc_seq):
        os.makedirs(osp.join(dataset_dir, seq, "calib"), exist_ok=True)
        os.makedirs(osp.join(dataset_dir, seq, "applanix"), exist_ok=True)
        np.savetxt(osp.join(dataset_dir, seq, "calib", "T_applanix_lidar.txt"),
                   np.eye(4))
        np.savetxt(osp.join(dataset_dir, seq, "calib", "T_radar_lidar.txt"),
                   np.eye(4))
    os.makedirs(osp.join(dataset_dir, loc_seq, "radar"), exist_ok=True)

    # Trajectories: loc sensor drives along x with slow yaw; map pose fixed at
    # a nearby offset. Timestamps in microseconds.
    loc_stamps = [1_000_000 + 100_000 * i for i in range(n_frames)]
    map_stamp = 500_000

    def write_poses(path, rows):
        with open(path, "w") as f:
            f.write("GPSTime,easting,northing,altitude,vel_e,vel_n,vel_u,"
                    "roll,pitch,heading\n")
            for t_us, x, y, h in rows:
                f.write(f"{t_us/1e6:.6f},{x},{y},0.0,0,0,0,0.0,0.0,{h}\n")

    loc_rows = [
        (t, 10.0 + 0.5 * i, 5.0 + 0.2 * i, 0.05 * i)
        for i, t in enumerate(loc_stamps)
    ]
    # The loc sensor is also the "radar" and the map sensor the "lidar";
    # write both CSVs for each sequence.
    write_poses(osp.join(dataset_dir, loc_seq, "applanix", "radar_poses.csv"),
                loc_rows)
    write_poses(osp.join(dataset_dir, loc_seq, "applanix", "lidar_poses.csv"),
                loc_rows)
    map_rows = [(map_stamp, 10.0, 5.0, 0.0)]
    write_poses(osp.join(dataset_dir, map_seq, "applanix", "lidar_poses.csv"),
                map_rows)
    write_poses(osp.join(dataset_dir, map_seq, "applanix", "radar_poses.csv"),
                map_rows)

    # Map cloud in the map-sensor frame (robot frame = applanix here).
    map_pts = np.zeros((n_map, 3), np.float32)
    ranges = rng.uniform(3.0, 12.0, n_map)
    angles = rng.uniform(0, 2 * np.pi, n_map)
    map_pts[:, 0] = ranges * np.cos(angles)
    map_pts[:, 1] = ranges * np.sin(angles)
    nrm = rng.normal(size=(n_map, 3)).astype(np.float32)
    nrm[:, 2] *= 0.05
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)

    index = {"frames": [], "max_loc": n_scan, "max_map": n_map}
    for i, t_us in enumerate(loc_stamps):
        # GT transform loc_sensor <- map_sensor from the CSV trajectories.
        x, y, h = loc_rows[i][1], loc_rows[i][2], loc_rows[i][3]
        T_enu_loc = np.eye(4)
        T_enu_loc[:3, :3] = yawPitchRollToRot(h, 0, 0)
        T_enu_loc[:3, 3] = [x, y, 0]
        T_enu_map = np.eye(4)
        T_enu_map[:3, 3] = [10.0, 5.0, 0]
        T_gt = get_inverse_tf(T_enu_loc) @ T_enu_map

        # The dataset maps shard map points robot→sensor via calib (identity
        # here modulo yfwd2xfwd) and then into the loc frame with T_gt; build
        # the scan as a subsample of the transformed map so ICP's optimum is
        # the identity (gt_eye convention).
        T_msr = get_inverse_tf(YFWD2XFWD @ np.eye(4))  # T_map_sensor_robot
        pts_sensor = map_pts @ np.asarray(T_msr[:3, :3].T, np.float32)
        pts_loc = pts_sensor @ np.asarray(T_gt[:3, :3].T, np.float32) + np.asarray(
            T_gt[:3, 3], np.float32
        )
        sel = rng.permutation(n_map)[:n_scan]
        scan = pts_loc[sel] + rng.normal(0, 0.01, (n_scan, 3)).astype(np.float32)
        scan[:, 2] = 0.0

        np.savez_compressed(
            osp.join(shard_dir, f"frame_{t_us}.npz"),
            raw_pc=scan,
            filt_pc=scan,
            map_pc=np.concatenate([map_pts, nrm], axis=1),
            loc_stamp=np.int64(t_us),
            map_stamp=np.int64(map_stamp),
        )
        index["frames"].append(f"frame_{t_us}.npz")

        # Radar scan: random speckle + bright returns at the scan points.
        fft = (0.05 * rng.random((A, R)) ** 2).astype(np.float32)
        r_pts = np.linalg.norm(scan[:, :2], axis=-1)
        a_pts = np.mod(np.arctan2(scan[:, 1], scan[:, 0]), 2 * np.pi)
        res = 15.0 / R
        a_idx = np.clip((a_pts / (2 * np.pi / A)).astype(int), 0, A - 1)
        r_idx = np.clip((r_pts / res).astype(int), 0, R - 2)
        fft[a_idx, r_idx] = rng.uniform(0.6, 1.0, n_scan).astype(np.float32)

        # Store as a raw Navtech byte image so load_radar's decode runs.
        raw_img = np.zeros((A, 11 + R), np.uint8)
        ts = (np.arange(A, dtype=np.int64) * 400 + t_us * 1000)
        raw_img[:, :8] = np.frombuffer(ts.tobytes(), np.uint8).reshape(A, 8)
        enc = (np.arange(A, dtype=np.float64) / A * 5600).astype(np.uint16)
        raw_img[:, 8:10] = np.frombuffer(enc.tobytes(), np.uint8).reshape(A, 2)
        raw_img[:, 11:] = np.clip(fft * 255, 0, 255).astype(np.uint8)
        np.save(osp.join(dataset_dir, loc_seq, "radar", f"{t_us}.npy"), raw_img)

    with open(osp.join(shard_dir, "index.json"), "w") as f:
        json.dump(index, f)
    return {
        "map_seq": map_seq,
        "loc_seq": loc_seq,
        "loc_stamps": loc_stamps,
        "polar_res": 15.0 / R,
        "polar_shape": polar_shape,
    }
