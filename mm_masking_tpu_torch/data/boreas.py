"""Boreas dataset access: Applanix ground-truth pose CSVs + sensor calibration.

A copy of ``mm_masking_tpu.data.boreas`` (numpy and the standard library
only), so that the port imports nothing of the JAX package.

Thin, dependency-free port of the `pyboreas` surface the reference consumes
(`mm_masking/icp_weight_dataset.py:6,13-18,101-102,117-119`):
``read_traj_file_gt2`` (per-sensor GT pose CSVs), ``get_closest_index``,
``get_inverse_tf``, and the `calib/T_applanix_lidar.txt` / `T_radar_lidar.txt`
calibration matrices.

CSV layout (Boreas `applanix/<sensor>_poses.csv`): a header row, then
``GPSTime[s], easting, northing, altitude, vel_e, vel_n, vel_u, roll, pitch,
heading, ...`` — pose rows build ``T_enu_sensor`` with the z-y-x (heading,
pitch, roll) Euler convention. ``dim=2`` zeroes altitude/roll/pitch, matching
the planar localization setting the reference trains in.
"""
from __future__ import annotations

import os.path as osp

import numpy as np

YFWD2XFWD = np.array(
    [[0, 1, 0, 0], [-1, 0, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], dtype=np.float64
)


def get_inverse_tf(T: np.ndarray) -> np.ndarray:
    """Closed-form rigid-transform inverse."""
    T_inv = np.eye(4, dtype=T.dtype)
    T_inv[:3, :3] = T[:3, :3].T
    T_inv[:3, 3] = -T[:3, :3].T @ T[:3, 3]
    return T_inv


def get_closest_index(query: float, targets) -> int:
    """Index of the element of ``targets`` closest to ``query``."""
    targets = np.asarray(targets, dtype=np.float64)
    return int(np.argmin(np.abs(targets - float(query))))


def yawPitchRollToRot(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """C_enu_sensor = R_z(yaw) @ R_y(pitch) @ R_x(roll)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def rotToYawPitchRoll(C: np.ndarray) -> tuple[float, float, float]:
    """Inverse of :func:`yawPitchRollToRot` (|pitch| < pi/2 branch)."""
    pitch = -np.arcsin(np.clip(C[2, 0], -1.0, 1.0))
    yaw = np.arctan2(C[1, 0], C[0, 0])
    roll = np.arctan2(C[2, 1], C[2, 2])
    return float(yaw), float(pitch), float(roll)


def read_traj_file_gt2(path: str, dim: int = 2):
    """GT poses from an Applanix sensor-pose CSV.

    Returns (poses: list of (4, 4) float64 ``T_enu_sensor``, times: list of int
    microsecond timestamps). ``dim=2`` flattens to the plane (altitude, roll,
    pitch zeroed) as the reference's planar GT does.
    """
    poses, times = [], []
    with open(path) as f:
        header = f.readline()  # noqa: F841 — skipped
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 10:
                continue
            t_sec = float(parts[0])
            x, y, z = float(parts[1]), float(parts[2]), float(parts[3])
            roll, pitch, heading = (
                float(parts[7]),
                float(parts[8]),
                float(parts[9]),
            )
            if dim == 2:
                z, roll, pitch = 0.0, 0.0, 0.0
            T = np.eye(4)
            T[:3, :3] = yawPitchRollToRot(heading, pitch, roll)
            T[:3, 3] = [x, y, z]
            poses.append(T)
            times.append(int(round(t_sec * 1e6)))
    return poses, times


def load_calib(seq_dir: str, map_sensor: str = "lidar") -> np.ndarray:
    """``T_map_sensor_robot`` for a sequence (reference
    `icp_weight_dataset.py:116-124`): the robot frame is x-forward applanix."""
    T_applanix_lidar = np.loadtxt(osp.join(seq_dir, "calib", "T_applanix_lidar.txt"))
    if map_sensor == "radar":
        T_radar_lidar = np.loadtxt(osp.join(seq_dir, "calib", "T_radar_lidar.txt"))
        T_robot_map_sensor = YFWD2XFWD @ T_applanix_lidar @ get_inverse_tf(
            T_radar_lidar
        )
    elif map_sensor == "lidar":
        T_robot_map_sensor = YFWD2XFWD @ T_applanix_lidar
    else:
        raise ValueError(map_sensor)
    return get_inverse_tf(T_robot_map_sensor)


def load_pc_from_file(file_path: str) -> np.ndarray:
    """float32 binary → (N, 6) array (x, y, z, nx, ny, nz).

    API parity with reference `radar_utils.load_pc_from_file`
    (`mm_masking/radar_utils.py:10-18`), minus the torch
    device plumbing.
    """
    pc = np.fromfile(file_path, dtype=np.float32)
    return pc.reshape(len(pc) // 6, 6)


def dump_pc_to_file(pc: np.ndarray, file_path: str) -> None:
    """(N, >=3) cloud → packed float32 .bin (pad normals with zeros if absent).

    Replaces `utils/extract_pointcloud.py`'s per-timestamp dump format.
    """
    pc = np.asarray(pc, np.float32)
    if pc.shape[1] < 6:
        pc = np.concatenate(
            [pc, np.zeros((pc.shape[0], 6 - pc.shape[1]), np.float32)], axis=1
        )
    pc[:, :6].astype(np.float32).tofile(file_path)
