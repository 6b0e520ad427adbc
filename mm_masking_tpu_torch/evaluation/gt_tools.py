"""Ground-truth extraction & trajectory evaluation tools (counterpart of
``mm_masking_tpu.evaluation.gt_tools``, numpy only).

One decision differs from the JAX package: the planar heading error is
``atan2(D[1,0], D[0,0])``, where the JAX package takes ``arcsin(D[1,0])``,
which folds headings beyond ±90° back (the two agree within ±90°). The
error plots (``plots_dir``) are the port's own PNGs
(:mod:`mm_masking_tpu_torch.utils.visualize`), under the JAX file names.

Replaces the reference's offline GT scripts (`utils/extract_loc_gt_v2.py`,
`extract_loc_gt.py`, `extract_odo_gt.py` — SURVEY.md §2.1): align estimated
localization trajectories with Applanix ground truth, check timestamp
consistency, emit aligned GT files, and compute per-sequence error statistics.

Trajectory file format (pyboreas `read_traj_file2` convention): one row per
frame, ``timestamp_us`` followed by the 12 row-major entries of the 3×4 top of
``T_enu_sensor``.
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from mm_masking_tpu_torch.data.boreas import (
    get_closest_index,
    get_inverse_tf,
    read_traj_file_gt2,
)
from mm_masking_tpu_torch.utils.visualize import save_loc_error_plots


def read_traj_file(path: str):
    """(poses list of (4,4), times list of int µs) from a trajectory file."""
    poses, times = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 1:
                parts = line.strip().split(",")
            if len(parts) < 13:
                continue
            times.append(int(float(parts[0])))
            T = np.eye(4)
            T[:3, :4] = np.asarray([float(x) for x in parts[1:13]]).reshape(3, 4)
            poses.append(T)
    return poses, times


def write_traj_file(path: str, poses, times) -> None:
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for T, t in zip(poses, times):
            row = " ".join(f"{v:.9f}" for v in np.asarray(T)[:3, :4].ravel())
            f.write(f"{int(t)} {row}\n")


def check_time_match(times_a, times_b, tol_us: int = 0) -> bool:
    """Reference `extract_loc_gt_v2.py:130-140`: every estimated timestamp must
    have a GT partner within tolerance."""
    times_b = np.asarray(times_b, np.int64)
    for t in times_a:
        i = get_closest_index(t, times_b)
        if abs(int(times_b[i]) - int(t)) > tol_us:
            return False
    return True


def align_gt_to_traj(traj_times, gt_poses, gt_times, tol_us: int = 1000):
    """For each trajectory timestamp, the closest-in-time GT pose.

    Returns (poses, times); raises if any match exceeds ``tol_us``.
    """
    gt_times_arr = np.asarray(gt_times, np.int64)
    out_poses, out_times = [], []
    for t in traj_times:
        i = get_closest_index(t, gt_times_arr)
        if abs(int(gt_times_arr[i]) - int(t)) > tol_us:
            raise ValueError(f"no GT within {tol_us}us of {t}")
        out_poses.append(gt_poses[i])
        out_times.append(int(gt_times_arr[i]))
    return out_poses, out_times


def relative_loc_errors(est_T_loc_map, gt_T_loc_map):
    """Planar (rot, trans) error per frame between estimated and GT relative
    localization transforms (the canonical reference metric)."""
    rots, trans = [], []
    for Te, Tg in zip(est_T_loc_map, gt_T_loc_map):
        D = Te @ get_inverse_tf(Tg)
        rots.append(abs(float(np.arctan2(D[1, 0], D[0, 0]))))
        trans.append(float(np.linalg.norm(D[:2, 3])))
    return np.asarray(rots), np.asarray(trans)


def relative_loc_error_components(est_T_loc_map, gt_T_loc_map):
    """Per-frame signed error components in the localization-sensor frame:
    (rot_signed, longitudinal (x), lateral (y)) — the decomposition
    pyboreas' `plot_loc_stats` reports per sequence (the reference's
    per-sequence eval figure, `utils/extract_loc_gt_v2.py:10`)."""
    rot, lon, lat = [], [], []
    for Te, Tg in zip(est_T_loc_map, gt_T_loc_map):
        D = Te @ get_inverse_tf(Tg)
        rot.append(float(np.arctan2(D[1, 0], D[0, 0])))
        lon.append(float(D[0, 3]))
        lat.append(float(D[1, 3]))
    return np.asarray(rot), np.asarray(lon), np.asarray(lat)


def eval_localization_run(
    est_path: str,
    map_gt_csv: str,
    loc_gt_csv: str,
    out_gt_path: str | None = None,
    tol_us: int = 1000,
    plots_dir: str | None = None,
    seq_name: str = "sequence",
    map_frame: str = "closest_time",
) -> dict:
    """End-to-end: read an estimated trajectory (`T_loc_map` per frame in the
    map-sensor frame), align GT from the Applanix CSVs, optionally write the
    aligned GT file, and return error statistics.

    Mirrors `extract_loc_gt_v2.eval_local` (`utils/extract_loc_gt_v2.py:147`).

    ``map_frame`` picks the GT's map-pose convention: ``"closest_time"``
    (per-frame closest teach row — the reference's proxy for VTR's
    per-vertex submaps, valid when the estimate is per-vertex-relative) or
    ``"first"`` (teach row 0 — the convention for runs localized against
    ONE global teach map expressed in the first keyframe's frame, which is
    what the localize CLI's `teach`-built map is; closest-in-TIME against
    such runs picks an arbitrary teach row and reports a route-length
    offset as error). ``plots_dir``: the error-over-trajectory image and CSV
    of :func:`mm_masking_tpu_torch.utils.visualize.save_loc_error_plots`
    go there, and ``stats["plots"]`` holds their paths.
    """
    est_poses, est_times = read_traj_file(est_path)
    map_gt_poses, map_gt_times = read_traj_file_gt2(map_gt_csv, dim=2)
    loc_gt_poses, loc_gt_times = read_traj_file_gt2(loc_gt_csv, dim=2)

    loc_aligned, times = align_gt_to_traj(est_times, loc_gt_poses,
                                          loc_gt_times, tol_us)
    # GT relative transform: T_loc_map = inv(T_enu_loc) @ T_enu_map(closest).
    gt_rel = []
    map_times_arr = np.asarray(map_gt_times, np.int64)
    for T_enu_loc, t in zip(loc_aligned, times):
        i = (0 if map_frame == "first"
             else get_closest_index(t, map_times_arr))
        gt_rel.append(get_inverse_tf(T_enu_loc) @ map_gt_poses[i])

    if out_gt_path is not None:
        write_traj_file(out_gt_path, gt_rel, times)

    rot, trans = relative_loc_errors(est_poses, gt_rel)
    stats = {
        "n_frames": int(len(est_poses)),
        "rot_mean": float(rot.mean()),
        "rot_rmse": float(np.sqrt((rot**2).mean())),
        "trans_mean": float(trans.mean()),
        "trans_rmse": float(np.sqrt((trans**2).mean())),
        "trans_p50": float(np.percentile(trans, 50)),
        "trans_p90": float(np.percentile(trans, 90)),
        "trans_max": float(trans.max()),
        "rot_max": float(rot.max()),
    }
    if plots_dir is not None:
        rs, lon, lat = relative_loc_error_components(est_poses, gt_rel)
        stats["plots"] = save_loc_error_plots(np.asarray(times), rs, lon, lat, plots_dir,
                                              seq_name)
    return stats


def eval_odometry_run(est_path: str, odo_gt_csv: str,
                      out_gt_path: str | None = None, tol_us: int = 1000) -> dict:
    """Odometry-frame GT evaluation (`utils/extract_odo_gt.py` capability).

    An odometry trajectory is a localization run against the sequence's own
    GT frames, so the alignment/error math is shared with
    :func:`eval_localization_run` — both the "map" and "loc" GT come from the
    same Applanix CSV.
    """
    return eval_localization_run(est_path, odo_gt_csv, odo_gt_csv,
                                 out_gt_path=out_gt_path, tol_us=tol_us)


def extract_localization_gt(
    bag_file: str,
    loc_gt_csv: str,
    map_gt_csv: str,
    out_path: str,
    topic: str = "localization_result",
    precision: float = 1e7,
) -> int:
    """v1 GT-extraction flow (`utils/extract_odo_gt.py:54-129` /
    `extract_loc_gt.py`): decode ``localization_result`` messages straight out
    of a VTR result bag (no rclpy — `data.convert.parse_localization_result`),
    join each against the Applanix GT pose dictionaries bucketed at
    ``timestamp_ns / precision``, and write rows

        <query_ts_us> <map_vertex_ts_us> <12 row-major entries of
        inv(T_enu_loc[query]) @ T_enu_map[vertex]>

    (the reference stores that product unchanged despite naming the variable
    ``T_map_test`` — reproduced as-is). Messages whose timestamp has no GT
    bucket are skipped with a warning, as the reference does. Returns the
    number of rows written.
    """
    from mm_masking_tpu_torch.data.convert import (
        Rosbag2Reader,
        parse_localization_result,
    )

    loc_poses, loc_times = read_traj_file_gt2(loc_gt_csv, dim=2)
    map_poses, map_times = read_traj_file_gt2(map_gt_csv, dim=2)
    # µs → ns → precision buckets (the reference keys frame.timestamp·1e9/1e7).
    loc_by_key = {int(t * 1000 / precision): P
                  for t, P in zip(loc_times, loc_poses)}
    map_by_key = {int(t * 1000 / precision): P
                  for t, P in zip(map_times, map_poses)}

    reader = Rosbag2Reader(bag_file)
    try:
        topic_name = next(t for t in reader.topics() if t.endswith(topic))
        messages = [parse_localization_result(blob)
                    for _, blob in reader.messages(topic_name)]
    finally:
        reader.close()

    rows = []
    for msg in messages:
        k_loc = int(msg["timestamp"] / precision)
        k_map = int(msg["vertex_timestamp"] / precision)
        if k_loc not in loc_by_key:
            print(f"WARNING: time stamp not found 1: {k_loc}")
            continue
        if k_map not in map_by_key:
            print(f"WARNING: time stamp not found 2: {k_map}")
            continue
        T = get_inverse_tf(loc_by_key[k_loc]) @ map_by_key[k_map]
        rows.append(
            [msg["timestamp"] // 1000, msg["vertex_timestamp"] // 1000]
            + [float(v) for v in T.ravel()[:12]]
        )

    os.makedirs(osp.dirname(osp.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        for row in rows:
            f.write(" ".join(str(v) for v in row) + "\n")
    return len(rows)
