"""The localization CLI: teach, datagen and localize.

Counterpart of ``python -m mm_masking_tpu.localization``, with the same
commands, options, files and printed stats:

  # Teach pass: build a map from a scan directory.
  python -m mm_masking_tpu_torch.localization teach \\
      --scans <dir> --out-map map.npz [--out-traj odo_traj.txt \\
      [--interp-period-us 50000]]

  # Teach + repeat → training shards that ICPWeightDataset loads.
  python -m mm_masking_tpu_torch.localization datagen \\
      --data-root <root> --map-seq <seq> --loc-seq <seq> [...]

  # Repeat pass: localize a scan directory against a map, write the
  # trajectory and, with GT CSVs, the error stats.
  python -m mm_masking_tpu_torch.localization localize \\
      --scans <dir> --map map.npz --out-traj traj.txt \\
      [--checkpoint <run dir>] [--init-gt | --init-chain] \\
      [--map-gt <applanix csv> --loc-gt <applanix csv> --stats stats.json]

Scan directories hold raw Navtech scans (``<stamp>.png`` / ``<stamp>.npy``),
lidar frames (``<stamp>.bin``) or converter shards (``frame_<stamp>.npz``
with ``filt_pc`` clouds); the kind is read from the files present. Every
command runs on the card (``--device cuda``, the default, raises without
one); ``--device cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import os
import sys

import numpy as np
import torch

from mm_masking_tpu_torch.device import resolve_device


def _scan_files(scan_dir: str) -> tuple[str, list[str]]:
    """The directory's kind ('radar' | 'lidar' | 'shards') and its sorted files."""
    files = sorted(os.listdir(scan_dir))
    shards = [f for f in files if f.startswith("frame_") and f.endswith(".npz")]
    if shards:
        return "shards", [osp.join(scan_dir, f) for f in shards]
    bins = [f for f in files if f.endswith(".bin")]
    if bins:
        return "lidar", [osp.join(scan_dir, f) for f in bins]
    scans = [f for f in files if f.endswith((".png", ".npy"))]
    if not scans:
        raise SystemExit(f"{scan_dir}: no radar scans (*.png/*.npy), lidar frames (*.bin), or "
                         f"converter shards (frame_*.npz) found")
    return "radar", [osp.join(scan_dir, f) for f in scans]


def _stamp_of(path: str) -> int:
    return int(osp.splitext(osp.basename(path))[0].removeprefix("frame_"))


def _parse_det_kwargs(items) -> tuple:
    """--det KEY=VALUE list → detector kwargs (ints stay ints: window widths)."""
    out = []
    for it in items or ():
        k, sep, v = it.partition("=")
        if not sep:
            raise SystemExit(f"--det expects KEY=VALUE, got {it!r}")
        try:
            val = int(v)
        except ValueError:
            try:
                val = float(v)
            except ValueError:
                raise SystemExit(f"--det {k}: numeric value expected, got {v!r}") from None
        out.append((k, val))
    return tuple(out)


def _load_radar_frames(paths: list[str]) -> dict[str, np.ndarray]:
    """Decode raw Navtech scans → stacked {'fft', 'azimuths', 'az_times'}
    (numpy, float32).

    The FFT plane is divided by 255 here: the decoder keeps it uint8 for the
    training loader, and every consumer here (detectors with [0, 1]-scale
    thresholds, ``mask_for_scan``) expects the normalised power; at 0–255
    the CFAR fires on nearly every bin. The azimuth times are taken relative
    to each scan's first azimuth before the float32 cast: epoch
    nanoseconds (~1.7e18) are far beyond float32's resolution there, and
    every consumer works with times within a scan.
    """
    from mm_masking_tpu_torch.data.dataset import _decode_radar_file

    ffts, azs, azts = [], [], []
    for p in paths:
        fft, az, azt = _decode_radar_file(p)
        ffts.append(fft)
        azs.append(az)
        azts.append(np.asarray(azt) - np.asarray(azt).flat[0])
    return {"fft": np.stack(ffts).astype(np.float32) / 255.0,
            "azimuths": np.stack(azs).astype(np.float32),
            "az_times": np.stack(azts).astype(np.float32)}


def _load_shard_clouds(paths: list[str], max_pts: int) -> np.ndarray:
    """(F, max_pts, 3) zero-padded clouds from converter shards."""
    out = np.zeros((len(paths), max_pts, 3), np.float32)
    for i, p in enumerate(paths):
        pc = np.load(p)["filt_pc"][:max_pts]
        out[i, : pc.shape[0]] = pc[:, :3]
    return out


def _load_lidar_clouds(paths: list[str], max_pts: int) -> np.ndarray:
    """(F, max_pts, 3) clouds from lidar .bin frames, randomly subsampled to
    the cap (seed 0)."""
    from mm_masking_tpu_torch.data.boreas import load_pc_from_file

    rng = np.random.default_rng(0)
    out = np.zeros((len(paths), max_pts, 3), np.float32)
    for i, p in enumerate(paths):
        pc = load_pc_from_file(p)[:, :3]
        if pc.shape[0] > max_pts:
            pc = pc[rng.permutation(pc.shape[0])[:max_pts]]
        out[i, : pc.shape[0]] = pc
    return out


def _clouds_for(kind: str, paths: list[str], max_pts: int) -> np.ndarray:
    return (_load_lidar_clouds if kind == "lidar" else _load_shard_clouds)(paths, max_pts)


def _extract_clouds(frames: dict, cfg, batch_size: int, device) -> torch.Tensor:
    """Detector and peak extraction over stacked radar frames, in batches on
    ``device`` → (F, N, 3) on the device."""
    from mm_masking_tpu_torch.ops import extract_pc
    from mm_masking_tpu_torch.ops.detectors import detect

    F = frames["fft"].shape[0]
    outs = []
    with torch.no_grad():
        for s in range(0, F, batch_size):
            fft, az, azt = (torch.as_tensor(frames[k][s:s + batch_size], device=device)
                            for k in ("fft", "azimuths", "az_times"))
            mask = detect(cfg.detector, fft, cfg.radar_resolution, **dict(cfg.detector_kwargs))
            outs.append(extract_pc(mask, cfg.radar_resolution, az, azt,
                                   max_points=cfg.max_points, diff=False))
    return torch.cat(outs)


def cmd_teach(args) -> int:
    from mm_masking_tpu_torch.evaluation.gt_tools import write_traj_file
    from mm_masking_tpu_torch.localization.odometry import OdometryConfig, TeachPass
    from mm_masking_tpu_torch.localization.pipeline import LocalizationConfig

    device = resolve_device(args.device)
    kind, paths = _scan_files(args.scans)
    if args.limit > 0:
        paths = paths[: args.limit]
    stamps = [_stamp_of(p) for p in paths]
    loc_cfg = LocalizationConfig(detector=args.detector,
                                 detector_kwargs=_parse_det_kwargs(args.det),
                                 max_points=args.max_points)
    if kind == "radar":
        clouds = _extract_clouds(_load_radar_frames(paths), loc_cfg, args.batch_size, device)
    else:
        clouds = torch.as_tensor(_clouds_for(kind, paths, args.max_points), device=device)

    teach = TeachPass(OdometryConfig(max_map_pts=args.max_map_pts))
    for i in range(clouds.shape[0]):
        teach.process(clouds[i], stamp_us=stamps[i])
    map_pc = teach.map_with_normals()[0].cpu().numpy()

    np.savez_compressed(args.out_map, map_pc=map_pc)
    print(f"teach: {clouds.shape[0]} frames, {teach.n_keyframes} keyframes → {args.out_map}")
    if args.out_traj:
        write_traj_file(args.out_traj, teach.trajectory, stamps)
        print(f"teach: odometry trajectory → {args.out_traj}")
    if args.interp_period_us > 0:
        # The trajectory's WNOA Gauss-process query at a fixed period. Times
        # are seconds since the first stamp, taken in int64 before the float32
        # cast: epoch microseconds in float32 seconds have a 128 s ulp.
        if not args.out_traj:
            print("teach: --interp-period-us requires --out-traj", file=sys.stderr)
            return 2
        from mm_masking_tpu_torch.geom import interpolate_trajectory
        from mm_masking_tpu_torch.localization.odometry import seconds_since

        q_us = np.arange(stamps[0], stamps[-1] + 1, args.interp_period_us, dtype=np.int64)
        Ts = torch.stack(teach._poses)
        Tq, _ = interpolate_trajectory(Ts, seconds_since(stamps, stamps[0]).to(device),
                                       seconds_since(q_us, stamps[0]).to(device))
        root, ext = os.path.splitext(args.out_traj)
        interp_path = f"{root}_interp{ext or '.txt'}"
        write_traj_file(interp_path, list(Tq.cpu().numpy()), list(q_us))
        print(f"teach: GP-interpolated trajectory ({len(q_us)} poses @ "
              f"{args.interp_period_us} us) → {interp_path}")
    return 0


def _load_map(path: str) -> np.ndarray:
    if path.endswith(".npz"):
        z = np.load(path)
        return z["map_pc" if "map_pc" in z else list(z.keys())[0]]
    from mm_masking_tpu_torch.data.boreas import load_pc_from_file

    return load_pc_from_file(path)


def cmd_datagen(args) -> int:
    from mm_masking_tpu_torch.localization.datagen import DatagenConfig, generate_pair

    device = resolve_device(args.device)
    cfg = DatagenConfig(map_sensor=args.map_sensor, loc_sensor=args.loc_sensor,
                        detector=args.detector, detector_kwargs=_parse_det_kwargs(args.det),
                        max_points=args.max_points, batch_size=args.batch_size,
                        max_map_pts=args.max_map_pts, voxel_size=args.voxel_size,
                        limit=args.limit)
    for loc_seq in args.loc_seq:
        generate_pair(args.data_root, args.map_seq, loc_seq, cfg,
                      map_scan_dir=args.map_scans or None, loc_scan_dir=args.loc_scans or None,
                      device=device)
    return 0


def _gt_inits(args, stamps: list[int]) -> np.ndarray:
    """--init-gt: each frame's GT pose from --loc-gt (closest row within
    1000 µs), perturbed by seeded gaussian x, y and yaw."""
    from mm_masking_tpu_torch.data.boreas import get_closest_index, read_traj_file_gt2
    from mm_masking_tpu_torch.data.convert import se3_exp_np

    if not args.loc_gt:
        raise SystemExit("--init-gt needs --loc-gt (the Applanix CSV supplying the prior poses)")
    poses, gt_times = read_traj_file_gt2(args.loc_gt, dim=2)
    gt_times = list(gt_times)
    rng = np.random.default_rng(args.init_seed)
    tol_us = 1000
    rows = []
    for st in stamps:
        i = get_closest_index(st, gt_times)
        if abs(int(gt_times[i]) - int(st)) > tol_us:
            raise SystemExit(f"--init-gt: scan stamp {st} has no GT row within {tol_us} us in "
                             f"{args.loc_gt} (closest: {gt_times[i]})")
        xi = np.zeros(6)
        xi[0] = rng.normal(0.0, args.init_pos_std)
        xi[1] = rng.normal(0.0, args.init_pos_std)
        xi[5] = rng.normal(0.0, args.init_rot_std)
        rows.append(se3_exp_np(xi) @ poses[i])
    return np.stack(rows).astype(np.float32)


def _policy(args, kind: str, device):
    """--checkpoint: the run's config.json rebuilds the policy, its
    checkpoint supplies the UNet parameters."""
    from mm_masking_tpu_torch.config import Config
    from mm_masking_tpu_torch.models import LearnICPWeightPolicy
    from mm_masking_tpu_torch.train.checkpoint import load_policy_variables

    if kind != "radar":
        raise SystemExit("--checkpoint needs raw radar scans (the mask is computed from the "
                         "scan image); converter shards carry clouds only")
    cfg_path = osp.join(args.checkpoint, "config.json")
    if not osp.exists(cfg_path):
        raise SystemExit(f"{cfg_path} not found — train with this package's Trainer (it writes "
                         "the run config next to its checkpoints)")
    with open(cfg_path) as f:
        run_cfg = Config.from_dict(json.load(f))
    policy = LearnICPWeightPolicy(run_cfg, device)
    params = load_policy_variables(args.checkpoint, args.checkpoint_name, map_location=device)
    print(f"localize: learned mask from {args.checkpoint} ({args.checkpoint_name})")
    return policy, params


def cmd_localize(args) -> int:
    from mm_masking_tpu_torch.evaluation.gt_tools import eval_localization_run, write_traj_file
    from mm_masking_tpu_torch.geom import se3_inv
    from mm_masking_tpu_torch.localization.pipeline import (
        LocalizationConfig,
        localize_cloud_sequence,
        localize_sequence_to_traj,
        localize_sequence_tracked,
    )

    device = resolve_device(args.device)
    kind, paths = _scan_files(args.scans)
    if args.limit > 0:
        paths = paths[: args.limit]
    stamps = [_stamp_of(p) for p in paths]
    map_pc = _load_map(args.map)
    if args.icp_type == "pt2pl" and map_pc.shape[-1] < 6:
        raise SystemExit(f"map {args.map} has no normals (shape {map_pc.shape}); pt2pl "
                         f"localization needs (M, 6) — build it with `teach` or the converter, "
                         f"or pass --icp-type pt2pt")
    if map_pc.shape[-1] < 6:
        map_pc = np.concatenate([map_pc, np.zeros_like(map_pc)], axis=-1)
    map_t = torch.as_tensor(np.asarray(map_pc, np.float32), device=device)
    cfg = LocalizationConfig(detector=args.detector, detector_kwargs=_parse_det_kwargs(args.det),
                             max_points=args.max_points, icp_type=args.icp_type,
                             normal_threshold=args.normal_threshold,
                             min_matched_ratio=args.min_matched_ratio,
                             nn_refresh_dist=args.nn_refresh_dist, max_step_m=args.max_step)
    T_inits = _gt_inits(args, stamps) if args.init_gt else None
    policy = params = None
    if args.checkpoint:
        policy, params = _policy(args, kind, device)

    if args.init_chain:
        # Prior-free tracking from the first frame's --init-gt pose, or identity.
        T0 = T_inits[0] if T_inits is not None else None
        if kind == "radar":
            out = localize_sequence_tracked(_load_radar_frames(paths), map_t, cfg=cfg, T0=T0,
                                            weight_policy=policy, policy_variables=params)
        else:
            out = localize_sequence_tracked(None, map_t, cfg=cfg, T0=T0,
                                            clouds=_clouds_for(kind, paths, args.max_points))
        write_traj_file(args.out_traj, list(se3_inv(out["T"]).cpu().numpy()), stamps)
    elif kind == "radar":
        out = localize_sequence_to_traj(_load_radar_frames(paths), map_t, stamps, args.out_traj,
                                        cfg=cfg, T_inits=T_inits, batch_size=args.batch_size,
                                        weight_policy=policy, policy_variables=params)
    else:
        # Extracted clouds skip the detector and run the same registration.
        out = localize_cloud_sequence(_clouds_for(kind, paths, args.max_points), map_t, cfg=cfg,
                                      T_inits=T_inits, batch_size=args.batch_size)
        write_traj_file(args.out_traj, list(se3_inv(out["T"]).cpu().numpy()), stamps)
    n_ok = int(out["ok"].sum())
    print(f"localize: {len(stamps)} frames ({n_ok} matched-ratio ok) → {args.out_traj}")

    if args.map_gt and args.loc_gt:
        stats = eval_localization_run(
            args.out_traj, args.map_gt, args.loc_gt, out_gt_path=args.out_gt or None,
            plots_dir=args.plots_dir or None,
            seq_name=osp.splitext(osp.basename(args.out_traj))[0], map_frame=args.map_frame)
        line = json.dumps(stats, indent=2)
        if args.stats:
            with open(args.stats, "w") as f:
                f.write(line + "\n")
            print(f"localize: stats → {args.stats}")
        print(line)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mm_masking_tpu_torch.localization",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    device = argparse.ArgumentParser(add_help=False)
    device.add_argument("--device", default="cuda",
                        help="torch device; cuda (the default) raises without a card")
    common = argparse.ArgumentParser(add_help=False, parents=[device])
    common.add_argument("--scans", required=True,
                        help="directory of radar scans, lidar frames or converter shards")
    common.add_argument("--detector", default="modified_cacfar")
    common.add_argument("--det", action="append", default=[], metavar="KEY=VALUE",
                        help="detector setting, repeatable (e.g. --det width=41 --det maxr=15.0)")
    common.add_argument("--max-points", type=int, default=4096)
    common.add_argument("--batch-size", type=int, default=8)
    common.add_argument("--limit", type=int, default=-1, help="only process the first N frames")
    common.add_argument("--icp-type", default="pt2pl", choices=("pt2pl", "pt2pt"))
    common.add_argument("--normal-threshold", type=float, default=0.5,
                        help="|z-normal| gate of the map projection")
    common.add_argument("--min-matched-ratio", type=float, default=0.0,
                        help="matched-ratio gate of the 'ok' frames")
    common.add_argument("--nn-refresh-dist", type=float, default=0.0,
                        help="motion-gated NN refresh (m) in the refined ICP; 0 = search every "
                             "iteration")
    common.add_argument("--max-step", type=float, default=0.0,
                        help="ICP trust-region step clamp (m); 0 = off")

    t = sub.add_parser("teach", parents=[common], help="odometry and map building")
    t.add_argument("--out-map", required=True)
    t.add_argument("--out-traj", default="")
    t.add_argument("--interp-period-us", type=int, default=0,
                   help="also write <out-traj>_interp: the trajectory's Gauss-process "
                        "query every this many microseconds")
    t.add_argument("--max-map-pts", type=int, default=16384)
    t.set_defaults(fn=cmd_teach)

    loc = sub.add_parser("localize", parents=[common], help="localize against a map")
    loc.add_argument("--map", required=True, help="map npz (map_pc (M, 6))")
    loc.add_argument("--out-traj", required=True)
    loc.add_argument("--checkpoint", default="",
                     help="trained run directory: weight the ICP with its UNet's mask")
    loc.add_argument("--checkpoint-name", default="best_policy",
                     help="checkpoint inside --checkpoint (best_policy | epoch_N)")
    loc.add_argument("--init-gt", action="store_true",
                     help="start each frame from its (perturbed) GT pose in --loc-gt")
    loc.add_argument("--init-pos-std", type=float, default=0.0,
                     help="gaussian x/y perturbation of the --init-gt prior (m)")
    loc.add_argument("--init-rot-std", type=float, default=0.0,
                     help="gaussian yaw perturbation of the --init-gt prior (rad)")
    loc.add_argument("--init-seed", type=int, default=99)
    loc.add_argument("--init-chain", action="store_true",
                     help="sequential tracking: start each frame from the constant-velocity "
                          "extrapolation of the two previous solutions (the first from "
                          "--init-gt if given, else identity)")
    loc.add_argument("--map-gt", default="", help="Applanix GT CSV of the map sequence")
    loc.add_argument("--loc-gt", default="", help="Applanix GT CSV of the localized sequence")
    loc.add_argument("--out-gt", default="", help="write the aligned GT trajectory here")
    loc.add_argument("--stats", default="", help="write the error stats JSON here")
    loc.add_argument("--plots-dir", default="",
                     help="with GT: write the error-over-trajectory PNG and CSV here")
    loc.add_argument("--map-frame", default="first", choices=["first", "closest_time"],
                     help="GT map pose for --stats: 'first' = the teach CSV's row 0 (maps "
                          "built by teach); 'closest_time' = the closest teach row per frame")
    loc.set_defaults(fn=cmd_localize)

    g = sub.add_parser("datagen", parents=[device],
                       help="teach + repeat → training shards in one pass")
    g.add_argument("--data-root", required=True, help="Boreas-style tree root (vtr_data/<seq>/…)")
    g.add_argument("--map-seq", required=True)
    g.add_argument("--loc-seq", required=True, nargs="+")
    g.add_argument("--map-scans", default="",
                   help="teach scan directory (default <root>/vtr_data/<map-seq>/<map-sensor>)")
    g.add_argument("--loc-scans", default="", help="repeat scan directory")
    g.add_argument("--map-sensor", default="radar", choices=("radar", "lidar"))
    g.add_argument("--loc-sensor", default="radar", choices=("radar", "lidar"))
    g.add_argument("--detector", default="modified_cacfar")
    g.add_argument("--det", action="append", default=[], metavar="KEY=VALUE",
                   help="detector setting, repeatable")
    g.add_argument("--max-points", type=int, default=1024)
    g.add_argument("--batch-size", type=int, default=8)
    g.add_argument("--max-map-pts", type=int, default=16384)
    g.add_argument("--voxel-size", type=float, default=0.5)
    g.add_argument("--limit", type=int, default=-1)
    g.set_defaults(fn=cmd_datagen)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
