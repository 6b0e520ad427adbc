"""The deployment protocol on the e2e corridor's held-out sequence.

``python -m mm_masking_tpu_torch.benchmarks.eval_deployment``, the
counterpart of the JAX package's ``benchmarks/eval_deployment.py``, with the
same flags and files:

  1. teach: the odometry-built map from the teach sequence's lidar frames
     (the localization CLI's own ``teach`` command; no GT in the map);
  2. localize the held-out repeat sequence four ways through the CLI path a
     user runs: {unweighted ones, trained mask} × {GT-prior warm starts,
     prior-free constant-velocity chain}, each arm's error stats against
     the GT CSVs in ``stats_<arm>.json``;
  3. the mechanism check (:func:`ghost_suppression`): per-point mask
     weights on validation scans, classified as true return or multipath
     ghost against the exactly known synthetic world (the ghosts sit at
     ``Scale.ghost_off`` behind the wall faces);
  4. ``deploy_summary.json``: the four arms, their RMSE ratios, the GT-prior
     p50 ratio and the ghost check.

Usage, after ``e2e_product`` trained a run::

    python -m mm_masking_tpu_torch.benchmarks.eval_deployment \\
        --root <the run's tree> --checkpoint results/checkpoints/<run> \\
        --out results/<run>

Each arm's error plot and table go to ``<out>/plots`` under the JAX
protocol's names, the port's own PNGs (``utils/visualize.py``); the arm's
stats carry their paths, as JAX's do. The ghost check also reports
``n_unclassified``, the valid points that are neither true returns nor
ghosts. It runs on the card (``--device cuda``, the default; raises without
one); ``--device cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import tempfile

import numpy as np
import torch

from mm_masking_tpu_torch.localization.__main__ import main as loc_main


def seg_dist_2d(pts_xy: np.ndarray, segs) -> np.ndarray:
    """Min distance from each 2D point to any wall segment of the world."""
    best = np.full(pts_xy.shape[0], np.inf)
    for (x0, y0), (x1, y1) in segs:
        a = np.array([x0, y0])
        d = np.array([x1 - x0, y1 - y0])
        L2 = float(d @ d)
        if L2 < 1e-12:
            dist = np.linalg.norm(pts_xy - a, axis=-1)
        else:
            t = np.clip(((pts_xy - a) @ d) / L2, 0.0, 1.0)
            dist = np.linalg.norm(pts_xy - (a + t[:, None] * d), axis=-1)
        best = np.minimum(best, dist)
    return best


def ghost_suppression(root: str, checkpoint: str, scale, n_frames: int = 8,
                      device: str | torch.device = "cuda") -> dict:
    """Mean mask weight on true returns vs planted ghosts, classified
    against the exactly known synthetic world: a valid point within
    min(0.35, 0.7 · ghost_off[0]) m of a wall is a true return, one
    0.9 · ghost_off[0] to 1.2 · ghost_off[1] m from every wall a ghost, and
    the rest are counted as ``n_unclassified``."""
    from mm_masking_tpu_torch.benchmarks.e2e_product import VAL_SEQ, build_world
    from mm_masking_tpu_torch.config import Config
    from mm_masking_tpu_torch.data.boreas import read_traj_file_gt2
    from mm_masking_tpu_torch.device import resolve_device
    from mm_masking_tpu_torch.localization.__main__ import (
        _extract_clouds,
        _load_radar_frames,
        _scan_files,
        _stamp_of,
    )
    from mm_masking_tpu_torch.localization.pipeline import LocalizationConfig
    from mm_masking_tpu_torch.models import LearnICPWeightPolicy
    from mm_masking_tpu_torch.ops import extract_weights
    from mm_masking_tpu_torch.train.checkpoint import load_policy_variables

    device = resolve_device(str(device))
    rng = np.random.default_rng(7)  # synthesize_tree's world seed
    _, segs = build_world(rng, scale)

    with open(osp.join(checkpoint, "config.json")) as f:
        cfg = Config.from_dict(json.load(f))
    policy = LearnICPWeightPolicy(cfg, device)
    params = load_policy_variables(checkpoint, map_location=device)

    scan_dir = osp.join(root, "vtr_data", VAL_SEQ, "radar")
    _, paths = _scan_files(scan_dir)
    paths = paths[:n_frames]
    stamps = [_stamp_of(p) for p in paths]
    frames = _load_radar_frames(paths)
    loc_cfg = LocalizationConfig(max_points=scale.max_loc_pts, radar_resolution=scale.res)
    clouds_t = _extract_clouds(frames, loc_cfg, 4, device)
    clouds = clouds_t.cpu().numpy()

    gt_poses, gt_times = read_traj_file_gt2(
        osp.join(root, "vtr_data", VAL_SEQ, "applanix", "radar_poses.csv"), dim=2)
    gt_times = list(gt_times)

    with torch.inference_mode():
        mask = policy.mask_for_scan(params, torch.as_tensor(frames["fft"], device=device),
                                    torch.as_tensor(frames["azimuths"], device=device))
        w, _ = extract_weights(mask, clouds_t, cart_pixel_width=cfg.model.cart_pixel_width,
                               cart_resolution=cfg.model.cart_resolution)
    w = w.float().cpu().numpy()

    true_w, ghost_w, n_unclassified = [], [], 0
    lo, hi = scale.ghost_off
    for i, st in enumerate(stamps):
        T = gt_poses[gt_times.index(st)]
        c = clouds[i]
        valid = ~((c[:, 0] == 0.0) & (c[:, 1] == 0.0))
        pts_w = (c[valid] @ T[:3, :3].T + T[:3, 3])[:, :2]
        dist = seg_dist_2d(pts_w, segs)
        is_true = dist <= min(0.35, lo * 0.7)
        is_ghost = (dist >= lo * 0.9) & (dist <= hi * 1.2)
        true_w.append(w[i, valid][is_true])
        ghost_w.append(w[i, valid][is_ghost])
        n_unclassified += int((~is_true & ~is_ghost).sum())
    tw = np.concatenate(true_w)
    gw = np.concatenate(ghost_w)
    return {
        "n_true": int(tw.size), "n_ghost": int(gw.size), "n_unclassified": n_unclassified,
        "mean_w_true": float(tw.mean()), "mean_w_ghost": float(gw.mean()),
        "suppression_ratio": float(tw.mean() / max(gw.mean(), 1e-12)),
        "median_w_true": float(np.median(tw)),
        "median_w_ghost": float(np.median(gw)),
    }


def main(argv=None) -> dict:
    from mm_masking_tpu_torch.benchmarks.e2e_product import MAP_SEQ, MID, TINY, VAL_SEQ, Scale
    from mm_masking_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=osp.join(tempfile.gettempdir(), "e2e_product_m4"),
                    help="the trained run's tree (e2e_product's --root with its suffixes)")
    ap.add_argument("--checkpoint", default="results/checkpoints/e2e_product")
    ap.add_argument("--out", default="results/e2e_product")
    ap.add_argument("--scale", default="full", choices=["tiny", "mid", "full"])
    ap.add_argument("--init-pos-std", type=float, default=0.5)
    ap.add_argument("--init-rot-std", type=float, default=0.1)
    ap.add_argument("--skip-ghost", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))

    sc = {"tiny": TINY, "mid": MID, "full": Scale()}[args.scale]
    os.makedirs(args.out, exist_ok=True)
    root = args.root

    map_npz = osp.join(args.out, "teach_map.npz")
    map_scans = osp.join(root, "vtr_data", MAP_SEQ, "lidar")
    val_scans = osp.join(root, "vtr_data", VAL_SEQ, "radar")
    map_gt = osp.join(root, "vtr_data", MAP_SEQ, "applanix", "lidar_poses.csv")
    loc_gt = osp.join(root, "vtr_data", VAL_SEQ, "applanix", "radar_poses.csv")

    if not osp.exists(map_npz):
        rc = loc_main(["teach", "--scans", map_scans, "--out-map", map_npz,
                       "--max-points", str(sc.max_loc_pts),
                       "--max-map-pts", str(sc.max_map_pts), "--device", device])
        assert rc == 0, "teach failed"

    summary = {}
    for label, extra in {
        "ones": [],
        "learned": ["--checkpoint", args.checkpoint],
        "chain_ones": ["--init-chain"],
        "chain_learned": ["--init-chain", "--checkpoint", args.checkpoint],
    }.items():
        stats_p = osp.join(args.out, f"stats_{label}.json")
        # The CLI's default radar_resolution (0.0596) is the full-scale
        # world's; the tiny and mid trees localize at it too, as in the JAX
        # protocol.
        argv = ["localize", "--scans", val_scans, "--map", map_npz,
                "--out-traj", osp.join(args.out, f"traj_{label}.txt"),
                "--max-points", str(sc.max_loc_pts),
                "--map-gt", map_gt, "--loc-gt", loc_gt, "--stats", stats_p,
                "--plots-dir", osp.join(args.out, "plots"), "--device", device] + extra
        if "--init-chain" not in extra:
            argv += ["--init-gt", "--init-pos-std", str(args.init_pos_std),
                     "--init-rot-std", str(args.init_rot_std)]
        rc = loc_main(argv)
        assert rc == 0, f"localize {label} failed"
        with open(stats_p) as f:
            stats = json.load(f)
        summary[label] = stats
        print(f"[deploy] {label}: trans_rmse {stats['trans_rmse']:.4f} m", file=sys.stderr,
              flush=True)

    summary["rmse_ratio_gt_prior"] = (summary["ones"]["trans_rmse"]
                                      / summary["learned"]["trans_rmse"])
    summary["rmse_ratio_chain"] = (summary["chain_ones"]["trans_rmse"]
                                   / summary["chain_learned"]["trans_rmse"])
    summary["p50_ratio_gt_prior"] = (summary["ones"]["trans_p50"]
                                     / summary["learned"]["trans_p50"])

    if not args.skip_ghost:
        gs = ghost_suppression(root, args.checkpoint, sc, device=device)
        with open(osp.join(args.out, "ghost_suppression.json"), "w") as f:
            json.dump(gs, f, indent=1)
        summary["ghost_suppression"] = gs

    with open(osp.join(args.out, "deploy_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
