"""The product recipe: raw sensor files → datagen → training → baselines.

``python -m mm_masking_tpu_torch.benchmarks.e2e_product``, the counterpart of
the JAX package's ``benchmarks/e2e_product.py``, with the same flags, files
and one-line summary. It drives the loop a user runs across the whole stack
from files on disk:

  1. synthesize a Boreas-style tree (:func:`synthesize_tree`): a 3D corridor
     world, teach-pass lidar ``.bin`` frames, repeat-pass raw Navtech radar
     images at full polar resolution with multipath ghost returns 0.5–1.3 m
     behind the wall faces, inside ICP's pull basin, so unweighted ICP is
     coherently biased and the learned mask has work to do;
  2. ``localization.datagen.generate_pair``: lidar teach odometry and map,
     radar repeats detector-extracted from the raw images, converter-layout
     shards (the radar-to-lidar configuration);
  3. ``ICPWeightDataset`` and ``Trainer.fit`` on those shards (CFAR cache,
     augmentation, seed-99 perturbations, pt2pl ICP);
  4. the CFAR and all-ones baselines on the held-out pass, and the learned
     val norm against them.

The tree is numpy alone: one generator seeded with 7 draws the world, the
teach lidar noise and every radar render in sequence order, so the port's
tree equals the JAX script's byte for byte.

Scales: ``--scale tiny`` (CPU, seconds) | ``mid`` | ``full`` (the reference
shapes: 400 × 3360 polar, 640² cartesian, 4096 / 16384 points, bf16; run it
on the card). The product runs' recipe is::

    python -m mm_masking_tpu_torch.benchmarks.e2e_product --scale full \\
        --train-seqs 4 --lr 1e-4 --clip 10 --epochs 60 --run-name <name>

It prints ONE summary JSON line on stdout (the wall times go to stderr);
the checkpoints (``best_policy.pt``, ``epoch_N.pt``), ``config.json`` and
``run_metrics.jsonl`` land under ``results/checkpoints/<run-name>``. It runs
on the card (``--device cuda``, the default; raises without one);
``--device cpu`` runs it on the CPU.

With ``--warmup-epochs K`` the summary's ``val_init_baseline`` is taken from
a freshly initialised state before the warm-up, and the summary says so
(``val_init_from``); the JAX script takes it from the post-warm-up state.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import os.path as osp
import shutil
import sys
import tempfile
import time

import numpy as np

from mm_masking_tpu_torch.data.boreas import get_inverse_tf, yawPitchRollToRot


@dataclasses.dataclass(frozen=True)
class Scale:
    A: int = 400            # polar azimuths
    R: int = 3360           # polar range bins
    res: float = 0.0596
    cart: int = 640
    cart_res: float = 0.2384
    n_teach: int = 36
    n_train: int = 64
    n_val: int = 32
    max_loc_pts: int = 4096
    max_map_pts: int = 16384
    enc_channels: tuple = (8, 16, 32, 64, 128, 256)
    batch_train: int = 16
    batch_test: int = 32
    epochs: int = 15
    dtype: str = "bfloat16"
    # Wall face height: must span several map voxels (0.3 m) or the kNN-PCA
    # normal estimate degenerates to a line fit (measured at tiny scale:
    # 58% of 0.4 m-wall points got vertical normals). The dataset's
    # elevation gate (0.05 rad) passes z<=1.2 beyond ~24 m range — the
    # corridor walls sit at >=21 m lateral distance at full scale.
    wall_h: float = 1.2
    # Multipath ghost model. Ghosts at
    # 1.5–3.5 m behind the wall sit OUTSIDE the Cauchy k=1.0 pull basin, so
    # the 10-iteration GT-perturbed val metric barely feels them and the
    # all-ones baseline is near-oracle (learned tied ones at n=2). Short-lag
    # multipath — 0.5–1.5 m behind the face, amplitudes overlapping the true
    # returns — keeps robust weights at 0.3–0.8 where the ghost mass
    # coherently biases the pt2pl optimum, which is exactly the failure the
    # learned mask exists to fix (the paper's thesis). Two sectors per scan
    # so the bias direction is frame-dependent, not a constant the solver
    # could never distinguish from a calibration offset.
    #
    # Calibration (measured with the JAX package): sectors 2×0.28 at 0.5–2.0 m /
    # amp 0.55–0.8 pushed unweighted ICP past bias into DIVERGENCE
    # (val_ones 7.25 vs init 0.58) — and backprop through a diverging
    # unrolled solve emits garbage gradients (grad spikes to 2.7e4,
    # mask oscillating between collapse and divergence). The product
    # regime of interest is BIASED-but-converged unweighted ICP (ones
    # ≈0.6 m RMSE deployed); these defaults land there.
    ghost_off: tuple = (0.5, 1.3)
    ghost_amp: tuple = (0.45, 0.65)
    ghost_sectors: int = 2
    ghost_frac: float = 0.15  # azimuth fraction PER sector


TINY = Scale(A=64, R=256, res=15.0 / 256, cart=64, cart_res=2 * 15.0 / 64,
             n_teach=4, n_train=6, n_val=4, max_loc_pts=512,
             max_map_pts=2048, enc_channels=(4, 8),
             batch_train=2, batch_test=2, epochs=2, dtype="float32", wall_h=0.4)

# CPU-runnable middle ground: quarter-resolution images, quarter clouds —
# big enough for the ghost-suppression learning signal, small enough to
# train on the 1-core host when the chip is unavailable.
MID = Scale(A=200, R=840, res=0.0596 * 4, cart=256, cart_res=0.2384 * 640 / 256,
            n_teach=24, n_train=32, n_val=16, max_loc_pts=1024,
            max_map_pts=4096, enc_channels=(8, 16, 32, 64),
            batch_train=8, batch_test=8, epochs=10, dtype="float32",
            wall_h=1.2)

MAP_SEQ, TRAIN_SEQ, VAL_SEQ = "e2e-map", "e2e-train", "e2e-val"


def _train_seqs(n: int) -> list[str]:
    """Train sequence names for an n-pair run (the reference trains on 12
    repeat pairs against one teach, `train_icp_weights.py:420-432`)."""
    return [TRAIN_SEQ] + [f"{TRAIN_SEQ}{i}" for i in range(2, n + 1)]


# --------------------------------------------------------------------- world
def build_world(rng, sc: Scale):
    """Corridor world: two long walls + perpendicular stubs + poles.

    Returns (wall_pts_3d (Nw, 3) for lidar, wall segments [(p0, p1), ...] 2D
    for radar rendering).
    """
    extent = sc.cart * sc.cart_res / 2 * 0.55  # stay inside the cart FOV
    L = extent * 1.6
    segs = [((-L / 4, -extent * 0.5), (L, -extent * 0.5)),
            ((-L / 4, extent * 0.45), (L, extent * 0.45))]
    # perpendicular stubs break the along-corridor translation ambiguity
    for xs in np.linspace(0, L * 0.9, 5):
        side = extent * 0.45 if int(xs * 7) % 2 else -extent * 0.5
        segs.append(((xs, side), (xs, side * 0.55)))
    # Diagonal walls at varied angles (a conditioning fix, measured):
    # with only two parallel walls + sparse stubs, the pt2pl normal matrix
    # is near-singular along-corridor — in-basin ghost mass then commands
    # 10 m+ GN jumps along the soft direction and unweighted ICP
    # death-spirals on 90% of frames (error at init 1.2 m → 6.5 m by
    # iteration 5). Normals spanning all angles keep A well-conditioned,
    # so planted multipath BIASES the optimum instead of exploding it —
    # the regime the learned mask is for (and the regime real corridors
    # with clutter sit in).
    for i, xs in enumerate(np.linspace(L * 0.05, L * 0.85, 6)):
        ang = (i * 0.9 + 0.5) % np.pi
        side = 1.0 if i % 2 else -1.0
        y0 = side * extent * (0.12 + 0.06 * (i % 3))
        dlen = extent * 0.18
        segs.append(((xs, y0),
                     (xs + dlen * np.cos(ang), y0 + side * abs(dlen * np.sin(ang)))))
    pts = []
    for (x0, y0), (x1, y1) in segs:
        n = max(24, int(np.hypot(x1 - x0, y1 - y0) * 18))
        t = rng.uniform(0, 1, n)
        xy = np.stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0)], -1)
        z = rng.uniform(0.0, sc.wall_h, (n, 1))
        pts.append(np.concatenate([xy, z], -1))
    # poles (point landmarks)
    npole = 12
    px = rng.uniform(-L / 4, L, npole)
    py = rng.uniform(-extent * 0.4, extent * 0.35, npole)
    for x, y in zip(px, py):
        z = rng.uniform(0.0, sc.wall_h, (20, 1))
        xy = np.tile([[x, y]], (20, 1)) + rng.normal(0, 0.03, (20, 2))
        pts.append(np.concatenate([xy, z], -1))
        segs.append(((x, y), (x + 1e-3, y + 1e-3)))
    wall3d = np.concatenate(pts).astype(np.float32)
    # ground plane (lidar sees it; the dataset's z-normal gate must drop it)
    ng = wall3d.shape[0] // 2
    ground = np.stack([rng.uniform(-L / 4, L, ng),
                       rng.uniform(-extent, extent, ng),
                       np.zeros(ng)], -1).astype(np.float32)
    return np.concatenate([wall3d, ground]), segs


def _pose(x, y, h):
    T = np.eye(4)
    T[:3, :3] = yawPitchRollToRot(h, 0, 0)
    T[:3, 3] = [x, y, 0.0]
    return T


def _write_csv(path, rows):
    with open(path, "w") as f:
        f.write("GPSTime,easting,northing,altitude,vel_e,vel_n,vel_u,"
                "roll,pitch,heading\n")
        for t_us, x, y, h in rows:
            f.write(f"{t_us/1e6:.6f},{x},{y},0.0,0,0,0,0.0,0.0,{h}\n")


def _render_radar(segs, T_world_sensor_inv, rng, sc: Scale):
    """Raw Navtech image: wall returns (bright) + multipath ghosts —
    `sc.ghost_off` metres behind the wall face, inside the robust-loss pull
    basin, coherently biasing unweighted ICP (see Scale.ghost_off)."""
    A, R = sc.A, sc.R
    fft = (0.05 * rng.random((A, R)) ** 2).astype(np.float32)

    # sample wall returns in the sensor frame
    pts = []
    for (x0, y0), (x1, y1) in segs:
        n = max(8, int(np.hypot(x1 - x0, y1 - y0) * 6))
        t = rng.uniform(0, 1, n)
        pts.append(np.stack([x0 + t * (x1 - x0), y0 + t * (y1 - y0)], -1))
    w = np.concatenate(pts)
    w3 = np.concatenate([w, np.zeros((w.shape[0], 1))], -1)
    s = w3 @ T_world_sensor_inv[:3, :3].T + T_world_sensor_inv[:3, 3]
    rr = np.linalg.norm(s[:, :2], axis=-1)
    aa = np.mod(np.arctan2(s[:, 1], s[:, 0]), 2 * np.pi)
    keep = (rr > 2.0) & (rr < (R - 8) * sc.res)
    rr, aa = rr[keep], aa[keep]
    ai = np.clip((aa / (2 * np.pi / A)).astype(int), 0, A - 1)
    ri = np.clip((rr / sc.res).astype(int), 0, R - 4)
    amp = rng.uniform(0.75, 0.95, rr.shape[0]).astype(np.float32)
    for d in range(3):  # small range spread, wall-like
        fft[ai, ri + d] = np.maximum(fft[ai, ri + d], amp * (1 - 0.25 * d))

    # ghost sectors: contiguous azimuth runs get a second return behind the
    # true one (multipath off the wall face), amplitude overlapping the true
    # returns so neither CFAR nor an intensity threshold separates them —
    # only the learned spatial pattern (dim echo trailing a bright face) can
    for _ in range(sc.ghost_sectors):
        a0 = rng.integers(0, A)
        sector = (ai - a0) % A < int(sc.ghost_frac * A)
        gr = rr[sector] + rng.uniform(*sc.ghost_off, sector.sum())
        gi = np.clip((gr / sc.res).astype(int), 0, R - 4)
        ga = ai[sector]
        gamp = rng.uniform(*sc.ghost_amp, ga.shape[0]).astype(np.float32)
        for d in range(3):
            fft[ga, gi + d] = np.maximum(fft[ga, gi + d], gamp * (1 - 0.25 * d))

    img = np.zeros((A, 11 + R), np.uint8)
    ts = np.arange(A, dtype=np.int64) * 400
    img[:, :8] = np.frombuffer(ts.tobytes(), np.uint8).reshape(A, 8)
    enc = (np.arange(A, dtype=np.float64) / A * 5600).astype(np.uint16)
    img[:, 8:10] = np.frombuffer(enc.tobytes(), np.uint8).reshape(A, 2)
    img[:, 11:] = np.clip(fft * 255, 0, 255).astype(np.uint8)
    return img


def synthesize_tree(root: str, sc: Scale, seed: int = 7, train_seqs: int = 1):
    """Write the tree under ``root``: the GT CSVs and identity calibration of
    every sequence, the teach pass's lidar ``.bin`` frames and the repeat
    passes' raw Navtech ``.npy`` scans. One generator seeded with ``seed``
    draws, in this order, the world, the teach frames' lidar noise and every
    radar render (the training sequences, then the validation one), so the
    tree's bytes follow from the seed alone. Returns the trajectories
    {seq: [(stamp_us, x, y, heading)]}."""
    rng = np.random.default_rng(seed)
    world, segs = build_world(rng, sc)
    extent = sc.cart * sc.cart_res / 2 * 0.55
    L = extent * 1.6

    def traj(n, t0, phase, drift, amp=0.8, wiggle=0.0):
        """Repeat-pass trajectory: lateral sinusoid (amp, phase, drift off
        the teach line) plus an optional heading wiggle decoupled from the
        path tangent — distinct view geometry per sequence (varied
        headings, not one re-phased sweep)."""
        xs = np.linspace(0, L * 0.85, n)
        ys = amp * np.sin(xs / L * 2 * np.pi + phase) + drift
        hs = np.gradient(ys, xs)
        if wiggle:
            hs = hs + wiggle * np.sin(xs / L * 5 * np.pi + 2 * phase)
        return [(t0 + 250_000 * i, float(xs[i]), float(ys[i]), float(hs[i]))
                for i in range(n)]

    rows = {MAP_SEQ: traj(sc.n_teach, 1_000_000, 0.0, 0.0),
            TRAIN_SEQ: traj(sc.n_train, 100_000_000, 0.7, 0.4),
            VAL_SEQ: traj(sc.n_val, 200_000_000, 1.9, -0.35, amp=1.1,
                          wiggle=0.12)}
    for i, seq in enumerate(_train_seqs(train_seqs)[1:], start=2):
        # extra repeat passes: distinct lateral offsets/phases/amplitudes
        # and per-sequence heading wiggle, own epoch
        rows[seq] = traj(sc.n_train, 100_000_000 * (i + 1),
                         0.7 + 1.1 * (i - 1), 0.4 - 0.5 * (i - 1),
                         amp=0.6 + 0.25 * (i - 1), wiggle=0.08 * (i - 1))

    for seq, rws in rows.items():
        d = osp.join(root, "vtr_data", seq)
        os.makedirs(osp.join(d, "applanix"), exist_ok=True)
        os.makedirs(osp.join(d, "calib"), exist_ok=True)
        np.savetxt(osp.join(d, "calib", "T_applanix_lidar.txt"), np.eye(4))
        np.savetxt(osp.join(d, "calib", "T_radar_lidar.txt"), np.eye(4))
        _write_csv(osp.join(d, "applanix", "radar_poses.csv"), rws)
        _write_csv(osp.join(d, "applanix", "lidar_poses.csv"), rws)

    # teach lidar frames (.bin, Boreas float32 (N, 6))
    ldir = osp.join(root, "vtr_data", MAP_SEQ, "lidar")
    os.makedirs(ldir, exist_ok=True)
    for t_us, x, y, h in rows[MAP_SEQ]:
        Ti = get_inverse_tf(_pose(x, y, h))
        s = (world @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32)
        rr = np.linalg.norm(s[:, :2], axis=-1)
        s = s[(rr > 1.5) & (rr < extent * 2.2)]
        s = s + rng.normal(0, 0.01, s.shape).astype(np.float32)
        np.concatenate([s, np.zeros_like(s)], 1).astype(np.float32).tofile(
            osp.join(ldir, f"{t_us}.bin"))

    # repeat radar frames (raw Navtech .npy — the detector extracts clouds
    # from these in datagen, and the dataset reads them for fft_data)
    for seq in _train_seqs(train_seqs) + [VAL_SEQ]:
        rdir = osp.join(root, "vtr_data", seq, "radar")
        os.makedirs(rdir, exist_ok=True)
        for t_us, x, y, h in rows[seq]:
            Ti = get_inverse_tf(_pose(x, y, h))
            img = _render_radar(segs, Ti, rng, sc)
            np.save(osp.join(rdir, f"{t_us}.npy"), img)
    return rows


# ---------------------------------------------------------------------- main
SUMMARY_KEYS = (
    "metric", "value", "val_init_baseline", "val_ones_baseline", "val_cfar_baseline",
    "val_allones_baseline", "improvement_vs_ones", "improvement_vs_cfar",
    "improvement_vs_allones", "best_epoch_norm", "epochs", "notfinite_count",
    "train_samples", "val_samples", "train_pairs", "scale",
)


def tree_root(root: str, scale: str, train_seqs: int) -> str:
    """The run's tree directory: ``root`` plus ``_<scale>`` below full scale
    and ``_m<n>`` for more than one training sequence."""
    out = root + ("" if scale == "full" else f"_{scale}")
    return out + (f"_m{train_seqs}" if train_seqs > 1 else "")


def _log(msg: str) -> None:
    print(f"[e2e] {msg}", file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", default="full", choices=["tiny", "mid", "full"])
    ap.add_argument("--root", default=osp.join(tempfile.gettempdir(), "e2e_product"),
                    help="tree directory (suffixed by scale and sequence count)")
    ap.add_argument("--epochs", type=int, default=0, help="override epochs")
    ap.add_argument("--regen", action="store_true",
                    help="force re-synthesis + re-datagen")
    ap.add_argument("--run-name", default="e2e_product")
    ap.add_argument("--icp-type", default="pt2pl", choices=["pt2pt", "pt2pl"])
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-schedule", default="constant", choices=["constant", "cosine"],
                    help="cosine decays to 0 over the whole run (opt-in stabilizer; "
                         "constant = reference semantics)")
    ap.add_argument("--max-step", type=float, default=0.0,
                    help="ICP trust-region clamp (m); 0 = reference semantics")
    ap.add_argument("--clip", type=float, default=0.0,
                    help="gradient value clip (train.clip_value); bounds the spikes "
                         "diverged ICP items kick into Adam's moments")
    ap.add_argument("--datagen-only", action="store_true",
                    help="stop after shard generation")
    ap.add_argument("--baselines-only", action="store_true",
                    help="measure the init / ones / CFAR val baselines and stop")
    ap.add_argument("--train-seqs", type=int, default=1,
                    help="number of repeat train sequences (the reference trains on 12 "
                         "pairs against one teach)")
    ap.add_argument("--warmup-epochs", type=int, default=0,
                    help="two-stage training: first K epochs with the ICP loss off "
                         "(use_icp_4_train=False, the reference's mask-losses-only mode), "
                         "then the full loss")
    ap.add_argument("--seed", type=int, default=99,
                    help="train.seed: the UNet's initialisation and the dropout masks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def make_config(args, sc: Scale, root: str, train_pairs: tuple):
    """The recipe's Config: the collapse-resistant walls loss (num_pts 1e-3
    with a 0.15 floor), ±0.5 m / 0.1 rad perturbations, the scale's shapes."""
    from mm_masking_tpu_torch.config import (
        Config,
        DataConfig,
        LossWeights,
        ModelConfig,
        TrainConfig,
    )

    return Config(
        model=ModelConfig(
            icp_type=args.icp_type, enc_channels=sc.enc_channels,
            icp_max_step_m=args.max_step,
            res=sc.res, polar_shape=(sc.A, sc.R),
            cart_pixel_width=sc.cart, cart_resolution=sc.cart_res,
            dtype=sc.dtype,
        ),
        data=DataConfig(
            map_sensor="lidar", loc_sensor="radar", data_dir=root,
            pos_std=0.5, rot_std=0.1,
            max_loc_pts=sc.max_loc_pts, max_map_pts=sc.max_map_pts,
        ),
        train=TrainConfig(
            batch_size_train=sc.batch_train, batch_size_test=sc.batch_test,
            num_epochs=sc.epochs, learning_rate=args.lr, clip_value=args.clip,
            lr_schedule=args.lr_schedule, seed=args.seed,
            checkpoint_dir=osp.join("results", "checkpoints", args.run_name),
        ),
        loss=LossWeights(num_pts=1e-3, num_pts_floor=0.15),
        train_loc_pairs=train_pairs,
        val_loc_pairs=((MAP_SEQ, VAL_SEQ),),
    )


def main(argv=None) -> tuple[dict, dict]:
    """Run the recipe; print its JSON line and return it with the wall times
    in seconds (synthesis, datagen, the fit, the closing baselines, each
    epoch's train and val pass from ``fit``'s log, the whole run)."""
    args = build_parser().parse_args(argv)
    from mm_masking_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    t_run = time.perf_counter()
    walls = {}

    sc = {"tiny": TINY, "mid": MID, "full": Scale()}[args.scale]
    if args.epochs:
        sc = dataclasses.replace(sc, epochs=args.epochs)
    root = tree_root(args.root, args.scale, args.train_seqs)

    if args.regen and osp.isdir(root):
        shutil.rmtree(root)
    train_pairs = tuple((MAP_SEQ, s) for s in _train_seqs(args.train_seqs))
    done_marker = osp.join(root, "vtr_results", "radar_lidar", MAP_SEQ, train_pairs[-1][1])
    if not osp.isdir(done_marker):
        os.makedirs(root, exist_ok=True)
        _log(f"synthesizing Boreas-style tree under {root}")
        t0 = time.perf_counter()
        synthesize_tree(root, sc, train_seqs=args.train_seqs)
        walls["synthesis_s"] = time.perf_counter() - t0

        from mm_masking_tpu_torch.localization.datagen import DatagenConfig, generate_pair

        dg = DatagenConfig(
            map_sensor="lidar", loc_sensor="radar",
            max_points=sc.max_loc_pts, max_map_pts=sc.max_map_pts,
            radar_resolution=sc.res, voxel_size=0.3, batch_size=8,
        )
        t0 = time.perf_counter()
        for loc_seq in [s for _, s in train_pairs] + [VAL_SEQ]:
            _log(f"datagen {MAP_SEQ} -> {loc_seq}")
            generate_pair(root, MAP_SEQ, loc_seq, dg, device=device)
        walls["datagen_s"] = time.perf_counter() - t0

    if args.datagen_only:
        out = {"status": "datagen_done", "root": root}
        print(json.dumps(out), flush=True)
        return out, walls

    from mm_masking_tpu_torch.data import ICPWeightDataset, epoch_batches
    from mm_masking_tpu_torch.train import Trainer

    cfg = make_config(args, sc, root, train_pairs)
    train_ds = ICPWeightDataset(list(cfg.train_loc_pairs), cfg, "train")
    val_ds = ICPWeightDataset(list(cfg.val_loc_pairs), cfg, "test")
    _log(f"train={len(train_ds)} val={len(val_ds)} samples")
    if args.lr_schedule == "cosine":
        steps = sc.epochs * max(1, len(train_ds) // sc.batch_train)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 lr_decay_steps=steps))
        _log(f"cosine lr: decay over {steps} steps")

    def train_batches(epoch):
        return epoch_batches(train_ds, cfg.train.batch_size_train, cfg, shuffle=True,
                             seed=epoch, device=device)

    def val_batches():
        return epoch_batches(val_ds, cfg.train.batch_size_test, cfg, shuffle=False,
                             drop_last=False, device=device)

    trainer = Trainer(cfg, device)
    if args.baselines_only:
        st = trainer.init_state()
        vi, vo = trainer.generate_baseline(st, val_batches(), baseline_type="val")
        _, vc = trainer.generate_baseline(st, val_batches(), baseline_type="val",
                                          mask_kind="cfar")
        out = {"status": "baselines", "val_init": vi, "val_ones": vo, "val_cfar": vc}
        print(json.dumps(out), flush=True)
        return out, walls

    state = None
    val_init_fresh = None
    if args.warmup_epochs > 0:
        # The summary's init baseline comes from a fresh state, taken before
        # the warm-up trains it.
        val_init_fresh, _ = trainer.generate_baseline(trainer.init_state(), val_batches(),
                                                      baseline_type="val")
        warm_cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss, icp_rot=0.0,
                                                                     icp_trans=0.0))
        assert not warm_cfg.use_icp_4_train
        state = Trainer(warm_cfg, device, logger=trainer.logger).fit(
            train_batches, val_batches, num_epochs=args.warmup_epochs)
        _log(f"warmup done ({args.warmup_epochs} epochs, ICP loss off) — switching to the "
             "full loss")

    t0 = time.perf_counter()
    state = trainer.fit(train_batches, val_batches, state=state)
    walls["fit_s"] = time.perf_counter() - t0
    # CFAR and true all-ones baselines on the same held-out pass (the
    # reference evaluates CFAR as its own baseline configuration; the
    # in-loop "ones" baseline follows the active loss config, the map BEV
    # when mask_pts is on, so the unconditional all-ones row is measured
    # here).
    t0 = time.perf_counter()
    _, val_cfar = trainer.generate_baseline(state, val_batches(), baseline_type="val",
                                            mask_kind="cfar")
    _, val_allones = trainer.generate_baseline(state, val_batches(), baseline_type="val",
                                               mask_kind="ones")
    walls["baselines_s"] = time.perf_counter() - t0
    trainer.logger.log("baseline_cfar", {"val_cfar": val_cfar, "val_allones": val_allones})
    del state

    # The headline numbers, from this run's records of the JSONL (the logger
    # appends across runs: keep the records after the last "baseline").
    with open(trainer.logger.path) as f:
        recs = [json.loads(line) for line in f]
    start = max(i for i, r in enumerate(recs) if r.get("event") == "baseline")
    recs = recs[start:]

    def by(k):
        return [r for r in recs if r.get("event") == k]

    base = by("baseline")[-1]
    final = by("final_val")[-1]
    epochs = by("epoch")
    summary = {
        "metric": "e2e_product_val_norm",
        "value": final["norm"],
        "val_init_baseline": base["val_init"] if val_init_fresh is None else val_init_fresh,
        "val_ones_baseline": base["val_ones"],
        "val_cfar_baseline": val_cfar,
        "val_allones_baseline": val_allones,
        "improvement_vs_ones": base["val_ones"] / max(final["norm"], 1e-12),
        "improvement_vs_cfar": val_cfar / max(final["norm"], 1e-12),
        "improvement_vs_allones": val_allones / max(final["norm"], 1e-12),
        "best_epoch_norm": min(e["acc"] for e in epochs),
        "epochs": len(epochs),
        "notfinite_count": epochs[-1]["notfinite_count"],
        "train_samples": len(train_ds),
        "val_samples": len(val_ds),
        "train_pairs": len(train_pairs),
        "scale": args.scale,
    }
    if val_init_fresh is not None:
        summary["val_init_from"] = "fresh_init_state"
    walls["epochs_train_s"] = [e["epoch_train_time"] for e in epochs]
    walls["epochs_val_s"] = [e["epoch_val_time"] for e in epochs]
    walls["total_s"] = time.perf_counter() - t_run
    _log(f"wall_times {json.dumps(walls)}")
    print(json.dumps(summary), flush=True)
    return summary, walls


if __name__ == "__main__":
    main()
