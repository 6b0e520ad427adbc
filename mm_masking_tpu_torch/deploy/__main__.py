"""Deployment-artifact CLI of the port (counterpart of ``python -m
mm_masking_tpu.deploy``).

  export            Trainer run dir → mask artifact
  export-localizer  registration step (clouds → pose) → artifact
  info              print an artifact's header
  run               an artifact over raw Navtech scan files → masks.npz

``--platforms`` is ``cuda`` (the default: traced on the card, through the
port's kernels) or ``cpu`` (plain ATen operators, loadable with ``torch``
alone); ``run`` runs an artifact on the device it was traced on.

Examples:
  python -m mm_masking_tpu_torch.deploy export --checkpoint results/checkpoints/run \\
      --out policy.mmx
  python -m mm_masking_tpu_torch.deploy info policy.mmx
  python -m mm_masking_tpu_torch.deploy run --artifact policy.mmx \\
      --scans data/radar_dir --out masks.npz
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os.path as osp
import sys

import numpy as np


def _batch(text: str) -> int | str:
    return text if text == "b" else int(text)


def _platforms(text: str) -> list[str]:
    return text.split(",") if text else ["cuda"]


def _cmd_export(args) -> int:
    from mm_masking_tpu_torch.deploy import export_from_run_dir, write_artifact

    payload, header = export_from_run_dir(args.checkpoint,
                                          checkpoint_name=args.checkpoint_name,
                                          batch=_batch(args.batch),
                                          platforms=_platforms(args.platforms))
    write_artifact(args.out, payload, header)
    print(f"export: {args.out} ({len(payload) / 1e6:.2f} MB payload) "
          f"platforms={header['platforms']} batch={header['batch']} "
          f"custom_ops={header['custom_ops']}")
    return 0


def _cmd_export_localizer(args) -> int:
    from mm_masking_tpu_torch.deploy import export_localizer, write_artifact
    from mm_masking_tpu_torch.localization.pipeline import LocalizationConfig

    cfg = LocalizationConfig()
    fields = {f.name for f in dataclasses.fields(LocalizationConfig)}
    for kv in args.cfg or ():
        key, _, val = kv.partition("=")
        if key not in fields:
            raise SystemExit(f"unknown LocalizationConfig field {key!r} "
                             f"(have: {', '.join(sorted(fields))})")
        typ = type(getattr(cfg, key))
        if typ is bool:
            new = val.lower() in ("1", "true", "yes")
        elif typ is int:
            new = int(float(val))
        elif typ is float:
            new = float(val)
        elif typ is str:
            new = val
        else:
            raise SystemExit(f"{key} ({typ.__name__}) is not settable via --cfg")
        cfg = dataclasses.replace(cfg, **{key: new})
    payload, header = export_localizer(cfg, n_points=args.n_points, n_map=args.n_map,
                                       batch=_batch(args.batch),
                                       platforms=_platforms(args.platforms))
    write_artifact(args.out, payload, header)
    print(f"export-localizer: {args.out} ({len(payload) / 1e6:.2f} MB) "
          f"platforms={header['platforms']} icp={header['icp_type']} "
          f"N={args.n_points} M={args.n_map} batch={header['batch']}")
    return 0


def _cmd_info(args) -> int:
    from mm_masking_tpu_torch.deploy import read_artifact

    payload, header = read_artifact(args.artifact)
    header["payload_bytes"] = len(payload)
    print(json.dumps(header, indent=1))
    return 0


def _cmd_run(args) -> int:
    from mm_masking_tpu_torch.deploy import load_mask_policy
    from mm_masking_tpu_torch.ops.radar import load_radar

    call, _ = load_mask_policy(args.artifact)
    paths = sorted(glob.glob(osp.join(args.scans, "*.npy"))
                   + glob.glob(osp.join(args.scans, "*.png"))
                   ) if osp.isdir(args.scans) else [args.scans]
    if not paths:
        raise SystemExit(f"no .npy/.png scans under {args.scans}")

    def load_scan(p):
        if p.endswith(".npy"):
            raw = np.load(p)
        else:
            from mm_masking_tpu_torch.data.dataset import _imread_gray

            raw = _imread_gray(p)
        fft, az, _ = load_radar(raw, normalize=False)  # u8: the loader normalises it
        return fft, az.astype(np.float32)

    # In chunks: the max normalisation's statistics span each chunk (the
    # reference's validation batches), so --batch-size is a semantic knob;
    # the last short chunk runs at its own size.
    b = max(1, args.batch_size)
    masks, stamps = [], []
    for start in range(0, len(paths), b):
        chunk = paths[start:start + b]
        scans = [load_scan(p) for p in chunk]
        out = call(np.stack([s[0] for s in scans]), np.stack([s[1] for s in scans]))
        masks.append(out.cpu().numpy())
        stamps.extend(osp.splitext(osp.basename(p))[0] for p in chunk)
    masks = np.concatenate(masks, axis=0)
    np.savez_compressed(args.out, masks=masks, stamps=np.asarray(stamps))
    print(f"run: {len(paths)} scans -> {args.out} masks{masks.shape}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mm_masking_tpu_torch.deploy", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    platforms = dict(default="", help="cuda (the default: traced on the card) or cpu")

    e = sub.add_parser("export", help="run dir -> mask artifact")
    e.add_argument("--checkpoint", required=True,
                   help="Trainer run dir (config.json + <name>.pt checkpoints)")
    e.add_argument("--checkpoint-name", default="best_policy")
    e.add_argument("--out", required=True)
    e.add_argument("--batch", default="b",
                   help="'b' = symbolic (any batch size), or a fixed int")
    e.add_argument("--platforms", **platforms)
    e.set_defaults(fn=_cmd_export)

    el = sub.add_parser("export-localizer",
                        help="registration step (clouds->pose) -> artifact")
    el.add_argument("--out", required=True)
    el.add_argument("--n-points", type=int, default=4096)
    el.add_argument("--n-map", type=int, default=16384)
    el.add_argument("--batch", default="b",
                    help="'b' = symbolic (any batch size), or a fixed int")
    el.add_argument("--platforms", **platforms)
    el.add_argument("--cfg", action="append", metavar="KEY=VALUE",
                    help="LocalizationConfig overrides, e.g. --cfg icp_type=pt2pt "
                         "--cfg refined_max_iter=30")
    el.set_defaults(fn=_cmd_export_localizer)

    i = sub.add_parser("info", help="print an artifact's header")
    i.add_argument("artifact")
    i.set_defaults(fn=_cmd_info)

    r = sub.add_parser("run", help="artifact + raw scans -> masks.npz")
    r.add_argument("--artifact", required=True)
    r.add_argument("--scans", required=True,
                   help="raw Navtech scan file or directory (.npy/.png)")
    r.add_argument("--out", required=True)
    r.add_argument("--batch-size", type=int, default=32,
                   help="scans per call (the max normalisation's statistics span one chunk)")
    r.set_defaults(fn=_cmd_run)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
