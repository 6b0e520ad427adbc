"""Training entry point of the port:
``python -m mm_masking_tpu_torch.train.train_icp_weights``.

Counterpart of ``mm_masking_tpu.train.train_icp_weights``: every config field
can be set as ``--set section.field=value``, and ``--synthetic`` runs the
whole loop on generated data. Without it the run trains on a converted
Boreas-layout tree under ``data.data_dir`` (``ICPWeightDataset`` over
``train_loc_pairs`` and ``val_loc_pairs``, batched by ``epoch_batches``).
It runs on the card (``--device cuda``, the default) and raises without one;
``--device cpu`` runs it on the CPU.

Under ``torchrun --nproc-per-node N`` it trains data-parallel over N
processes: each joins the group (NCCL on the card, each rank on
``cuda:LOCAL_RANK``; gloo with ``--device cpu``), the batches are sharded
over the first ``train.num_devices`` ranks (-1: all), and rank 0 writes the
log and the checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import math

import torch.distributed as dist

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.device import resolve_device
from mm_masking_tpu_torch.parallel import init_distributed, make_mesh


def apply_overrides(cfg: Config, overrides: list[str]) -> Config:
    """``section.field=value`` items, each parsed by the field's current type.
    A tuple takes comma-separated items, integers where they parse as such
    (``model.enc_channels=4,8``) and strings otherwise
    (``model.icp_overrides=trim_dist=3,nn_stripe=false``)."""
    sections = {"model": cfg.model, "data": cfg.data, "train": cfg.train, "loss": cfg.loss}
    updates: dict[str, dict] = {k: {} for k in sections}
    for item in overrides:
        key, _, val = item.partition("=")
        section, _, field = key.strip("-").partition(".")
        if section not in sections:
            raise SystemExit(f"unknown config section '{section}' in {item}")
        current = getattr(sections[section], field)
        if isinstance(current, bool):
            parsed = val.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            parsed = int(val)
        elif isinstance(current, float):
            parsed = float(val)
        elif isinstance(current, tuple):
            parsed = tuple(int(x) if x.lstrip("-").isdigit() else x
                           for x in val.split(","))
        else:
            parsed = val
        updates[section][field] = parsed
    return dataclasses.replace(
        cfg, **{k: dataclasses.replace(sec, **updates[k]) for k, sec in sections.items()})


def _autofill_decay_steps(cfg: Config, samples_per_epoch: int) -> Config:
    """A cosine schedule without lr_decay_steps decays over the whole run."""
    t = cfg.train
    if t.lr_schedule != "cosine" or t.lr_decay_steps > 0:
        return cfg
    steps = t.num_epochs * max(1, math.ceil(samples_per_epoch / t.batch_size_train))
    print(f"lr_schedule=cosine: lr_decay_steps auto-set to {steps}")
    return dataclasses.replace(cfg, train=dataclasses.replace(t, lr_decay_steps=steps))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--synthetic", action="store_true",
                    help="train on generated data (no Boreas tree needed)")
    ap.add_argument("--synthetic-frames", type=int, default=64)
    ap.add_argument("--synthetic-fixed", action="store_true",
                    help="generate one fixed synthetic dataset on the host and "
                         "reuse it every epoch")
    ap.add_argument("--scene", default="scatter", choices=["scatter", "walls"],
                    help="synthetic scene family")
    ap.add_argument("--clutter-frac", type=float, default=0.0,
                    help="fraction of scan returns that are clutter/ghosts")
    ap.add_argument("--scene-noise", type=float, default=0.02,
                    help="scan point noise std (m)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--set", action="append", default=[], metavar="SEC.FIELD=V",
                    help="config override, e.g. --set train.num_epochs=5")
    args = ap.parse_args(argv)

    cfg = apply_overrides(Config(), args.set)
    joined = not dist.is_initialized()
    device = init_distributed(resolve_device(args.device))
    joined = joined and dist.is_initialized()  # the group is this call's to end
    try:
        _run(args, cfg, device, make_mesh(cfg.train.num_devices, device))
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args, cfg: Config, device, mesh) -> None:
    from mm_masking_tpu_torch.train.trainer import Trainer

    if not args.synthetic:
        from mm_masking_tpu_torch.data import ICPWeightDataset, epoch_batches

        train_ds = ICPWeightDataset(list(cfg.train_loc_pairs), cfg, "train")
        val_ds = ICPWeightDataset(list(cfg.val_loc_pairs), cfg, "test")
        print(f"train samples: {len(train_ds)}, val samples: {len(val_ds)}")
        cfg = _autofill_decay_steps(cfg, len(train_ds))

        def train_batches(epoch):
            return epoch_batches(train_ds, cfg.train.batch_size_train, cfg,
                                 shuffle=cfg.train.shuffle, seed=epoch, device=device,
                                 mesh=mesh)

        def val_batches():
            return epoch_batches(val_ds, cfg.train.batch_size_test, cfg,
                                 shuffle=False, drop_last=False, device=device, mesh=mesh)

        Trainer(cfg, device, mesh=mesh).fit(train_batches, val_batches)
        return

    from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch

    spec = SyntheticSpec(
        n_scan=cfg.data.max_loc_pts, n_map=cfg.data.max_map_pts,
        polar_shape=cfg.model.polar_shape, cart_pixel_width=cfg.model.cart_pixel_width,
        res=cfg.model.res, cart_resolution=cfg.model.cart_resolution,
        pos_std=cfg.data.pos_std, rot_std=cfg.data.rot_std,
        network_input_type=cfg.model.network_input_type,
        scene=args.scene, clutter_frac=args.clutter_frac, noise=args.scene_noise,
    )
    bt, bv = cfg.train.batch_size_train, cfg.train.batch_size_test
    n_train = max(1, args.synthetic_frames // bt)
    cfg = _autofill_decay_steps(cfg, n_train * bt)

    if args.synthetic_fixed:
        # Kept on the host; each step copies its batch to the device.
        fixed_train = [synthetic_batch(i, bt, spec) for i in range(n_train)]
        fixed_val = [synthetic_batch(10_000_000 + i, bv, spec) for i in range(2)]

        def train_batches(epoch):
            return iter(fixed_train)

        def val_batches():
            return iter(fixed_val)
    else:
        def train_batches(epoch):
            return (synthetic_batch(1000 * epoch + i, bt, spec, device=device)
                    for i in range(n_train))

        def val_batches():
            return (synthetic_batch(10_000_000 + i, bv, spec, device=device)
                    for i in range(2))

    Trainer(cfg, device, mesh=mesh).fit(train_batches, val_batches)


if __name__ == "__main__":
    main()
