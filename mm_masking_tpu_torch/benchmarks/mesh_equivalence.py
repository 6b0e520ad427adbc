"""Train steps over a mesh of N processes against one process's steps on the
same global batch:

    torchrun --nproc-per-node N -m mm_masking_tpu_torch.benchmarks.mesh_equivalence
    torchrun --nproc-per-node 4 -m mm_masking_tpu_torch.benchmarks.mesh_equivalence \\
        --device cpu --set model.enc_channels=4,8 ...   # the training CLI's --set

Each process joins the group ``torchrun`` describes (NCCL on the card, one
card a process; gloo with ``--device cpu``). Rank 0 first takes ``--steps``
train steps on the whole batch alone; then every rank takes the same steps
over the mesh, each on its B / N rows, from the same seed. On the card both
runs replay their CUDA graphs. Rank 0 prints one JSON line: the largest
relative differences of the losses and grad_norms, the largest absolute
difference of the parameters, the host-clock ms a step of both runs, and
the devices. It exits 1 beyond ``chip_smoke.py``'s mesh-phase limits:
losses 1e-5 relative and parameters within 4 learning rates (the CPU
tests' limits), grad_norms 1e-3 relative. At full width the gradient
follows last-bit changes of the forward (another batch per launch,
another thread count) by up to 1e-3 of its max, the conditioning that the
train phase of ``chip_smoke.py`` measures with a 1-ulp nudge.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch
import torch.distributed as dist

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.device import resolve_device
from mm_masking_tpu_torch.parallel import Mesh, init_distributed, make_mesh
from mm_masking_tpu_torch.train import Trainer
from mm_masking_tpu_torch.train.train_icp_weights import apply_overrides


def _steps(trainer: Trainer, batch, steps: int, device) -> tuple[list, dict, list[float]]:
    """``steps`` train steps from the seed: (losses and grad_norms, the final
    parameters on the CPU, host-clock ms a step after the first)."""
    state = trainer.init_state(seed=0)
    trainer.capture_train_step(state, batch)
    out, ms = [], []
    for _ in range(steps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        _, loss, _, gnorm = trainer.train_step(state, batch)
        out.append((loss.item(), gnorm.item()))
        ms.append(1e3 * (time.perf_counter() - t0))
    params = {k: v.detach().cpu() for k, v in state.params.items()}
    state.graphs.clear()
    return out, params, ms[1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16, help="the global batch")
    ap.add_argument("--set", action="append", default=[], metavar="SEC.FIELD=V")
    args = ap.parse_args(argv)
    cfg = apply_overrides(Config(), args.set)
    device = init_distributed(resolve_device(args.device))
    if not dist.is_initialized():
        raise SystemExit("run under torchrun: no process group")
    try:
        mesh = make_mesh(cfg.train.num_devices, device)
        spec = SyntheticSpec(n_scan=cfg.data.max_loc_pts, n_map=cfg.data.max_map_pts,
                             polar_shape=cfg.model.polar_shape,
                             cart_pixel_width=cfg.model.cart_pixel_width, res=cfg.model.res,
                             cart_resolution=cfg.model.cart_resolution)
        batch = synthetic_batch(2, args.batch, spec, device=device)
        one = None
        if mesh.rank == 0:
            alone = Trainer(cfg, device, mesh=Mesh(None, 0, 1, device))
            one = _steps(alone, batch, args.steps, device)
        dist.barrier()
        many = _steps(Trainer(cfg, device, mesh=mesh), batch, args.steps, device)
        if mesh.rank != 0:
            return 0
        d_loss = max(abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(many[0], one[0]))
        d_gnorm = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(many[0], one[0]))
        d_param = max((many[1][k] - v).abs().max().item() for k, v in one[1].items())
        limit = 4 * cfg.train.learning_rate
        ok = d_loss <= 1e-5 and d_gnorm <= 1e-3 and d_param <= limit
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(json.dumps({
            "ok": ok, "world": mesh.size, "backend": mesh.backend, "device": name,
            "batch": args.batch, "steps": args.steps, "loss_rel": d_loss, "grad_norm_rel": d_gnorm,
            "param_abs": d_param, "param_limit": limit,
            "ms_one": statistics.median(one[2]) if one[2] else None,
            "ms_mesh": statistics.median(many[2]) if many[2] else None,
            "losses_one": [x[0] for x in one[0]], "losses_mesh": [x[0] for x in many[0]]}))
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
