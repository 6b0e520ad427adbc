"""Rank bodies of the port's mesh tests (``tests/test_torch_mesh.py``).

:func:`spawn` starts ``world`` processes, each on one intra-op thread, in a
gloo group on the CPU under a file-store rendezvous; every process runs the
listed jobs in order and saves each job's result as
``<out_dir>/<job>_<rank>.pt``. The module imports only torch and the port,
so a rank starts without JAX.
"""
from __future__ import annotations

import json
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _params(state) -> dict:
    return {k: v.detach().clone() for k, v in state.params.items()}


def _epochs(path: str) -> list[dict]:
    if not os.path.exists(path):
        return []
    return [r for r in map(json.loads, open(path)) if r["event"] == "epoch"]


def job_fit(mesh, cfg, train, val, init_params=None, resume=False):
    """A 2-epoch fit over the mesh (from ``init_params`` when given); with
    ``resume``, then a fresh trainer restores ``epoch_0`` and fits on to the
    same end. Returns the final parameters and rank 0's epoch records."""
    from mm_masking_tpu_torch.train import Trainer

    tr = Trainer(cfg, "cpu", mesh=mesh)
    state = tr.init_state()
    if init_params is not None:
        with torch.no_grad():
            for k, v in init_params.items():
                state.params[k].copy_(v)
    state = tr.fit(lambda epoch: train, lambda: val, state=state, num_epochs=2)
    out = {"params": _params(state), "records": _epochs(tr.logger.path),
           "step": state.step}
    if resume:
        tr2 = Trainer(cfg, "cpu", mesh=mesh)
        restored = tr2.restore(tr2.init_state(), "epoch_0")
        out["resumed_epoch"] = restored.epoch
        out["resumed"] = _params(tr2.fit(lambda epoch: train, lambda: val, state=restored,
                                         num_epochs=2))
    return out


def job_mask(mesh, cfg, params, fft, cfar):
    """The policy's mask of this rank's rows, normalised over the mesh,
    gathered."""
    from mm_masking_tpu_torch.models import LearnICPWeightPolicy
    from mm_masking_tpu_torch.parallel import shard_axis

    policy = LearnICPWeightPolicy(cfg, "cpu")
    with torch.no_grad():
        mask = policy.compute_mask(params, shard_axis(fft, mesh, 0), shard_axis(cfar, mesh, 0),
                                   mesh=mesh)
    return mesh.gather(mask)


def job_hinge(mesh, cfg, params, batch, mask):
    """The hinged point-count loss of an override mask over the mesh: the
    loss and the mask's gradient, gathered."""
    from mm_masking_tpu_torch.models import LearnICPWeightPolicy
    from mm_masking_tpu_torch.parallel import batch_mesh, shard_batch
    from mm_masking_tpu_torch.train import eval_training_loss

    policy = LearnICPWeightPolicy(cfg, "cpu")
    local = shard_batch({**batch, "mask": mask}, mesh)
    m = batch_mesh(local, mesh)
    own = local["mask"].clone().requires_grad_(True)
    out = policy.apply(params, local["loc_data"], local["map_data"],
                       local["transforms"]["T_ml_init"], train=True, override_mask=own,
                       mesh=m, rows=(local.start, local.total))
    loss, comp = eval_training_loss(out.T_pred, out.weight_mask, out.diff_mean_num_non0,
                                    out.mean_all_pts, local["transforms"]["T_ml_gt"],
                                    local["loc_data"], local["map_data"], cfg.loss,
                                    cart_pixel_width=cfg.model.cart_pixel_width,
                                    cart_resolution=cfg.model.cart_resolution, mesh=m)
    (grad,) = torch.autograd.grad(loss, own)
    return {"loss": loss.detach(), "num_pts": comp.num_pts, "grad": mesh.gather(grad)}


def job_step(mesh, cfg, batch, steps=1, init_params=None):
    """``steps`` train steps over the mesh from a seeded state (or from
    ``init_params``): each step's loss, components and grad_norm, the final
    parameters (the batch norm's running statistics included)."""
    from mm_masking_tpu_torch.train import Trainer

    tr = Trainer(cfg, "cpu", mesh=mesh)
    state = tr.init_state(0)
    if init_params is not None:
        with torch.no_grad():
            for k, v in init_params.items():
                state.params[k].copy_(v)
    out = []
    for _ in range(steps):
        _, loss, comp, gn = tr.train_step(state, batch)
        out.append({"loss": loss, "comp": torch.stack(comp), "grad_norm": gn,
                    "params": _params(state)})
    return out


def job_localize(mesh, cfg_loc, frames, map_pc, T0, batch_size, policy_cfg=None,
                 params=None):
    """``localize_sequence`` (with the policy's mask when given) and
    ``localize_cloud_sequence`` of the frames' clouds over the mesh."""
    from mm_masking_tpu_torch.localization import pipeline
    from mm_masking_tpu_torch.models import LearnICPWeightPolicy

    policy = LearnICPWeightPolicy(policy_cfg, "cpu") if policy_cfg is not None else None
    seq = pipeline.localize_sequence(frames, map_pc, cfg_loc, T_inits=T0,
                                     batch_size=batch_size, mesh=mesh, weight_policy=policy,
                                     policy_variables=params)
    clouds = pipeline.localize_cloud_sequence(seq["points"], map_pc, cfg_loc, T_inits=T0,
                                              batch_size=batch_size, mesh=mesh)
    return {"seq": seq, "clouds": clouds}


def job_sweep(mesh, cfg, sequences):
    """``evaluate_policy_on_sequences`` through a trainer with the mesh."""
    from mm_masking_tpu_torch.evaluation import evaluate_policy_on_sequences
    from mm_masking_tpu_torch.train import Trainer

    tr = Trainer(cfg, "cpu", mesh=mesh)
    return evaluate_policy_on_sequences(tr, tr.init_state(0),
                                        {k: (lambda v=v: v) for k, v in sequences.items()})


JOBS = {"fit": job_fit, "mask": job_mask, "hinge": job_hinge, "step": job_step,
        "localize": job_localize, "sweep": job_sweep}


def _rank(rank: int, world: int, store: str, jobs: list, out_dir: str) -> None:
    from mm_masking_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh()
        for name, (job, kwargs) in jobs:
            result = JOBS[job](mesh, **kwargs)
            torch.save(result, os.path.join(out_dir, f"{name}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(jobs: list, out_dir: str, world: int = 2) -> dict:
    """Run ``jobs`` ([(name, (job, kwargs)), …]) on ``world`` ranks; returns
    {name: [rank 0's result, rank 1's, …]}."""
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    mp.start_processes(_rank, args=(world, store, jobs, out_dir), nprocs=world,
                       start_method="spawn", join=True)
    return {name: [torch.load(os.path.join(out_dir, f"{name}_{r}.pt"), weights_only=False)
                   for r in range(world)] for name, _ in jobs}

