"""Training and evaluation loop (counterpart of ``mm_masking_tpu.train.trainer``).

The same epoch structure as the JAX package and the reference
(``train_icp_weights.py:346-587``): baselines → pre-training validation →
per epoch a train pass and a validation pass → best and per-epoch
checkpoints → a final validation of the best parameters. One
:meth:`Trainer.train_step` runs the UNet forward with dropout, the weight
lookup, the unrolled differentiable ICP and the 6-term loss, then the
backward pass and the optimizer update.

Over a mesh of cards (``Trainer(cfg, device, mesh=make_mesh())``, one
process a card, :mod:`mm_masking_tpu_torch.parallel`) each rank takes its
rows of every batch, every batch statistic is the global batch's, and the
gradients are summed over the ranks as one flat buffer before the
gradient norm and the optimizer, so every rank takes the one-device step;
each dropout mask is the global batch's, of which the rank keeps its rows.
The validation errors are the gathered items'. Rank 0 alone writes the
checkpoints, the metrics log, the run's config and artifacts, and uploads;
every rank restores. Without a mesh the trainer takes
``make_mesh(train.num_devices)``: the trivial mesh of this process unless a
process group is initialised.

The optimizer updates the parameters in place
(``TrainState.params`` are the tensors it owns), where the JAX step returns
new arrays; a caller that needs the old values copies them. Where the JAX
step is one compiled program, the port's train step on the card is one
CUDA graph, captured once per state and batch shapes and then replayed
(:mod:`mm_masking_tpu_torch.graphs`); the eval step's solve replays its
own graphs. ``ops.kernels.eager()`` runs both eagerly for comparison, and
on the CPU they always run eagerly.

As in the JAX package, ``fit`` writes the validation artifacts (the learned
mask of the first validation item before training and after every epoch;
before training also its raw scan, CFAR, FFT-threshold and map-BEV masks)
as PNGs into the logger's artifact directory, and streams the run's
parameters, every logged record and the best checkpoint through the
logger's uploader (a no-op without ``MM_UPLOAD_URL``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Iterable

import torch

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.graphs import CapturedStep
from mm_masking_tpu_torch.models.policy import LearnICPWeightPolicy
from mm_masking_tpu_torch.ops import extract_bev_from_pts
from mm_masking_tpu_torch.ops.kernels import use_graphs
from mm_masking_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedBatch,
    batch_mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from mm_masking_tpu_torch.train.checkpoint import latest_epoch, load_checkpoint, save_checkpoint
from mm_masking_tpu_torch.train.loss import (
    LossComponents,
    eval_training_loss,
    eval_validation_loss,
    fft_threshold_mask,
)
from mm_masking_tpu_torch.train.metrics import MetricsLogger
from mm_masking_tpu_torch.train.optim import Optimizer, make_optimizer
from mm_masking_tpu_torch.utils import profiling
from mm_masking_tpu_torch.utils.visualize import save_mask_image


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # the UNet's state_dict; trained ones require grad
    opt: Optimizer
    step: int
    epoch: int
    best_norm: float
    generator: torch.Generator  # dropout masks, on the trainer's device
    # The train step's CUDA graphs, by batch shapes and options (on the card
    # only). They read and write this state's parameters, optimizer tensors
    # and generator: load new values into those in place (``restore`` does),
    # never replace them.
    graphs: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)


@dataclasses.dataclass
class _TrainGraph:
    inputs: list[torch.Tensor]  # static batch leaves, in _leaves order
    step: CapturedStep
    marks: profiling.Phases  # the phase marks captured in the graph


def to_device(batch, device: torch.device):
    """A batch (nested dicts of tensors) on ``device``; a
    :class:`ShardedBatch` stays one."""
    if isinstance(batch, ShardedBatch):
        return ShardedBatch(to_device(dict(batch), device), batch.start, batch.total)
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return batch.to(device)


def _leaves(batch, path: tuple = ()) -> list[tuple[tuple, torch.Tensor]]:
    """(key path, tensor) of each leaf of a batch, in its dicts' order."""
    if isinstance(batch, dict):
        return [leaf for k, v in batch.items() for leaf in _leaves(v, path + (k,))]
    return [(path, batch)]


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current card>``; other devices as they are."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _clone(batch):
    if isinstance(batch, dict):
        return {k: _clone(v) for k, v in batch.items()}
    return batch.clone()


class Trainer:
    def __init__(self, cfg: Config, device: torch.device | str,
                 logger: MetricsLogger | None = None, mesh: Mesh | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else make_mesh(cfg.train.num_devices, self.device)
        if _indexed(self.mesh.device) != _indexed(self.device):
            raise ValueError(f"the mesh computes on {self.mesh.device}, the trainer on "
                             f"{self.device}")
        self.lead = self.mesh.rank == 0  # the rank that writes and uploads
        self.policy = LearnICPWeightPolicy(cfg, self.device)
        self.logger = logger or MetricsLogger(cfg.train.checkpoint_dir)
        self._trained = [name for name, _ in self.policy.unet.named_parameters()]
        self._pool = None  # the memory pool its train-step graphs share
        self._marks = profiling.Phases(self.device)  # the eager train step's phase marks

    def local_batch(self, batch) -> tuple[dict, Mesh | None, tuple[int, int] | None]:
        """This rank's rows of a batch on the trainer's device, the mesh its
        reductions run over (None for a replicated batch or no mesh) and its
        rows (first row, global rows)."""
        batch = to_device(shard_batch(batch, self.mesh), self.device)
        mesh = batch_mesh(batch, self.mesh)
        return batch, mesh, (batch.start, batch.total) if mesh is not None else None

    def _check_graphs(self) -> None:
        """A step that reduces over gloo cannot be captured: gloo's
        collectives wait on the host."""
        if use_graphs(self.device) and self.mesh.backend == "gloo":
            raise RuntimeError("a gloo process group cannot run inside a CUDA graph: use "
                               "NCCL on the card, or run the steps under "
                               "ops.kernels.eager()")

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int | None = None) -> TrainState:
        """Xavier-initialised UNet parameters from a seeded CPU generator
        (the same values on any device), a fresh optimizer, and the dropout
        generator seeded from the same seed on the trainer's device."""
        seed = self.cfg.train.seed if seed is None else seed
        params = replicate(self.policy.init(torch.Generator().manual_seed(seed)), self.mesh)
        for name in self._trained:
            params[name].requires_grad_(True)
        return TrainState(
            params=params,
            opt=make_optimizer(self.cfg.train, [params[n] for n in self._trained]),
            step=0, epoch=0, best_norm=float("inf"),
            generator=torch.Generator(device=self.device).manual_seed(seed),
        )

    # ------------------------------------------------------------ train step
    def train_step(self, state: TrainState, batch: dict, mask_losses_active: bool = True):
        """One step → (state, loss, LossComponents, grad_norm). The state's
        parameters and optimizer are updated in place; a step whose gradients
        are not finite updates nothing and is counted by the optimizer.

        On the card the step is a CUDA graph: the first call for this state
        and these batch shapes warms the step up (and undoes what that run
        changed), captures it, and every call replays it on the batch copied
        into the graph's inputs. A failed capture raises.

        ``batch``: the global batch (or a :class:`ShardedBatch` of this
        rank's rows); under a mesh each rank steps on its rows.

        The step is a step record and span ``mm.train.step``; the phases of
        its work are marked (:func:`profiling.phase_ms`)."""
        with profiling.step("train"):
            self._check_graphs()
            batch, mesh, rows = self.local_batch(batch)
            if use_graphs(self.device):
                loss, comp, grad_norm = self._replay_train_step(state, batch,
                                                                mask_losses_active, mesh, rows)
            else:
                with profiling.phases(self._marks):
                    loss, comp, grad_norm = self._step(state, batch, mask_losses_active, mesh,
                                                       rows)
        state.step += 1
        return state, loss, comp, grad_norm

    def _step(self, state: TrainState, batch: dict, mask_losses_active: bool,
              mesh: Mesh | None = None, rows: tuple[int, int] | None = None):
        """The step's work, run eagerly or captured: forward with dropout,
        loss, gradients (summed over the ``mesh`` as one flat buffer),
        grad_norm and the optimizer's update; nothing in it reads the device
        from the host. Its phase marks, in order: ``start``; the policy's
        ``unet.fwd``, ``lookup.fwd``, ``icp.fwd``; ``loss.fwd``; the
        backward's ``loss.bwd``, ``icp.bwd``, ``lookup.bwd`` (the gradient
        reaching the pose, the weights, the mask) and ``unet.bwd`` (its end);
        ``optim`` (the gradient norm and the update)."""
        cfg = self.cfg
        profiling.mark("start")
        out = self.policy.apply(
            state.params, batch["loc_data"], batch["map_data"],
            batch["transforms"]["T_ml_init"], train=True, generator=state.generator,
            mesh=mesh, rows=rows,
        )
        loss, comp = eval_training_loss(
            out.T_pred, out.weight_mask, out.diff_mean_num_non0, out.mean_all_pts,
            batch["transforms"]["T_ml_gt"], batch["loc_data"], batch["map_data"],
            cfg.loss, mask_losses_active=mask_losses_active, gt_eye=cfg.model.gt_eye,
            cart_pixel_width=cfg.model.cart_pixel_width,
            cart_resolution=cfg.model.cart_resolution, mesh=mesh,
        )
        profiling.mark("loss.fwd")
        grads = torch.autograd.grad(loss, [state.params[n] for n in self._trained])
        profiling.mark("unet.bwd")
        if mesh is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            torch.distributed.all_reduce(flat, group=mesh.group)
            grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]),
                                                  grads)]
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        state.opt.step(grads)
        profiling.mark("optim")
        return loss.detach(), comp, grad_norm

    def capture_train_step(self, state: TrainState, batch: dict,
                           mask_losses_active: bool = True) -> None:
        """Capture the train step's graph for this state and these batch
        shapes now, if it is not captured yet (``train_step`` does it at its
        first call); the state is left as it was. A no-op off the card."""
        if use_graphs(self.device):
            self._check_graphs()
            self._train_graph(state, *self.local_batch(batch), mask_losses_active)

    def _train_graph(self, state: TrainState, batch: dict, mesh: Mesh | None,
                     rows: tuple[int, int] | None, mask_losses_active: bool) -> _TrainGraph:
        key = (self.cfg, mask_losses_active, rows,
               tuple((path, t.shape, t.dtype) for path, t in _leaves(batch)))
        if key not in state.graphs:
            state.graphs[key] = self._capture_train_step(state, batch, mask_losses_active,
                                                         mesh, rows)
        return state.graphs[key]

    def _replay_train_step(self, state: TrainState, batch: dict, mask_losses_active: bool,
                           mesh: Mesh | None, rows: tuple[int, int] | None):
        graph = self._train_graph(state, batch, mesh, rows, mask_losses_active)
        with profiling.span("mm.train.copy_in"):
            for dst, (_, src) in zip(graph.inputs, _leaves(batch)):
                dst.copy_(src)
        with profiling.span("mm.train.replay"):
            loss, comp, grad_norm = graph.step.replay()
        profiling.replayed(graph.marks)
        with profiling.span("mm.train.copy_out"):
            # Copies: the next replay overwrites the graph's outputs.
            return loss.clone(), LossComponents(*(c.clone() for c in comp)), grad_norm.clone()

    def _capture_train_step(self, state: TrainState, batch: dict, mask_losses_active: bool,
                            mesh: Mesh | None, rows: tuple[int, int] | None) -> _TrainGraph:
        """Capture the step on static copies of the batch. The warm-up run
        before the capture is undone: parameters, optimizer state, the batch
        norm's running statistics and the dropout generator are put back as
        they were. Under a NCCL mesh the warm-up's all-reduces set up the
        communicator, and the capture holds them."""
        static = _clone(batch)
        buffers = [t for n, t in state.params.items() if n not in self._trained]
        mutable = state.opt.tensors() + buffers
        # Detached: a clone in the autograd graph would keep the parameters'
        # gradient accumulators alive on this stream.
        saved = [t.detach().clone() for t in mutable]
        gen_state = state.generator.get_state()

        def undo():
            with torch.no_grad():
                for t, v in zip(mutable, saved):
                    t.copy_(v)
            state.generator.set_state(gen_state)

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        marks = profiling.Phases(self.device)

        def fn():
            with profiling.phases(marks):
                return self._step(state, static, mask_losses_active, mesh, rows)

        step = CapturedStep(fn, self.device, undo=undo, generators=(state.generator,),
                            pool=self._pool)
        return _TrainGraph([t for _, t in _leaves(static)], step, marks)

    # ------------------------------------------------------------- eval step
    @torch.inference_mode()
    def eval_step(self, params: dict, batch: dict, binary: bool = False):
        """One inference step → (err (3,), WeightStats, weight_mask (B, H, W)).
        Under a mesh the error and the statistics are the global batch's
        (the poses gathered), and the mask is this rank's rows. The step is
        a step record and span ``mm.eval.step``; the policy's and the
        solve's spans lie inside it, then ``mm.eval.loss``."""
        with profiling.step("eval"):
            self._check_graphs()
            batch, mesh, _ = self.local_batch(batch)
            out = self.policy.apply(
                params,
                batch["loc_data"],
                batch["map_data"],
                batch["transforms"]["T_ml_init"],
                train=False,
                binary=binary,
                mesh=mesh,
            )
            with profiling.span("mm.eval.loss"):
                err = eval_validation_loss(
                    out.T_pred, batch["transforms"]["T_ml_gt"], gt_eye=self.cfg.model.gt_eye,
                    mesh=mesh)
        return err, out.stats, out.weight_mask

    # ------------------------------------------------------------ public API
    def train_epoch(self, state: TrainState, batches: Iterable, epoch: int):
        """Train over the batches → (state, mean loss, {component means,
        grad_norm, grad_norm_max, notfinite_count}). One host readback at
        the end."""
        it = self.cfg.train.icp_loss_only_iter
        mask_on = it <= 0 or epoch < it
        losses, comps, gnorms = [], [], []
        for batch in batches:
            state, loss, comp, gnorm = self.train_step(state, batch, mask_losses_active=mask_on)
            losses.append(loss)
            comps.append(torch.stack(comp))
            gnorms.append(gnorm)
        mean_comp = dict(zip(LossComponents._fields,
                             torch.stack(comps).mean(0).tolist()))
        g = torch.stack(gnorms)
        mean_comp["grad_norm"] = float(g.mean())
        mean_comp["grad_norm_max"] = float(g.max())
        mean_comp["notfinite_count"] = float(state.opt.total_notfinite)
        return state, float(torch.stack(losses).mean()), mean_comp

    def validate(self, params: dict, batches: Iterable, binary: bool = False,
                 epoch: int | None = None, dump_artifacts: bool = False):
        """Mean error triple over the batches, and the weight statistics:
        (err (3,), mean_num_pc, mean_w, max_w, min_w). One host readback at
        the end, and with ``dump_artifacts`` one after the first batch, whose
        artifacts :meth:`_dump_artifacts` writes (rank 0: its rows begin
        with the batch's first)."""
        errs, num_pc, ws, max_ws, min_ws = [], [], [], [], []
        for n, batch in enumerate(batches):
            batch, _, _ = self.local_batch(batch)
            err, stats, mask = self.eval_step(params, batch, binary=binary)
            if dump_artifacts and n == 0 and self.lead:
                self._dump_artifacts(batch, mask, epoch)
            errs.append(err)
            num_pc.append(stats.mean_num_non0)
            ws.append(stats.mean_w)
            max_ws.append(stats.max_w)
            min_ws.append(stats.min_w)
        return (
            torch.stack(errs).mean(0),
            float(torch.stack(num_pc).float().mean()),
            float(torch.stack(ws).mean()),
            float(torch.stack(max_ws).max()),
            float(torch.stack(min_ws).min()),
        )

    @torch.no_grad()
    def _dump_artifacts(self, batch: dict, mask: torch.Tensor, epoch: int | None) -> None:
        """The JAX package's validation artifacts, as PNGs in the logger's
        artifact directory: ``learned_mask_e<epoch>`` (``learned_mask_epre``
        before training) of the first item; before training (epoch < 0) also its
        ``raw_scan``, ``cfar_mask``, ``fft_mask`` (FFT over 3× the scan's
        mean) and ``map_mask`` (the map's BEV)."""
        art_dir = self.logger.art_dir
        tag = "pre" if (epoch is None or epoch < 0) else str(epoch)
        save_mask_image(mask[0].cpu().numpy(), art_dir, f"learned_mask_e{tag}")
        if epoch is None or epoch >= 0:
            return
        m = self.cfg.model
        fft = batch["loc_data"]["fft_data"]
        save_mask_image(fft[0].cpu().numpy(), art_dir, "raw_scan")
        save_mask_image(batch["loc_data"]["fft_cfar"][0].cpu().numpy(), art_dir, "cfar_mask")
        fft_mask = (fft > 3.0 * fft.mean(dim=(1, 2), keepdim=True)).float()
        save_mask_image(fft_mask[0].cpu().numpy(), art_dir, "fft_mask")
        bev = extract_bev_from_pts(batch["map_data"]["pc"][..., :3],
                                   cart_pixel_width=m.cart_pixel_width,
                                   cart_resolution=m.cart_resolution)
        save_mask_image(bev[0].cpu().numpy(), art_dir, "map_mask")

    @torch.no_grad()
    def generate_baseline(self, state: TrainState, batches: Iterable,
                          baseline_type: str = "val", binary: bool = False,
                          mask_kind: str = "auto"):
        """Initial-guess vs baseline-mask ICP losses → (init, baseline) means
        (``train_icp_weights.py:275-344``). ``mask_kind="auto"`` picks the
        baseline mask by the active loss weights: the CFAR image, the FFT
        threshold mask, the map BEV, else all ones; "ones", "cfar", "fft"
        and "mask_pts" force one. Under a mesh the losses are the global
        batch's."""
        cfg = self.cfg
        init_hist, base_hist = [], []
        for batch in batches:
            batch, mesh, rows = self.local_batch(batch)
            scan, mp = batch["loc_data"], batch["map_data"]
            if mask_kind == "cfar" or (mask_kind == "auto" and cfg.loss.cfar > 0.0):
                mask = scan["fft_cfar"]
            elif mask_kind == "fft" or (mask_kind == "auto" and cfg.loss.fft > 0.0):
                mask = fft_threshold_mask(scan["fft_data"])
            elif mask_kind == "mask_pts" or (mask_kind == "auto" and cfg.loss.mask_pts > 0.0):
                mask = extract_bev_from_pts(mp["pc"][..., :3],
                                            cart_pixel_width=cfg.model.cart_pixel_width,
                                            cart_resolution=cfg.model.cart_resolution)
            else:
                mask = torch.ones_like(scan["fft_data"])
            T_gt = batch["transforms"]["T_ml_gt"]
            T_init = batch["transforms"]["T_ml_init"]
            out = self.policy.apply(state.params, scan, mp, T_init,
                                    train=(baseline_type == "train"), binary=binary,
                                    override_mask=mask, mesh=mesh, rows=rows)
            if baseline_type == "train":
                kw = dict(gt_eye=cfg.model.gt_eye,
                          cart_pixel_width=cfg.model.cart_pixel_width,
                          cart_resolution=cfg.model.cart_resolution, mesh=mesh)
                li, _ = eval_training_loss(T_init, mask, out.diff_mean_num_non0,
                                           out.mean_all_pts, T_gt, scan, mp, cfg.loss, **kw)
                lo, _ = eval_training_loss(out.T_pred, mask, out.diff_mean_num_non0,
                                           out.mean_all_pts, T_gt, scan, mp, cfg.loss, **kw)
            else:
                li = eval_validation_loss(T_init, T_gt, gt_eye=cfg.model.gt_eye, mesh=mesh)[0]
                lo = eval_validation_loss(out.T_pred, T_gt, gt_eye=cfg.model.gt_eye,
                                          mesh=mesh)[0]
            init_hist.append(li)
            base_hist.append(lo)
        return float(torch.stack(init_hist).mean()), float(torch.stack(base_hist).mean())

    # ----------------------------------------------------------- checkpoints
    def save(self, state: TrainState, name: str) -> str:
        """Write checkpoint ``name`` (rank 0; under a mesh every rank waits
        for it, so that any rank may restore it next)."""
        path = os.path.join(os.path.abspath(self.cfg.train.checkpoint_dir), f"{name}.pt")
        if self.lead:
            path = self._write(state, name)
        if self.mesh.group is not None:
            torch.distributed.barrier(group=self.mesh.group)
        return path

    def _write(self, state: TrainState, name: str) -> str:
        return save_checkpoint(self.cfg.train.checkpoint_dir, name, {
            "params": {k: v.detach() for k, v in state.params.items()},
            "opt": state.opt.state_dict(),
            "step": state.step,
            "epoch": state.epoch,
            "best_norm": state.best_norm,
            "generator": state.generator.get_state(),
        })

    def restore(self, state: TrainState, name: str) -> TrainState:
        """Load checkpoint ``name`` into ``state`` (in place: the parameters,
        the batch norm's running statistics, the optimizer, the generator)
        and return it."""
        ckpt = load_checkpoint(self.cfg.train.checkpoint_dir, name, map_location="cpu")
        with torch.no_grad():
            for k, v in ckpt["params"].items():
                state.params[k].copy_(v)
        state.opt.load_state_dict(ckpt["opt"])
        state.step, state.epoch = ckpt["step"], ckpt["epoch"]
        state.best_norm = ckpt["best_norm"]
        if ckpt["generator"] is not None:  # None: converted from JAX, no dropout stream
            state.generator.set_state(ckpt["generator"])
        return state

    def resume(self, state: TrainState | None = None) -> TrainState:
        """Restore the latest epoch checkpoint, if any (deterministic resume)."""
        state = state if state is not None else self.init_state()
        n = latest_epoch(self.cfg.train.checkpoint_dir)
        if n is None:
            return state
        state = self.restore(state, f"epoch_{n}")
        self._log("resume", {"epoch": state.epoch})
        return state

    def _log(self, event: str, payload: dict) -> None:
        if self.lead:
            self.logger.log(event, payload)

    # ------------------------------------------------------------------- fit
    def fit(
        self,
        train_batches_fn: Callable[[int], Iterable],
        val_batches_fn: Callable[[], Iterable],
        state: TrainState | None = None,
        num_epochs: int | None = None,
    ) -> TrainState:
        """The full training run, from ``state.epoch`` to ``num_epochs``."""
        cfg = self.cfg
        log = self.logger
        state = state if state is not None else self.init_state()
        num_epochs = num_epochs or cfg.train.num_epochs
        ckpt_dir = cfg.train.checkpoint_dir
        binary = cfg.model.binary_inference

        if self.lead:
            log.uploader.log_params(log.run_name, dataclasses.asdict(cfg))
            os.makedirs(ckpt_dir, exist_ok=True)
            with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=1)

        t0 = time.time()
        tr_init, tr_ones = self.generate_baseline(state, train_batches_fn(0),
                                                  baseline_type="train")
        va_init, va_ones = self.generate_baseline(state, val_batches_fn(),
                                                  baseline_type="val", binary=binary)
        self._log("baseline", {"train_init": tr_init, "train_ones": tr_ones,
                             "val_init": va_init, "val_ones": va_ones,
                             "elapsed": time.time() - t0})

        err, *_ = self.validate(state.params, val_batches_fn(), binary=binary, epoch=-1,
                                dump_artifacts=True)
        best_norm = float(err[0])
        self._log("pretrain_val", {"norm": best_norm, "rot": float(err[1]),
                                 "trans": float(err[2])})

        for epoch in range(state.epoch, num_epochs):
            wait0 = profiling.host_count("loader.wait_ns")
            tic = time.time()
            state, mean_loss, comp = self.train_epoch(state, train_batches_fn(epoch), epoch)
            train_time = time.time() - tic

            tic = time.time()
            err, mean_num_pc, mean_w, max_w, min_w = self.validate(
                state.params, val_batches_fn(), binary=binary, epoch=epoch, dump_artifacts=True)
            val_time = time.time() - tic
            norm = float(err[0])

            if norm < best_norm or epoch == 0:
                best_norm = norm
                self.save(state, "best_policy")
            state.epoch, state.best_norm = epoch + 1, best_norm
            if (epoch + 1) % cfg.train.checkpoint_every == 0:
                self.save(state, f"epoch_{epoch}")

            self._log("epoch", {
                "epoch": epoch, "loss": mean_loss, **comp,
                "acc": norm, "acc_rot": float(err[1]), "acc_trans": float(err[2]),
                "mean_num_pc": mean_num_pc, "mean_w": mean_w,
                "max_w": max_w, "min_w": min_w,
                "epoch_train_time": train_time, "epoch_val_time": val_time,
                "loader_wait_s": (profiling.host_count("loader.wait_ns") - wait0) / 1e9,
                "train_init_baseline": tr_init, "train_ones_baseline": tr_ones,
                "val_init_baseline": va_init, "val_ones_baseline": va_ones,
                "best_norm": best_norm,
            })

        best = load_checkpoint(ckpt_dir, "best_policy", map_location=self.device)["params"]
        err, *_ = self.validate(best, val_batches_fn(), binary=binary)
        self._log("final_val", {"norm": float(err[0]), "rot": float(err[1]),
                                "trans": float(err[2])})
        best_path = os.path.join(ckpt_dir, "best_policy.pt")
        if self.lead and log.uploader.enabled and os.path.isfile(best_path):
            log.uploader.upload_file(log.run_name, best_path)
        return state
