"""Training and evaluation loop (counterpart of ``mm_masking_tpu.train.trainer``).

The same epoch structure as the JAX package and the reference
(``train_icp_weights.py:346-587``): baselines → pre-training validation →
per epoch a train pass and a validation pass → best and per-epoch
checkpoints → a final validation of the best parameters. One
:meth:`Trainer.train_step` runs the UNet forward with dropout, the weight
lookup, the unrolled differentiable ICP and the 6-term loss, then the
backward pass and the optimizer update.

The port runs eagerly on one device. The optimizer updates the parameters
in place (``TrainState.params`` are the tensors it owns), where the JAX
step returns new arrays; a caller that needs the old values copies them.
The JAX package's image artifacts (PNG masks) and remote uploader are not
ported: the port logs its scalars to the JSONL log only.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Iterable

import torch

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.models.policy import LearnICPWeightPolicy
from mm_masking_tpu_torch.ops import extract_bev_from_pts
from mm_masking_tpu_torch.train.checkpoint import latest_epoch, load_checkpoint, save_checkpoint
from mm_masking_tpu_torch.train.loss import (
    LossComponents,
    eval_training_loss,
    eval_validation_loss,
    fft_threshold_mask,
)
from mm_masking_tpu_torch.train.metrics import MetricsLogger
from mm_masking_tpu_torch.train.optim import Optimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]  # the UNet's state_dict; trained ones require grad
    opt: Optimizer
    step: int
    epoch: int
    best_norm: float
    generator: torch.Generator  # dropout masks, on the trainer's device


def to_device(batch, device: torch.device):
    """A batch (nested dicts of tensors) on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return batch.to(device)


class Trainer:
    def __init__(self, cfg: Config, device: torch.device | str,
                 logger: MetricsLogger | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.policy = LearnICPWeightPolicy(cfg, self.device)
        self.logger = logger or MetricsLogger(cfg.train.checkpoint_dir)
        self._trained = [name for name, _ in self.policy.unet.named_parameters()]

    # ------------------------------------------------------------------ init
    def init_state(self, seed: int | None = None) -> TrainState:
        """Xavier-initialised UNet parameters from a seeded CPU generator
        (the same values on any device), a fresh optimizer, and the dropout
        generator seeded from the same seed on the trainer's device."""
        seed = self.cfg.train.seed if seed is None else seed
        params = self.policy.init(torch.Generator().manual_seed(seed))
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
        are not finite updates nothing and is counted by the optimizer."""
        cfg = self.cfg
        out = self.policy.apply(
            state.params, batch["loc_data"], batch["map_data"],
            batch["transforms"]["T_ml_init"], train=True, generator=state.generator,
        )
        loss, comp = eval_training_loss(
            out.T_pred, out.weight_mask, out.diff_mean_num_non0, out.mean_all_pts,
            batch["transforms"]["T_ml_gt"], batch["loc_data"], batch["map_data"],
            cfg.loss, mask_losses_active=mask_losses_active, gt_eye=cfg.model.gt_eye,
            cart_pixel_width=cfg.model.cart_pixel_width,
            cart_resolution=cfg.model.cart_resolution,
        )
        grads = torch.autograd.grad(loss, [state.params[n] for n in self._trained])
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        state.opt.step(grads)
        state.step += 1
        return state, loss.detach(), comp, grad_norm

    # ------------------------------------------------------------- eval step
    @torch.inference_mode()
    def eval_step(self, params: dict, batch: dict, binary: bool = False):
        """One inference step → (err (3,), WeightStats, weight_mask (B, H, W))."""
        out = self.policy.apply(
            params,
            batch["loc_data"],
            batch["map_data"],
            batch["transforms"]["T_ml_init"],
            train=False,
            binary=binary,
        )
        err = eval_validation_loss(
            out.T_pred, batch["transforms"]["T_ml_gt"], gt_eye=self.cfg.model.gt_eye)
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
            state, loss, comp, gnorm = self.train_step(
                state, to_device(batch, self.device), mask_losses_active=mask_on)
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

    def validate(self, params: dict, batches: Iterable, binary: bool = False):
        """Mean error triple over the batches, and the weight statistics:
        (err (3,), mean_num_pc, mean_w, max_w, min_w). One host readback at
        the end."""
        errs, num_pc, ws, max_ws, min_ws = [], [], [], [], []
        for batch in batches:
            err, stats, _ = self.eval_step(params, to_device(batch, self.device),
                                           binary=binary)
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
    def generate_baseline(self, state: TrainState, batches: Iterable,
                          baseline_type: str = "val", binary: bool = False,
                          mask_kind: str = "auto"):
        """Initial-guess vs baseline-mask ICP losses → (init, baseline) means
        (``train_icp_weights.py:275-344``). ``mask_kind="auto"`` picks the
        baseline mask by the active loss weights: the CFAR image, the FFT
        threshold mask, the map BEV, else all ones; "ones", "cfar", "fft"
        and "mask_pts" force one."""
        cfg = self.cfg
        init_hist, base_hist = [], []
        for batch in batches:
            batch = to_device(batch, self.device)
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
                                    override_mask=mask)
            if baseline_type == "train":
                kw = dict(gt_eye=cfg.model.gt_eye,
                          cart_pixel_width=cfg.model.cart_pixel_width,
                          cart_resolution=cfg.model.cart_resolution)
                li, _ = eval_training_loss(T_init, mask, out.diff_mean_num_non0,
                                           out.mean_all_pts, T_gt, scan, mp, cfg.loss, **kw)
                lo, _ = eval_training_loss(out.T_pred, mask, out.diff_mean_num_non0,
                                           out.mean_all_pts, T_gt, scan, mp, cfg.loss, **kw)
            else:
                li = eval_validation_loss(T_init, T_gt, gt_eye=cfg.model.gt_eye)[0]
                lo = eval_validation_loss(out.T_pred, T_gt, gt_eye=cfg.model.gt_eye)[0]
            init_hist.append(li)
            base_hist.append(lo)
        return float(torch.stack(init_hist).mean()), float(torch.stack(base_hist).mean())

    # ----------------------------------------------------------- checkpoints
    def save(self, state: TrainState, name: str) -> str:
        return save_checkpoint(self.cfg.train.checkpoint_dir, name, {
            "params": {k: v.detach() for k, v in state.params.items()},
            "opt": state.opt.state_dict(),
            "step": state.step,
            "epoch": state.epoch,
            "best_norm": state.best_norm,
            "generator": state.generator.get_state(),
        })

    def restore(self, state: TrainState, name: str) -> TrainState:
        """Load checkpoint ``name`` into ``state`` (in place) and return it."""
        ckpt = load_checkpoint(self.cfg.train.checkpoint_dir, name, map_location="cpu")
        with torch.no_grad():
            for k, v in ckpt["params"].items():
                state.params[k].copy_(v)
        state.opt.load_state_dict(ckpt["opt"])
        state.step, state.epoch = ckpt["step"], ckpt["epoch"]
        state.best_norm = ckpt["best_norm"]
        state.generator.set_state(ckpt["generator"])
        return state

    def resume(self, state: TrainState | None = None) -> TrainState:
        """Restore the latest epoch checkpoint, if any (deterministic resume)."""
        state = state if state is not None else self.init_state()
        n = latest_epoch(self.cfg.train.checkpoint_dir)
        if n is None:
            return state
        state = self.restore(state, f"epoch_{n}")
        self.logger.log("resume", {"epoch": state.epoch})
        return state

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

        os.makedirs(ckpt_dir, exist_ok=True)
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=1)

        t0 = time.time()
        tr_init, tr_ones = self.generate_baseline(state, train_batches_fn(0),
                                                  baseline_type="train")
        va_init, va_ones = self.generate_baseline(state, val_batches_fn(),
                                                  baseline_type="val", binary=binary)
        log.log("baseline", {"train_init": tr_init, "train_ones": tr_ones,
                             "val_init": va_init, "val_ones": va_ones,
                             "elapsed": time.time() - t0})

        err, *_ = self.validate(state.params, val_batches_fn(), binary=binary)
        best_norm = float(err[0])
        log.log("pretrain_val", {"norm": best_norm, "rot": float(err[1]),
                                 "trans": float(err[2])})

        for epoch in range(state.epoch, num_epochs):
            tic = time.time()
            state, mean_loss, comp = self.train_epoch(state, train_batches_fn(epoch), epoch)
            train_time = time.time() - tic

            tic = time.time()
            err, mean_num_pc, mean_w, max_w, min_w = self.validate(
                state.params, val_batches_fn(), binary=binary)
            val_time = time.time() - tic
            norm = float(err[0])

            if norm < best_norm or epoch == 0:
                best_norm = norm
                self.save(state, "best_policy")
            state.epoch, state.best_norm = epoch + 1, best_norm
            if (epoch + 1) % cfg.train.checkpoint_every == 0:
                self.save(state, f"epoch_{epoch}")

            log.log("epoch", {
                "epoch": epoch, "loss": mean_loss, **comp,
                "acc": norm, "acc_rot": float(err[1]), "acc_trans": float(err[2]),
                "mean_num_pc": mean_num_pc, "mean_w": mean_w,
                "max_w": max_w, "min_w": min_w,
                "epoch_train_time": train_time, "epoch_val_time": val_time,
                "train_init_baseline": tr_init, "train_ones_baseline": tr_ones,
                "val_init_baseline": va_init, "val_ones_baseline": va_ones,
                "best_norm": best_norm,
            })

        best = load_checkpoint(ckpt_dir, "best_policy", map_location=self.device)["params"]
        err, *_ = self.validate(best, val_batches_fn(), binary=binary)
        log.log("final_val", {"norm": float(err[0]), "rot": float(err[1]),
                              "trans": float(err[2])})
        return state
