"""Learned ICP-weight policy: UNet mask → per-point weights → ICP.

Counterpart of ``mm_masking_tpu.models.policy``. Parameters are a
``state_dict`` of :class:`UNet` applied with ``torch.func.functional_call``,
so the policy itself holds no trained state, like the JAX one. Training
(``apply(train=True, generator=…)``) runs the UNet with dropout and the
unrolled differentiable ICP; inference runs the tolerance-stopped solver.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, NamedTuple

import torch
from torch.func import functional_call

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.dicp import ICPConfig, icp
from mm_masking_tpu_torch.models.unet import UNet
from mm_masking_tpu_torch.ops import extract_weights, form_cart_range_angle_grid


class _SafeAmaxHW(torch.autograd.Function):
    """(B, H, W) → (B, 1, 1) max whose backward splits the cotangent evenly
    over the elements ≥ the max, with the tie count floored at 1: the JAX
    package's ``_safe_amax_hw``. The count floor keeps the gradient finite
    where a reduction at another precision leaves no element equal to the
    max."""

    @staticmethod
    def forward(ctx, x):
        m = x.amax(dim=(1, 2), keepdim=True)
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        ties = (x >= m).to(x.dtype)
        cnt = ties.sum(dim=(1, 2), keepdim=True).clamp(min=1.0)
        return g * ties / cnt


def _safe_amax_hw(x: torch.Tensor) -> torch.Tensor:
    return _SafeAmaxHW.apply(x)


class PolicyOutput(NamedTuple):
    T_pred: torch.Tensor  # (B, 4, 4)
    weight_mask: torch.Tensor  # (B, H, W)
    diff_mean_num_non0: torch.Tensor
    stats: Any  # WeightStats
    mean_all_pts: torch.Tensor | None = None
    # inference: {'iterations': int, 'delta_norm': (B,)}; training:
    # {'delta_norms': (max_iter, B)}; None when training skips the ICP
    icp_info: dict | None = None


def _coerce(field: dataclasses.Field, raw: str):
    """Parse an ``icp_overrides`` value by the ICPConfig field's declared type,
    so fields typed ``bool | None`` (default None) take true/false/none."""
    hint = typing.get_type_hints(ICPConfig)[field.name]
    kinds = typing.get_args(hint) or (hint,)
    if type(None) in kinds and raw.lower() in ("none", "null"):
        return None
    if bool in kinds:
        return raw.lower() in ("1", "true", "yes")
    for kind in (int, float, str):
        if kind in kinds:
            return kind(raw)
    raise TypeError(f"cannot parse override {field.name}={raw}")


class LearnICPWeightPolicy:
    """Stateless policy: :meth:`init` makes params, :meth:`apply` runs the
    forward pass."""

    def __init__(self, cfg: Config, device: torch.device | str):
        self.cfg = cfg
        self.device = torch.device(device)
        m = cfg.model
        if m.network_input_type != "cartesian" or m.network_output_type != "cartesian":
            raise NotImplementedError(
                "polar network input/output is not ported yet: ROADMAP.md queue 1, "
                "'Polar policy I/O'")
        self.unet = UNet(
            in_channels=m.in_channels,
            enc_channels=m.enc_channels,
            leaky=m.leaky,
            batch_norm=m.batch_norm,
            dropout=m.dropout,
            dtype=m.torch_dtype,
        ).to(self.device).eval()
        self.range_mask = form_cart_range_angle_grid(
            m.cart_resolution, m.cart_pixel_width, device=self.device)[0]
        self._icp_train = ICPConfig(
            icp_type=m.icp_type,
            max_iterations=m.max_iter,
            differentiable=True,
            remat_iters=m.icp_remat,
            max_step_m=m.icp_max_step_m,
        )
        self._icp_inference = ICPConfig(
            icp_type=m.icp_type,
            max_iterations=m.inference_max_iter,
            tolerance=1e-5,
            differentiable=False,
            nn_refresh_dist=m.nn_refresh_dist,
            max_step_m=m.icp_max_step_m,
        )
        if m.icp_overrides:
            fields = {f.name: f for f in dataclasses.fields(ICPConfig)}
            kv = {}
            for ov in m.icp_overrides:
                key, val = ov.split("=", 1)
                if key not in fields:
                    raise AttributeError(f"ICPConfig has no field '{key}'")
                kv[key] = _coerce(fields[key], val)
            self._icp_train = dataclasses.replace(self._icp_train, **kv)
            self._icp_inference = dataclasses.replace(self._icp_inference, **kv)

    def init(self, generator: torch.Generator) -> dict[str, torch.Tensor]:
        """Fresh Xavier-initialised parameters on the policy's device."""
        self.unet.reset_parameters(generator)
        return {k: v.detach().clone() for k, v in self.unet.state_dict().items()}

    def compute_mask(self, params: dict, fft_data: torch.Tensor,
                     fft_cfar: torch.Tensor | None, *, train: bool = False,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """Assemble input channels → batch-global normalisation → UNet → (B, H, W).
        ``train``: dropout from ``generator``."""
        m = self.cfg.model
        chans = []
        if m.fft_input:
            chans.append(fft_data)
        if m.cfar_input:
            chans.append(fft_cfar)
        if m.range_input:
            chans.append(self.range_mask.expand(fft_data.shape[0], -1, -1))
        x = torch.stack(chans, dim=1)  # (B, C, H, W)
        if m.log_transform:
            x = torch.log(x + 1e-6)
        # Statistics over the whole batch per channel; denominators floored
        # so that a constant channel normalises to 0 instead of NaN.
        if "minmax" in m.normalize:
            c_max = x.amax(dim=(0, 2, 3), keepdim=True)
            c_min = x.amin(dim=(0, 2, 3), keepdim=True)
            x = (x - c_min) / torch.clamp(c_max - c_min, min=1e-30)
        elif "standardize" in m.normalize:
            c_mean = x.mean(dim=(0, 2, 3), keepdim=True)
            c_std = x.std(dim=(0, 2, 3), correction=1, keepdim=True)
            x = (x - c_mean) / torch.clamp(c_std, min=1e-30)
        mask = functional_call(self.unet, params, (x.to(m.torch_dtype),),
                               {"train": train, "generator": generator})
        return mask.float()

    def apply(
        self,
        params: dict,
        batch_scan: dict,
        batch_map: dict,
        T_init: torch.Tensor,
        *,
        train: bool = False,
        binary: bool = False,
        override_mask: torch.Tensor | None = None,
        mask_only: bool = False,
        generator: torch.Generator | None = None,
    ) -> PolicyOutput | torch.Tensor:
        """Forward pass. batch_scan: {'fft_data' (B, H, W), 'fft_cfar',
        'raw_pc' (B, N, 3), 'filtered_pc' (B, N, 3)}; batch_map: {'pc' (B, M, 6)}.

        ``train``: dropout masks from ``generator`` (on the policy's device)
        and the unrolled differentiable ICP of ``model.max_iter`` iterations;
        without the ICP loss terms (``use_icp_4_train`` false) the solver is
        skipped and T_pred is T_init.
        """
        m = self.cfg.model
        if train and m.icp_diff_mode == "implicit":
            raise NotImplementedError(
                "icp_diff_mode='implicit' is not ported yet: ROADMAP.md queue 1 "
                "item 9, 'icp_implicit'")
        if override_mask is None:
            weight_mask = self.compute_mask(
                params, batch_scan["fft_data"], batch_scan.get("fft_cfar"),
                train=train, generator=generator)
        else:
            weight_mask = override_mask
        if m.norm_weights:
            # The minimum keeps the mask ≤ 1 where a division overshoots by an
            # ulp; like jnp.minimum it splits the cotangent at a tie.
            weight_mask = torch.minimum(weight_mask / _safe_amax_hw(weight_mask),
                                        weight_mask.new_ones(()))
        if binary:
            weight_mask = (weight_mask > 0.5).to(weight_mask.dtype)
        if mask_only:
            return weight_mask

        weights, stats = extract_weights(
            weight_mask, batch_scan["raw_pc"],
            cart_resolution=m.cart_resolution, cart_pixel_width=m.cart_pixel_width,
        )
        raw = batch_scan["raw_pc"]
        non0 = (raw[..., 0] != 0.0) & (raw[..., 1] != 0.0)
        mean_all_pts = non0.sum() / raw.shape[0]
        if train and not self.cfg.use_icp_4_train:
            return PolicyOutput(T_init, weight_mask, stats.diff_mean_num_non0, stats,
                                mean_all_pts)
        result = icp(
            batch_scan["filtered_pc"], batch_map["pc"], T_init, weight=weights,
            cfg=dataclasses.replace(self._icp_train if train else self._icp_inference,
                                    dim=2),
        )
        info = {k: v for k, v in result.items() if k != "T"}
        return PolicyOutput(
            result["T"], weight_mask, stats.diff_mean_num_non0, stats, mean_all_pts, info)

