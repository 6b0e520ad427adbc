"""Learned ICP-weight policy: UNet mask → per-point weights → ICP.

Counterpart of ``mm_masking_tpu.models.policy``. Parameters are a
``state_dict`` of :class:`UNet` applied with ``torch.func.functional_call``,
so the policy itself holds no trained state, like the JAX one. Training
(``apply(train=True, generator=…)``) runs the UNet with dropout and the
unrolled differentiable ICP; inference runs the tolerance-stopped solver.

``network_input_type`` and ``network_output_type`` are "cartesian" or
"polar", as in the JAX package. A polar input runs the UNet on the (A, R)
scan, its range channel the polar range grid; a polar output is warped to
the cartesian BEV before the weight lookup, through
:func:`~mm_masking_tpu_torch.ops.radar.polar_mask_to_cartesian`, whose
backward is the gather-form kernel.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, NamedTuple

import torch
from torch.func import functional_call

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.dicp import ICPConfig, icp, icp_implicit
from mm_masking_tpu_torch.models.unet import UNet
from mm_masking_tpu_torch.utils import profiling
from mm_masking_tpu_torch.parallel.mesh import Mesh
from mm_masking_tpu_torch.ops import (
    cfar_mask,
    extract_weights,
    form_cart_range_angle_grid,
    form_polar_range_grid,
    polar_mask_to_cartesian,
    radar_polar_to_cartesian,
)


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
        self.unet = UNet(
            in_channels=m.in_channels,
            enc_channels=m.enc_channels,
            leaky=m.leaky,
            batch_norm=m.batch_norm,
            dropout=m.dropout,
            dtype=m.torch_dtype,
        ).to(self.device).eval()
        if m.network_input_type == "cartesian":
            self.range_mask = form_cart_range_angle_grid(
                m.cart_resolution, m.cart_pixel_width, device=self.device)[0]
        else:
            self.range_mask = form_polar_range_grid(m.res, m.polar_shape, device=self.device)
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
                     generator: torch.Generator | None = None, mesh: Mesh | None = None,
                     rows: tuple[int, int] | None = None) -> torch.Tensor:
        """Assemble input channels → batch-global normalisation → UNet → (B, H, W).
        ``train``: dropout from ``generator``. ``mesh``: the batch is this
        rank's rows ``rows`` = (first row, global rows) of a batch sharded
        over the mesh; the normalisation's statistics, the batch norm's and
        the dropout masks are the global batch's."""
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
        # Statistics over the whole batch per channel (over every rank's rows
        # under a mesh; the input's, so no gradient passes through them);
        # denominators floored so that a constant channel normalises to 0
        # instead of NaN.
        if "minmax" in m.normalize:
            c_max = x.amax(dim=(0, 2, 3), keepdim=True)
            c_min = x.amin(dim=(0, 2, 3), keepdim=True)
            if mesh is not None:
                c_max, c_min = mesh.max(c_max), mesh.min(c_min)
            x = (x - c_min) / torch.clamp(c_max - c_min, min=1e-30)
        elif "standardize" in m.normalize:
            if mesh is None:
                c_mean = x.mean(dim=(0, 2, 3), keepdim=True)
                c_std = x.std(dim=(0, 2, 3), correction=1, keepdim=True)
            else:  # the global count, sum, then sum of squared deviations
                with torch.no_grad():
                    n = x[:, 0].numel() * mesh.size
                    c_mean = mesh.sum(x.sum(dim=(0, 2, 3), keepdim=True)) / n
                    dev2 = mesh.sum(((x - c_mean) ** 2).sum(dim=(0, 2, 3), keepdim=True))
                    c_std = torch.sqrt(dev2 / (n - 1))
            x = (x - c_mean) / torch.clamp(c_std, min=1e-30)
        mask = functional_call(self.unet, params, (x.to(m.torch_dtype),),
                               {"train": train, "generator": generator, "mesh": mesh,
                                "rows": rows})
        return mask  # float32: the UNet head computes in float32

    def mask_for_scan(self, params: dict, fft_polar: torch.Tensor,
                      azimuths: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
        """(B, A, R) raw polar power and (B, A) azimuths → (B, Wc, Wc)
        cartesian weight mask, ready for :func:`extract_weights` at the scan
        points: the CFAR channel (when configured) and, for a cartesian
        network input, the polar→cartesian warp of the raw scan; then
        :meth:`compute_mask`, the per-image max normalisation
        (``norm_weights``), ``binary_inference`` and, for a polar network
        output, the mask's warp to cartesian. The normalisation's statistics
        are over the frames passed together (over every rank's frames under
        a ``mesh``)."""
        m = self.cfg.model
        fft_in, cfar_in = fft_polar, None
        if m.cfar_input:
            cfar_in = cfar_mask(fft_polar, m.res, a_thresh=m.a_thresh, b_thresh=m.b_thresh,
                                diff=False)
        if m.network_input_type == "cartesian":
            fft_in = radar_polar_to_cartesian(fft_polar, azimuths, m.res, m.cart_resolution,
                                              m.cart_pixel_width)
            if cfar_in is not None:
                cfar_in = radar_polar_to_cartesian(cfar_in, azimuths, m.res,
                                                   m.cart_resolution, m.cart_pixel_width)
        mask = self.compute_mask(params, fft_in, cfar_in, mesh=mesh)
        if m.norm_weights:
            mask = torch.minimum(mask / _safe_amax_hw(mask), mask.new_ones(()))
        if m.binary_inference:
            mask = (mask > 0.5).to(mask.dtype)
        if m.network_output_type == "polar":
            mask = radar_polar_to_cartesian(mask, azimuths, m.res, m.cart_resolution,
                                            m.cart_pixel_width)
        return mask

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
        mesh: Mesh | None = None,
        rows: tuple[int, int] | None = None,
    ) -> PolicyOutput | torch.Tensor:
        """Forward pass. batch_scan: {'fft_data' (B, H, W), 'fft_cfar',
        'raw_pc' (B, N, 3), 'filtered_pc' (B, N, 3)}; batch_map: {'pc' (B, M, 6)}.

        ``train``: dropout masks from ``generator`` (on the policy's device)
        and the unrolled differentiable ICP of ``model.max_iter`` iterations
        (with ``icp_diff_mode="implicit"``, :func:`icp_implicit` at
        max(5·max_iter, 50) iterations instead); without the ICP loss terms
        (``use_icp_4_train`` false) the solver is skipped and T_pred is
        T_init.

        ``mesh``: the batch is this rank's rows ``rows`` = (first row, global
        rows) of a batch sharded over the mesh (:func:`~mm_masking_tpu_torch.
        parallel.shard_batch`); every batch statistic (the normalisation, the
        batch norm, the weight statistics, the point counts) is the global
        batch's, and the dropout masks are the global batch's rows.

        Spans: ``mm.policy.unet`` (the mask) and ``mm.policy.weights`` (the
        weights at the scan points), then the solve's
        (:func:`~mm_masking_tpu_torch.dicp.icp`). In a marked train step
        (``utils.profiling.phases``) the UNet's, the lookup's and the ICP's
        forwards end in marks, and the gradient reaching the pose, the
        weights and the mask marks their backwards.
        """
        m = self.cfg.model
        if override_mask is None:
            with profiling.span("mm.policy.unet"):
                weight_mask = self.compute_mask(
                    params, batch_scan["fft_data"], batch_scan.get("fft_cfar"),
                    train=train, generator=generator, mesh=mesh, rows=rows)
            profiling.mark("unet.fwd")
            profiling.grad_mark(weight_mask, "lookup.bwd")
        else:
            weight_mask = override_mask
        if mask_only:
            return self._normalized(weight_mask, binary)
        with profiling.span("mm.policy.weights"):
            weight_mask = self._normalized(weight_mask, binary)
            cart_mask = weight_mask
            if m.network_output_type == "polar":
                cart_mask = polar_mask_to_cartesian(weight_mask, batch_scan["azimuths"], m.res,
                                                    m.cart_resolution, m.cart_pixel_width)
            weights, stats = extract_weights(
                cart_mask, batch_scan["raw_pc"], cart_resolution=m.cart_resolution,
                cart_pixel_width=m.cart_pixel_width, mesh=mesh,
            )
            raw = batch_scan["raw_pc"]
            non0 = (raw[..., 0] != 0.0) & (raw[..., 1] != 0.0)
            mean_all_pts = non0.sum() / raw.shape[0]
            if mesh is not None:
                mean_all_pts = mesh.mean(mean_all_pts)
        profiling.mark("lookup.fwd")
        profiling.grad_mark(weights, "icp.bwd")
        if train and not self.cfg.use_icp_4_train:
            return PolicyOutput(T_init, weight_mask, stats.diff_mean_num_non0, stats,
                                mean_all_pts)
        if train and m.icp_diff_mode == "implicit":
            # The solve to tolerance, differentiated at its fixed point.
            cfg_icp = dataclasses.replace(self._icp_inference,
                                          max_iterations=max(m.max_iter * 5, 50), dim=2)
            T_est = icp_implicit(batch_scan["filtered_pc"], batch_map["pc"], T_init, weights,
                                 cfg_icp, mesh)
            profiling.mark("icp.fwd")
            profiling.grad_mark(T_est, "loss.bwd")
            return PolicyOutput(T_est, weight_mask, stats.diff_mean_num_non0, stats,
                                mean_all_pts)
        result = icp(
            batch_scan["filtered_pc"], batch_map["pc"], T_init, weight=weights,
            cfg=dataclasses.replace(self._icp_train if train else self._icp_inference,
                                    dim=2),
            mesh=mesh,
        )
        profiling.mark("icp.fwd")
        profiling.grad_mark(result["T"], "loss.bwd")
        info = {k: v for k, v in result.items() if k != "T"}
        return PolicyOutput(
            result["T"], weight_mask, stats.diff_mean_num_non0, stats, mean_all_pts, info)

    def _normalized(self, weight_mask: torch.Tensor, binary: bool) -> torch.Tensor:
        """The mask's per-image max normalisation (``norm_weights``) and, with
        ``binary``, its threshold at 0.5."""
        m = self.cfg.model
        if m.norm_weights:
            # The minimum keeps the mask ≤ 1 where a division overshoots by an
            # ulp; like jnp.minimum it splits the cotangent at a tie.
            weight_mask = torch.minimum(weight_mask / _safe_amax_hw(weight_mask),
                                        weight_mask.new_ones(()))
        if binary:
            weight_mask = (weight_mask > 0.5).to(weight_mask.dtype)
        return weight_mask
