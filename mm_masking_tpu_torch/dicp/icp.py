"""Batched ICP, point-to-point and point-to-plane.

Counterpart of ``mm_masking_tpu.dicp.icp`` for ``nn_refresh_dist == 0``, in
its two modes:

- ``differentiable=False`` (inference): the tolerance-stopped Gauss-Newton
  loop that associates every iteration and freezes each batch item the
  moment its update drops under tolerance;
- ``differentiable=True`` (training): ``max_iterations`` unrolled GN steps
  with no early exit, differentiable in the per-point weights (∂T/∂weight is
  the signal that trains the mask). The association is discrete and taken
  on the detached points.

Per iteration:

  1. transform the source by the current T (left-composed, ``T ← exp(δ)T``);
  2. nearest-neighbour association against the map (the CUDA kernel of
     :mod:`mm_masking_tpu_torch.ops.kernels.nn_assoc`; the sorted stripe when
     the map has at least 4096 points);
  3. residuals: pt2pt ``r = p' − q``, pt2pl ``r = n·(p' − q)``;
  4. weights: trim × robust × caller weight × source-pad mask;
  5. the weighted normal equations; ``dim=2`` solves only (x, y, yaw).

Nothing in an iteration reads the device from the host: the stripe
budget test is a select on the device, and the inference loop counts its
iterations there. The inference loop runs in chunks of
``STOP_TEST_EVERY`` iterations and reads its stop test once per chunk; a
chunk's iterations change nothing once every item has stopped, so the
result is that of a test after every iteration. On the card a chunk is a
CUDA graph, captured once per configuration and shape and replayed
(:mod:`mm_masking_tpu_torch.graphs`); the training solve is part of the
train step's graph.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from mm_masking_tpu_torch.geom import se3_exp, se3_inv, transform_points
from mm_masking_tpu_torch.graphs import CapturedStep
from mm_masking_tpu_torch.ops.kernels import use_graphs
from mm_masking_tpu_torch.ops.kernels.nn_assoc import (
    map_layout,
    nn_argmin,
    nn_argmin_stripe_presorted,
    stripe_sort_target,
)

TARGET_PAD_VAL = 1000.0  # map pad sentinel; > any real range, trimmed out
STOP_TEST_EVERY = 5  # inference GN iterations between two reads of the stop test


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Solver configuration; fields and defaults as in the JAX package."""

    icp_type: str = "pt2pt"  # "pt2pt" | "pt2pl"
    max_iterations: int = 10
    tolerance: float = 1e-5
    differentiable: bool = True
    trim_dist: float = 5.0
    loss_name: str = "cauchy"  # "cauchy" | "huber" | "none"
    loss_metric: float = 1.0
    dim: int = 2  # 2 = planar (x, y, yaw); 3 = full SE(3)
    target_pad_val: float = TARGET_PAD_VAL
    use_pallas_nn: bool | None = None  # TPU kernel choice; ignored by the port
    nn_stripe: bool | None = None  # None = auto (on when the map has ≥ 4096 points)
    nn_stripe_window: int = 0  # 0 = auto (M/4)
    nn_stripe_tile: int = 256
    max_step_m: float = 0.0  # trust-region clamp on the step's translation
    remat_iters: bool = False  # training memory knob; ignored by the port
    damping: float = 1e-9
    damping_rel: float = 1e-7  # λ = damping + damping_rel · tr(A)/dof
    prior_weight: float = 0.0
    nn_refresh_dist: float = 0.0
    nn_refresh_range: float = 80.0
    planar_retraction: str = "exp"  # "exp" | "direct"
    robust_on: str = "residual"  # "residual" | "distance"
    stop_metric: str = "norm6"  # "norm6" | "trans" | "maxabs"


def _stop_mag(delta: torch.Tensor, cfg: ICPConfig) -> torch.Tensor:
    if cfg.stop_metric == "trans":
        return torch.linalg.vector_norm(delta[:, :3], dim=-1)
    if cfg.stop_metric == "maxabs":
        return delta.abs().amax(dim=-1)
    return torch.linalg.vector_norm(delta, dim=-1)


def robust_weight(r_norm: torch.Tensor, name: str, k: float) -> torch.Tensor:
    """IRLS robust weights of per-point residual magnitudes."""
    if name == "cauchy":
        return 1.0 / (1.0 + (r_norm / k) ** 2)
    if name == "huber":
        abs_r = r_norm.abs().clamp(min=1e-12)
        return torch.minimum(torch.ones_like(abs_r), k / abs_r)
    if name == "none":
        return torch.ones_like(r_norm)
    raise ValueError(f"unknown robust loss '{name}'")


def _hat(p: torch.Tensor) -> torch.Tensor:
    """(…, 3) -> (…, 3, 3) skew matrices."""
    x, y, z = p.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _solve3x3_impl(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form cofactor solve of batched 3×3 systems."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    inv_det = 1.0 / (a00 * c00 + a01 * c10 + a02 * c20)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [
            (c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
            (c10 * b0 + c11 * b1 + c12 * b2) * inv_det,
            (c20 * b0 + c21 * b1 + c22 * b2) * inv_det,
        ],
        dim=-1,
    )


class _Solve3x3(torch.autograd.Function):
    """The cofactor solve with the linear-solve adjoint as its backward:
    b̄ = A⁻ᵀx̄ by the same cofactor solve, Ā = −b̄xᵀ. Autograd through the
    cofactor arithmetic would carry 1/det² terms, which overflow float32 on a
    near-dead damped system (A ≈ 1e-9·I, det ≈ 1e-27); this form stays finite
    there and equals it elsewhere up to rounding (the JAX package's custom
    VJP)."""

    @staticmethod
    def forward(ctx, A, b):
        x = _solve3x3_impl(A, b)
        ctx.save_for_backward(A, x)
        return x

    @staticmethod
    def backward(ctx, g):
        A, x = ctx.saved_tensors
        gb = _solve3x3_impl(A.transpose(-1, -2), g)
        return -gb[..., :, None] * x[..., None, :], gb


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve batched 3×3 systems A x = b; differentiable in A and b."""
    return _Solve3x3.apply(A, b)


def _prior_error6(T: torch.Tensor, T_prior: torch.Tensor) -> torch.Tensor:
    """First-order left-trivialised twist of E = T·T_prior⁻¹ (B, 6)."""
    E = T @ se3_inv(T_prior)
    phi = 0.5 * torch.stack(
        [E[..., 2, 1] - E[..., 1, 2], E[..., 0, 2] - E[..., 2, 0],
         E[..., 1, 0] - E[..., 0, 1]],
        dim=-1,
    )
    return torch.cat([E[..., :3, 3], phi], dim=-1)


def _planar(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The x, y and yaw entries (0, 1, 5) of the se(3) twist along ``dim``,
    by slices (a Python index list would be copied to the card each call)."""
    return torch.cat([x.narrow(dim, 0, 2), x.narrow(dim, 5, 1)], dim)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, M, C), idx (B, N) int → (B, N, C)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def _gn_step(
    T: torch.Tensor,
    source: torch.Tensor,
    target_pts: torch.Tensor,
    target_nrm: torch.Tensor | None,
    weight: torch.Tensor | None,
    source_valid: torch.Tensor,
    cfg: ICPConfig,
    T_prior: torch.Tensor | None = None,
    assoc_fn=None,
    idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Gauss-Newton iteration. Returns (T_new, delta (B, 6)).
    ``idx``: a precomputed association (B, N) replaces the NN search."""
    B = source.shape[0]
    p = transform_points(T, source)
    if idx is None:
        if assoc_fn is None:
            assoc_fn = functools.partial(nn_argmin, q=target_pts)
        idx, _ = assoc_fn(p)
    q = _gather_rows(target_pts, idx)

    diff = p - q
    dist = torch.linalg.vector_norm(diff + 1e-30, dim=-1)
    if cfg.icp_type == "pt2pl":
        n = _gather_rows(target_nrm, idx)
        r = (n * diff).sum(-1)
        r_norm = r.abs() if cfg.robust_on == "residual" else dist
    else:
        r = diff
        r_norm = dist

    # NaN hygiene: a diverged item's NaNs must not reach the normal
    # equations, so trimming is a select and inactive rows are zeroed.
    active = torch.isfinite(dist) & (dist < cfg.trim_dist)
    w = robust_weight(torch.where(active, r_norm, 1.0), cfg.loss_name, cfg.loss_metric)
    w = torch.where(active, w, 0.0) * source_valid
    if weight is not None:
        w = w * weight
    r = torch.where(active if r.ndim == 2 else active[..., None], r, 0.0)
    p = torch.where(active[..., None], p, 0.0)

    if cfg.icp_type == "pt2pl":
        n = torch.where(active[..., None], n, 0.0)
        J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)  # (B, N, 6)
        A = torch.einsum("bni,bnj,bn->bij", J, J, w)
        b = -torch.einsum("bni,bn,bn->bi", J, r, w)
    else:
        # J_i = [I | -p^]; closed-form blocks of Σ w JᵀJ and Σ w Jᵀr.
        ph = _hat(p)
        wph = w[..., None, None] * ph
        eye = torch.eye(3, dtype=p.dtype, device=p.device)
        A_tt = w.sum(1)[..., None, None] * eye
        A_tr = -wph.sum(1)
        A_rr = torch.einsum("bnki,bnkj->bij", ph, wph)
        A = torch.cat(
            [torch.cat([A_tt, A_tr], dim=-1),
             torch.cat([A_tr.transpose(-1, -2), A_rr], dim=-1)],
            dim=-2,
        )
        b_t = -torch.einsum("bni,bn->bi", r, w)
        b_r = torch.einsum("bnij,bnj->bi", wph.transpose(-1, -2), r)
        b = torch.cat([b_t, b_r], dim=-1)

    if cfg.prior_weight > 0.0 and T_prior is not None:
        A = A + cfg.prior_weight * torch.eye(6, dtype=A.dtype, device=A.device)
        b = b - cfg.prior_weight * _prior_error6(T, T_prior)

    if cfg.dim == 2:
        A_sub = _planar(_planar(A, 1), 2)
        tr3 = (A_sub[:, 0, 0] + A_sub[:, 1, 1] + A_sub[:, 2, 2]) / 3.0
        lam = cfg.damping + cfg.damping_rel * tr3
        A_sub = A_sub + lam[:, None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
        x = _solve3x3(A_sub, _planar(b, 1))
        zero = torch.zeros((B, 3), dtype=A.dtype, device=A.device)
        delta = torch.cat([x[:, :2], zero, x[:, 2:]], dim=1)
    else:
        lam = cfg.damping + cfg.damping_rel * A.diagonal(dim1=-2, dim2=-1).sum(-1) / 6.0
        A = A + lam[:, None, None] * torch.eye(6, dtype=A.dtype, device=A.device)
        delta = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    delta = torch.where(torch.isfinite(delta), delta, 0.0)

    if cfg.max_step_m > 0.0:
        # Every backward factor stays finite at delta = 0: the floor keeps the
        # sqrt and the division away from 0, and the clamp routes the
        # cotangent to the constant branch when the step is inside the region.
        t_sq = (delta[:, :3] * delta[:, :3]).sum(-1)
        scale = cfg.max_step_m / torch.sqrt(t_sq.clamp(min=cfg.max_step_m ** 2))
        delta = delta * scale[:, None]

    if cfg.dim == 2 and cfg.planar_retraction == "direct":
        dth = delta[:, 5]
        Td = torch.zeros_like(T)
        Td[:, 0, 0] = torch.cos(dth)
        Td[:, 0, 1] = -torch.sin(dth)
        Td[:, 1, 0] = torch.sin(dth)
        Td[:, 1, 1] = torch.cos(dth)
        Td[:, 2, 2] = 1.0
        Td[:, 3, 3] = 1.0
        Td[:, 0, 3] = delta[:, 0]
        Td[:, 1, 3] = delta[:, 1]
        return Td @ T, delta
    return se3_exp(delta) @ T, delta


def icp(
    source: torch.Tensor,
    target: torch.Tensor,
    T_init: torch.Tensor,
    weight: torch.Tensor | None = None,
    cfg: ICPConfig = ICPConfig(),
    T_prior: torch.Tensor | None = None,
) -> dict[str, Any]:
    """Run the batched ICP.

    source (B, N, 3) with (0, 0, ·) pad rows; target (B, M, 3) or (B, M, 6)
    (+normals for pt2pl) with ``cfg.target_pad_val`` pad rows; T_init
    (B, 4, 4); weight optional (B, N). Returns, with
    ``cfg.differentiable``, {'T' (B, 4, 4), 'delta_norms' (max_iterations,
    B)}; otherwise {'T', 'iterations' (int64 tensor), 'delta_norm' (B,),
    'stop_tests' (int, the host's reads of the stop test)}.
    ``cfg.remat_iters`` is a memory knob of the JAX package and is ignored.
    """
    if cfg.nn_refresh_dist > 0.0 and not cfg.differentiable:
        raise NotImplementedError(
            "motion-gated NN refresh (nn_refresh_dist > 0) is not ported yet: "
            "ROADMAP.md queue 1, 'Motion-gated refresh'")
    source = source[..., :3]
    stripe = cfg.nn_stripe
    if stripe is None:
        stripe = target.shape[1] >= 4096
    source_valid = (~((source[..., 0] == 0.0) & (source[..., 1] == 0.0))).to(source.dtype)

    inp = {}
    if stripe:
        # Sort the map once per solve, and permute the source rows once by
        # their initial-guess key (the GN sums do not depend on row order).
        target, inp["key_sorted"], inp["use_x"] = stripe_sort_target(
            target, cfg.target_pad_val)
        p0 = transform_points(T_init, source)
        order = torch.argsort(
            torch.where(inp["use_x"][:, None], p0[..., 0], p0[..., 1]), dim=1, stable=True)
        source = _gather_rows(source, order)
        source_valid = torch.gather(source_valid, 1, order)
        if weight is not None:
            weight = torch.gather(weight, 1, order)  # ∂/∂weight flows back through it
    if cfg.icp_type == "pt2pl" and target.shape[-1] < 6:
        raise ValueError("pt2pl requires target with normals (B, M, 6)")
    inp.update(source=source, source_valid=source_valid, target_pts=target[..., :3],
               q4=map_layout(target[..., :3]))  # the kernel's layout, hoisted out of the loop
    for name, t in (("target_nrm", target[..., 3:6] if target.shape[-1] >= 6 else None),
                    ("weight", weight), ("T_prior", T_prior)):
        if t is not None:
            inp[name] = t

    if cfg.differentiable:
        T, norms = T_init, []
        for _ in range(cfg.max_iterations):
            p = transform_points(T, source).detach()
            T, delta = _gn_step(T, idx=_associate(inp, p, cfg, stripe), **_step_args(inp, cfg))
            norms.append(torch.linalg.vector_norm(delta, dim=-1))
        return {"T": T, "delta_norms": torch.stack(norms)}
    with torch.no_grad():  # the tolerance-stopped solve has no gradient, as in JAX
        return _solve_to_tolerance(inp, T_init, cfg, stripe)


def _step_args(inp: dict, cfg: ICPConfig) -> dict:
    """The keyword arguments of :func:`_gn_step` from a solve's inputs."""
    return dict(source=inp["source"], target_pts=inp["target_pts"],
                target_nrm=inp.get("target_nrm"), weight=inp.get("weight"),
                source_valid=inp["source_valid"], cfg=cfg, T_prior=inp.get("T_prior"),
                assoc_fn=functools.partial(nn_argmin, q=inp["target_pts"], q4=inp["q4"]))


def _associate(inp: dict, p: torch.Tensor, cfg: ICPConfig, stripe: bool,
               refresh: torch.Tensor | None = None) -> torch.Tensor:
    """Nearest map row of each transformed source point p: the sorted stripe
    (items with ``refresh`` False do no search) or dense."""
    if not stripe:
        return nn_argmin(p, inp["target_pts"], inp["q4"])[0]
    return nn_argmin_stripe_presorted(
        p, q_sorted=inp["target_pts"], key_sorted=inp["key_sorted"], use_x=inp["use_x"],
        trim_dist=cfg.trim_dist, window=cfg.nn_stripe_window or None,
        tn=cfg.nn_stripe_tile, q4=inp["q4"], refresh=refresh)[0]


def _iterate(st: dict, inp: dict, cfg: ICPConfig, stripe: bool, n: int) -> None:
    """n iterations of the tolerance-stopped solve, in place on its state
    ``st`` (T, dn, idx, done = iterations taken, iterations = those in which
    any item still ran). An item runs while its last update's stop magnitude
    is at least the tolerance and fewer than ``max_iterations`` have been
    taken; a stopped item keeps T, dn and idx, so an iteration in which no
    item runs changes nothing but ``done``."""
    step_args = _step_args(inp, cfg)
    for _ in range(n):
        T = st["T"]
        run = (st["dn"] >= cfg.tolerance) & (st["done"] < cfg.max_iterations)
        if stripe:
            idx_new = _associate(inp, transform_points(T, inp["source"]), cfg, stripe, run)
            st["idx"].copy_(torch.where(run[:, None], idx_new, st["idx"]))
            T_new, delta = _gn_step(T, idx=st["idx"], **step_args)
        else:
            T_new, delta = _gn_step(T, **step_args)  # dense: every item re-associates
        st["T"].copy_(torch.where(run[:, None, None], T_new, T))
        st["dn"].copy_(torch.where(run, _stop_mag(delta, cfg), st["dn"]))
        st["iterations"].add_(run.any())
        st["done"].add_(1)


def _start(st: dict, T_init: torch.Tensor) -> None:
    """Set a solve's state to its start: every item runs from T_init."""
    st["T"].copy_(T_init)
    st["dn"].fill_(float("inf"))
    for name in ("idx", "done", "iterations"):
        st[name].zero_()


def _new_state(T_init: torch.Tensor, n_points: int) -> dict:
    B, dev = T_init.shape[0], T_init.device
    st = {"T": torch.empty_like(T_init), "dn": torch.empty((B,), dtype=T_init.dtype, device=dev),
          "idx": torch.empty((B, n_points), dtype=torch.int32, device=dev),
          "done": torch.empty((), dtype=torch.int64, device=dev),
          "iterations": torch.empty((), dtype=torch.int64, device=dev)}
    _start(st, T_init)
    return st


# Captured chunks of the tolerance-stopped solve, by configuration and the
# shapes of its inputs: (static inputs, static state, CapturedStep).
_CHUNKS: dict = {}


def _captured_chunk(inp: dict, T_init: torch.Tensor, cfg: ICPConfig, stripe: bool,
                    k: int) -> tuple[dict, CapturedStep]:
    """The chunk of k iterations as a CUDA graph over static copies of the
    solve's inputs and state; loads this solve's inputs into them and sets
    the state to its start."""
    key = (cfg, stripe, k, T_init.device, T_init.shape, T_init.dtype,
           tuple((name, t.shape, t.dtype) for name, t in sorted(inp.items())))
    if key not in _CHUNKS:
        with torch.inference_mode(False):  # static tensors outlive an inference call
            s_inp = {name: torch.empty_like(t) for name, t in inp.items()}
            s_st = _new_state(T_init, inp["source"].shape[1])
        for name, t in inp.items():
            s_inp[name].copy_(t)
        chunk = CapturedStep(lambda: _iterate(s_st, s_inp, cfg, stripe, k), T_init.device)
        _CHUNKS[key] = (s_inp, s_st, chunk)
    s_inp, s_st, chunk = _CHUNKS[key]
    for name, t in inp.items():
        s_inp[name].copy_(t)
    _start(s_st, T_init)
    return s_st, chunk


def _solve_to_tolerance(inp: dict, T_init: torch.Tensor, cfg: ICPConfig,
                        stripe: bool) -> dict[str, Any]:
    """The inference solve: chunks of ``STOP_TEST_EVERY`` iterations, the
    stop test read from the device after each chunk but the last. The
    result equals a loop that tests after every iteration."""
    k = max(1, min(STOP_TEST_EVERY, cfg.max_iterations))
    n_chunks = -(-max(cfg.max_iterations, 0) // k)
    graphs = use_graphs(T_init.device) and n_chunks > 0
    if graphs:
        st, captured = _captured_chunk(inp, T_init, cfg, stripe, k)
        chunk = captured.replay
    else:
        st = _new_state(T_init, inp["source"].shape[1])

        def chunk():
            _iterate(st, inp, cfg, stripe, k)
    stop_tests = 0
    for c in range(n_chunks):
        chunk()
        if c + 1 == n_chunks:
            break
        stop_tests += 1
        if not bool((st["dn"] >= cfg.tolerance).any()):
            break
    out = {"T": st["T"], "iterations": st["iterations"], "delta_norm": st["dn"]}
    if graphs:  # the next solve of this shape overwrites the static state
        out = {name: t.clone() for name, t in out.items()}
    return {**out, "stop_tests": stop_tests}


def icp_implicit(source, target, T_init, weight, cfg: ICPConfig):
    """Converged pose with implicit-function-theorem gradients w.r.t. weight."""
    raise NotImplementedError(
        "icp_implicit (implicit-function-theorem gradients) is not ported yet: "
        "ROADMAP.md queue 1, 'icp_implicit'")
