"""Profile ``Trainer.train_step`` and ``Trainer.eval_step``:
``python3 -m mm_masking_tpu_torch.train.profile_step``.

At the default ``Config()`` on a synthetic batch of ``train.batch_size_train``
(16) pairs with ``data.max_loc_pts`` (4096) scan and ``data.max_map_pts``
(16384) map points (the train step of ``chip_smoke.py``), it captures the
step's CUDA graph, and after two warm-up steps of each path prints:

1. the host-clock time of 7 steps without instrumentation, each ended by a
   synchronise, on the graph path (the step replayed from its CUDA graph)
   and on the eager kernel path (``ops.kernels.eager()``);
2. one step of each path under ``torch.profiler``: the host's launch calls
   (kernels and graphs), the device's busy time (the union of the kernels'
   spans) and its idle share of that path's uninstrumented median step, the
   kernel count, the device time by kernel group and the top kernels; where
   the profiler shows no kernels of a graph's replay, the graph path's busy
   time is taken as not measured; then 1 and 2 for ``Trainer.eval_step`` on
   a synthetic batch of ``train.batch_size_test`` (32) pairs, whose solve
   replays its own graphs;
3. the host-clock time of each phase (UNet forward, ICP forward, loss,
   backward, optimizer) on the eager path, each ended by a synchronise, so
   their sum exceeds a free step;
4. the peak device memory, the graph's capture and memory pool included.

``--set section.field=value`` overrides the config as in the training CLI;
It runs on the card and raises without one; ``--device cpu`` runs it at a
small size, eagerly, without device numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import time
from unittest import mock

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import mm_masking_tpu_torch.models.policy as policy_module
import mm_masking_tpu_torch.train.trainer as trainer_module
from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.device import resolve_device
from mm_masking_tpu_torch.ops.kernels import eager
from mm_masking_tpu_torch.train.train_icp_weights import apply_overrides
from mm_masking_tpu_torch.train.trainer import Trainer

# Kernel-name fragment → group, first match wins.
GROUPS = (
    ("conv3x3_tf32x3", "conv3x3 (K2 forward + dx)"),
    ("conv3x3_mma_bf16", "conv3x3 (K2 forward + dx)"),
    ("conv3x3_dk", "conv3x3_dk (K3)"),
    ("nn_argmin", "nn_argmin (K4 / K1)"),
    ("resize_bwd", "resize_bwd (upsample backward)"),
    ("bilinear_points_bwd", "bilinear_points_bwd (lookup backward)"),
    ("grid_sampler_2d_backward", "grid_sampler_2d_backward"),
    ("indexfunc", "index_add / index_select"),
    ("max_pool", "max-pool"),
    ("gemm", "GEMM/GEMV"),
    ("gemv", "GEMM/GEMV"),
    ("cutlass", "GEMM/GEMV"),
    ("reduce", "reductions"),
    ("elementwise", "elementwise"),
)
FREE_STEPS, TOP_KERNELS = 7, 25


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _group(name: str) -> str:
    low = name.lower()
    return next((g for frag, g in GROUPS if frag in low), "other")


def device_summary(prof) -> tuple[dict[str, tuple[int, float]], float, int]:
    """({kernel name: (launches, ms)}, busy ms as the union of kernel spans,
    the host's launch calls: kernels and graphs)."""
    rows: dict[str, tuple[int, float]] = {}
    spans = []
    host_launches = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            host_launches += "launch" in e.name.lower() and e.name.startswith("cu")
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        n, t = rows.get(e.name, (0, 0.0))
        rows[e.name] = (n + 1, t + (end - start) / 1e3)
    busy, cur = 0.0, None
    for start, end in sorted(spans):
        if cur is None or start > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    return rows, busy / 1e3, host_launches


def profile_paths(label: str, steps, device: torch.device) -> tuple[dict, dict]:
    """Time ``steps(n)`` (n steps, host-clock ms each) on the graph path and
    the eager kernel path (the CPU: eagerly only) after 2 warm-up steps, then
    profile one step of each: ({path: times}, {path: device numbers})."""
    paths = {"graph": contextlib.nullcontext, "eager": eager}
    if device.type != "cuda":
        paths = {"eager": contextlib.nullcontext}  # the CPU runs the step eagerly
    free, out = {}, {}
    for path, ctx in paths.items():
        with ctx():
            steps(2)  # warm-up: kernel build, allocator, plans
            free[path] = steps(FREE_STEPS)
        print(f"{label}, {path} path, {FREE_STEPS} steps without instrumentation: median "
              f"{statistics.median(free[path]):.1f} ms (min {min(free[path]):.1f}, max "
              f"{max(free[path]):.1f})", flush=True)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for path, ctx in paths.items():
        with ctx(), profile(activities=activities) as prof:
            (wall,) = steps(1)
        rows, busy, host_launches = device_summary(prof)
        launches = sum(n for n, _ in rows.values())
        total = sum(t for _, t in rows.values())
        out[path] = {"busy_ms": busy if launches else None, "launches": launches,
                     "host_launches": host_launches}
        if not launches:
            print(f"profiled {path} step: host clock {wall:.1f} ms, {host_launches} host "
                  f"launch calls; device time not measured (no CUDA kernels traced on "
                  f"{device})")
            continue
        step = statistics.median(free[path])
        print(f"profiled {path} step: {host_launches} host launch calls, {launches} kernels, "
              f"device busy {busy:.1f} ms (summed kernel time {total:.1f} ms), idle "
              f"{100 * (1 - busy / step):.1f}% of the uninstrumented median step; the "
              f"profiled step took {wall:.1f} ms on the host clock")
        groups: dict[str, tuple[int, float]] = {}
        for name, (n, t) in rows.items():
            gn, gt = groups.get(_group(name), (0, 0.0))
            groups[_group(name)] = (gn + n, gt + t)
        for g, (n, t) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
            print(f"  group {g:26s} {t:9.2f} ms  x{n:5d}  {100 * t / total:5.1f}%")
        for name, (n, t) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]:
            print(f"  {t:9.2f} ms  x{n:5d}  {name[:110]}")
    return free, out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--set", action="append", default=[], metavar="SEC.FIELD=V")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = apply_overrides(Config(), args.set)
    trainer = Trainer(cfg, device)
    m, bsz = cfg.model, cfg.train.batch_size_train
    spec = SyntheticSpec(
        n_scan=cfg.data.max_loc_pts, n_map=cfg.data.max_map_pts, polar_shape=m.polar_shape,
        cart_pixel_width=m.cart_pixel_width, res=m.res, cart_resolution=m.cart_resolution,
        pos_std=cfg.data.pos_std, rot_std=cfg.data.rot_std,
        network_input_type=m.network_input_type,
    )
    batch = synthetic_batch(2, bsz, spec, device=device)
    state = trainer.init_state(seed=0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer.capture_train_step(state, batch)

    def timer(step_fn):
        def steps(n: int) -> list[float]:
            times = []
            for _ in range(n):
                _sync(device)
                t0 = time.perf_counter()
                step_fn()
                _sync(device)
                times.append((time.perf_counter() - t0) * 1e3)
            return times
        return steps

    steps = timer(lambda: trainer.train_step(state, batch))
    label = f"train_step B={bsz} {m.cart_pixel_width}^2 N={spec.n_scan} M={spec.n_map} {m.dtype}"
    free, prof_out = profile_paths(label, steps, device)
    eval_batch = synthetic_batch(3, cfg.train.batch_size_test, spec, device=device)
    eval_free, eval_prof = profile_paths(
        f"eval_step B={cfg.train.batch_size_test}",
        timer(lambda: trainer.eval_step(state.params, eval_batch)), device)

    phases: dict[str, list[float]] = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            _sync(device)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            _sync(device)
            phases.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    with contextlib.ExitStack() as stack:
        stack.enter_context(eager())  # a synchronise cannot be captured in a graph
        for target, attr, name in (
            (trainer.policy, "compute_mask", "unet_forward"),
            (policy_module, "icp", "icp_forward"),
            (trainer_module, "eval_training_loss", "loss"),
            (torch.autograd, "grad", "backward"),
            (state.opt, "step", "optimizer"),
        ):
            stack.enter_context(mock.patch.object(target, attr,
                                                  timed(name, getattr(target, attr))))
        synced = steps(3)
    phase_ms = {k: statistics.median(v) for k, v in phases.items()}
    print(f"phases, median of 3 synchronised steps (step {statistics.median(synced):.1f} "
          f"ms): " + ", ".join(f"{k} {v:.2f} ms" for k, v in phase_ms.items()))
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else None
    print(f"peak device memory: {'not measured' if peak is None else f'{peak:.0f} MiB'}")
    return {"step_ms": free, "profiled": prof_out, "eval_ms": eval_free, "eval_profiled": eval_prof,
            "phases_ms": phase_ms, "peak_mib": peak,
            "launches": sum(p["launches"] for p in [*prof_out.values(), *eval_prof.values()])}


if __name__ == "__main__":
    main()
