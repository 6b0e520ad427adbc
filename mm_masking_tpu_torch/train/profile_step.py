"""Profile ``Trainer.train_step``:
``python3 -m mm_masking_tpu_torch.train.profile_step``.

At the default ``Config()`` on a synthetic batch of ``train.batch_size_train``
(16) pairs with ``data.max_loc_pts`` (4096) scan and ``data.max_map_pts``
(16384) map points (the train step of ``chip_smoke.py``), after two warm-up
steps it prints:

1. the host-clock time of 7 steps without instrumentation, each ended by a
   synchronise;
2. one step under ``torch.profiler``: the device's busy time (the union of
   the kernels' spans) and its idle share of the uninstrumented median step,
   the launch count, the device time by kernel group and the top kernels;
3. the host-clock time of each phase (UNet forward, ICP forward, loss,
   backward, optimizer), each ended by a synchronise, so their sum exceeds
   a free step;
4. the peak device memory.

``--set section.field=value`` overrides the config as in the training CLI;
It runs on the card and raises without one; ``--device cpu`` runs it at a
small size without device numbers.
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
from mm_masking_tpu_torch.train.train_icp_weights import apply_overrides
from mm_masking_tpu_torch.train.trainer import Trainer

# Kernel-name fragment → group, first match wins.
GROUPS = (
    ("conv3x3_kernel", "conv3x3 (K2 forward + dx)"),
    ("conv3x3_dk", "conv3x3_dk (K3)"),
    ("nn_argmin_kernel", "nn_argmin (K4 / K1)"),
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


def device_summary(prof) -> tuple[dict[str, tuple[int, float]], float]:
    """({kernel name: (launches, ms)}, busy ms as the union of kernel spans)."""
    rows: dict[str, tuple[int, float]] = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
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
    return rows, busy / 1e3


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

    def steps(n: int) -> list[float]:
        times = []
        for _ in range(n):
            _sync(device)
            t0 = time.perf_counter()
            trainer.train_step(state, batch)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    steps(2)  # warm-up: kernel build, allocator, plans
    free = steps(FREE_STEPS)
    print(f"train_step B={bsz} {m.cart_pixel_width}^2 N={spec.n_scan} M={spec.n_map}, "
          f"{FREE_STEPS} steps without instrumentation: median "
          f"{statistics.median(free):.1f} ms (min {min(free):.1f}, max {max(free):.1f})",
          flush=True)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        (wall,) = steps(1)
    rows, busy = device_summary(prof)
    launches = sum(n for n, _ in rows.values())
    total = sum(t for _, t in rows.values())
    if launches:
        step = statistics.median(free)
        print(f"profiled step: {launches} kernel launches, device busy {busy:.1f} ms "
              f"(summed kernel time {total:.1f} ms), idle {100 * (1 - busy / step):.1f}% "
              f"of the uninstrumented median step; the profiled step took {wall:.1f} ms "
              f"on the host clock")
        groups: dict[str, tuple[int, float]] = {}
        for name, (n, t) in rows.items():
            gn, gt = groups.get(_group(name), (0, 0.0))
            groups[_group(name)] = (gn + n, gt + t)
        for g, (n, t) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
            print(f"  group {g:26s} {t:9.2f} ms  x{n:5d}  {100 * t / total:5.1f}%")
        for name, (n, t) in sorted(rows.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]:
            print(f"  {t:9.2f} ms  x{n:5d}  {name[:110]}")
    else:
        print(f"profiled step: host clock {wall:.1f} ms; device time not measured "
              f"(no CUDA kernels traced on {device})")

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
    return {"step_ms": free, "busy_ms": busy, "launches": launches, "phases_ms": phase_ms,
            "peak_mib": peak}


if __name__ == "__main__":
    main()
