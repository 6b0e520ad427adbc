#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's eval and train paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:

1. env     torch/CUDA versions and the card's name and power limit; fails
           without a CUDA device.
2. build   compiles ``mm_masking_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
           one process per source; prints ptxas's registers and spills and
           the count of HMMA (tensor-core) instructions in the SASS of each
           instantiation of the float32 conv kernel, and fails if one has
           none.
3. kernels each CUDA kernel against its plain PyTorch version at the
           path's shapes: the 3x3 conv's forward, dx and dk at every UNet
           stage (f32 and bf16 at B = 4, dx and dk also f32 at the train
           step's B = 16; dk also bitwise across two runs), the dense
           NN at (4, 4096, 16384) and the stripe NN on a sorted synthetic
           map with mixed block counts, zeros included; then the median time
           of each next to its plain version: the forward and NN at the
           eval step's B = 32, the conv's forward, dx and dk at the train
           step's B = 16, in float32 and (beside cuDNN's own bfloat16 call)
           in bfloat16.
4. slice   ``Trainer.eval_step`` at the default ``Config()`` (full-width UNet,
           640x640, f32, pt2pt, 50-iteration stripe ICP) on a 32-item
           synthetic batch of 4096 scan and 16384 map points, with seeded
           random weights; its solve replays CUDA graphs of 5 iterations and
           reads the stop test at most 10 times. The launch counters must
           show the kernels ran; the poses must match the same step run
           eagerly on the kernels (same iteration count, 1e-6 m, 1e-5 deg)
           and with the plain versions. Then the same step with the dense
           association (``icp_overrides=("nn_stripe=false",)``), the path of
           K1. Each step is timed on the graph, eager and plain paths.
5. train   ``Trainer.train_step`` at the default ``Config()`` (dropout 0.05,
           10 unrolled ICP iterations, Adam at 1e-4) on a 16-item synthetic
           batch of 4096 / 16384 points: the step captured as a CUDA graph,
           then 3 replays. The counters must show every conv forward, dx and
           dk and at least 10 NN launches per step; loss, gradients and
           updated parameters must be finite; the 3 steps must match 3
           eager kernel-path steps from the same seed (loss and grad_norm
           within 1e-6 relative, parameters within 1e-5 of max |p|); the
           first step's loss and grad_norm must match the plain path's; a
           full-width UNet gradient must match the plain path's; then the
           host-clock step of the graph, eager and plain paths and their
           peak device memory (the graph's pool included). Then the same
           with ``model.dtype="bfloat16"``: 3 replays, finite, timed.
6. probes  the conv-probe path (``mm_masking_tpu_torch.benchmarks.probe_conv``):
           each probe kernel P1-P4 and each of P2's five variants against
           its plain version at the probes' check shapes (f32) and at
           B = 16, 640^2, 16 -> 16 (f32 and bf16; asm-only bit for bit),
           then, with counters from 0, each timed at the probes' timing
           shapes beside cuDNN's conv and K2; every probe kernel and variant
           must have launched.

Every kernel's row carries its bound (``timing.bound_ms``: the larger of
its operations over the H100's peak for the input type and its bytes over
3.35 TB/s, summed over the launches a row times; the convs' float32 work at
the tensor cores' 3xTF32 rate, 495 / 3 TFLOP/s, and bfloat16 at 989) and,
where one PyTorch
call computes the same function, that call's time (``library_ms``). The
last two lines are a JSON object with the kernels' launches, errors and
times, and the contract line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.func import functional_call

from mm_masking_tpu_torch.benchmarks import probe_conv
from mm_masking_tpu_torch.benchmarks.timing import bound_ms, cuda_ms, in_turns
from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.dicp.icp import STOP_TEST_EVERY
from mm_masking_tpu_torch.geom import transform_points
from mm_masking_tpu_torch.models.unet import conv3x3_shapes
from mm_masking_tpu_torch.ops import kernels
from mm_masking_tpu_torch.ops.kernels import nn_assoc
from mm_masking_tpu_torch.ops.kernels.conv_probes import VARIANTS
from mm_masking_tpu_torch.ops.kernels.conv2d import (
    conv3x3,
    conv3x3_dk,
    conv3x3_dk_plain,
    conv3x3_dx,
    conv3x3_dx_plain,
    conv3x3_forward,
    conv3x3_plain,
)
from mm_masking_tpu_torch.train import Trainer

BATCH, N_SCAN, N_MAP = 32, 4096, 16384
TRAIN_BATCH, TRAIN_STEPS = 16, 3  # the train step's shapes (bench.py:215-243)
CHECK_BATCH = 4  # smaller batch for the f32 + bf16 kernel-vs-plain value checks
TRIM, TILE = 5.0, 256  # ICPConfig defaults: trim_dist, nn_stripe_tile

# The CUDA kernels: row name → (source, the Pallas call it replaces, the
# launch counters that count it). K2 serves the conv's forward and, on the
# rotated and transposed weight, its backward's dx; its float32 kernel, the
# one the default Config() runs, is conv3x3_tc.cu, and bfloat16 runs the
# direct kernel of conv3x3.cu, a row of its own (as is K3's bfloat16 entry):
# the float32 and bfloat16 paths count their launches in separate phases
# (ROW_PHASES). One NN kernel has two launch modes: the sorted stripe (K4),
# which the eval and train steps run every ICP iteration, and dense (K1),
# which the eval step runs with nn_stripe=false. P2's row counts its five
# variants.
KERNELS = {
    "conv3x3": ("mm_masking_tpu_torch/csrc/conv3x3_tc.cu",
                "mm_masking_tpu/ops/pallas/conv2d.py:152", ("conv3x3", "conv3x3_dx")),
    "conv3x3_dk": ("mm_masking_tpu_torch/csrc/conv3x3_dk.cu",
                   "mm_masking_tpu/ops/pallas/conv2d.py:184", ("conv3x3_dk",)),
    "conv3x3_bf16": ("mm_masking_tpu_torch/csrc/conv3x3.cu",
                     "mm_masking_tpu/ops/pallas/conv2d.py:152", ("conv3x3", "conv3x3_dx")),
    "conv3x3_dk_bf16": ("mm_masking_tpu_torch/csrc/conv3x3_dk.cu",
                        "mm_masking_tpu/ops/pallas/conv2d.py:184", ("conv3x3_dk",)),
    "nn_stripe": ("mm_masking_tpu_torch/csrc/nn_assoc.cu",
                  "mm_masking_tpu/ops/pallas/nn_assoc.py:358", ("nn_stripe",)),
    "nn_argmin": ("mm_masking_tpu_torch/csrc/nn_assoc.cu",
                  "mm_masking_tpu/ops/pallas/nn_assoc.py:170", ("nn_argmin",)),
    "conv3x3_nhcw": ("mm_masking_tpu_torch/csrc/conv_probe_nhcw.cu",
                     "benchmarks/probe_pallas_conv.py:105", ("conv3x3_nhcw",)),
    "conv3x3_nhcw_run": ("mm_masking_tpu_torch/csrc/conv_probe_nhcw.cu",
                         "benchmarks/probe_pallas_conv2.py:103",
                         tuple(f"conv3x3_nhcw_run:{v}" for v in VARIANTS)),
    "conv3x3_nhcw_v2": ("mm_masking_tpu_torch/csrc/conv_probe_halo.cu",
                        "benchmarks/probe_pallas_conv3.py:80", ("conv3x3_nhcw_v2",)),
    "conv3x3_flat": ("mm_masking_tpu_torch/csrc/conv_probe_flat.cu",
                     "benchmarks/probe_pallas_conv4.py:104", ("conv3x3_flat",)),
}
# The counted main-path runs whose launches each row sums: the eval step and
# its dense variant, the train steps, the bfloat16 train steps and the probe
# timing (whose bfloat16 K2 yardstick is the bfloat16 K2 row's).
ROW_PHASES = {
    "conv3x3": ("slice", "dense", "train"),
    "conv3x3_dk": ("train",),
    "conv3x3_bf16": ("train_bf16", "probes"),
    "conv3x3_dk_bf16": ("train_bf16",),
    "nn_stripe": ("slice", "dense", "train", "train_bf16"),
    "nn_argmin": ("slice", "dense", "train", "train_bf16"),
}
# Each probe's row is timed at the canonical low-channel stage (B = 16, 640^2,
# 16 -> 16, bf16) with the probe's own default tile.
PROBE_ROWS = {
    "conv3x3_nhcw": "P1 B16 640x640 16->16 TH8",
    "conv3x3_nhcw_run": "P2 B16 640x640 16->16 TH8 full",
    "conv3x3_nhcw_v2": "P3 B16 640x640 16->16 TH16",
    "conv3x3_flat": "P4 B16 640x640 16->16 TH16 ndot1",
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def seq_bound(works) -> tuple[float, str]:
    """The bound of a run of conv launches, each (operations, bytes, input
    type), at the tensor cores' rate for the type: the sum of their bounds,
    and the term that binds most of it."""
    by = {"bytes": 0.0, "operations": 0.0}
    for ops, nbytes, dtype in works:
        t, which = bound_ms(ops, nbytes, dtype, matmul=True)
        by[which] += t
    return sum(by.values()), max(by, key=by.get)


def conv_works(shapes, batch, dtype=torch.float32) -> dict[str, list]:
    """(operations, bytes, type) of one step's convs at ``batch``: the
    forward (x, weight and bias in, y out), dx (dy and weight in, dx out;
    every conv but the first) and dk (x and dy in, dk out). Activations take
    ``dtype``'s bytes, the weights (and dk) float32's."""
    works = {"fwd": [], "dx": [], "dk": []}
    elem = torch.finfo(dtype).bits // 8
    for i, (ci, co, h) in enumerate(shapes):
        ops = 18 * ci * co * batch * h * h
        io = elem * batch * h * h * (ci + co) + 4 * 9 * ci * co
        works["fwd"].append((ops, io + 4 * co, dtype))
        if i > 0:
            works["dx"].append((ops, io, dtype))
        works["dk"].append((ops, io, dtype))
    return works


def check_hmma(lib) -> None:
    """Count the HMMA (tensor-core mma) instructions in the SASS of each
    instantiation of the float32 conv kernel; fail if one has none."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        if "conv3x3_tf32x3_kernel" in name:
            counts[name] = section.count("HMMA")
    for name, n in counts.items():
        log("build", f"{n} HMMA instructions in {name}")
    if not counts or not all(counts.values()):
        raise AssertionError(f"the f32 conv kernel's SASS lacks HMMA instructions: {counts}")


def check_conv(device, shapes) -> tuple[float, float, float, float]:
    """Conv kernel vs plain at every UNet stage shape; returns (max f32 abs
    error, max bf16 abs error, kernel ms, plain ms) with the times summed
    over one forward's convs at B = 32."""
    g = torch.Generator().manual_seed(0)
    err32 = err16 = 0.0
    for ci, co, h in sorted(set(shapes)):
        x = torch.randn(CHECK_BATCH, ci, h, h, generator=g)
        w = torch.randn(co, ci, 3, 3, generator=g) * math.sqrt(2.0 / (9 * (ci + co)))
        b = torch.randn(co, generator=g) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            xs, ws, bs = (t.to(device, dtype) for t in (x, w, b))
            got = conv3x3(xs, ws, bs, True).float()
            want = conv3x3_plain(xs, ws, bs, True).float()
            scale = max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            rel = err / scale
            # f32: summation order (cuDNN may pick Winograd/FFT algorithms);
            # bf16: one rounding of the output to 8 significant bits.
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            log("kernels", f"conv3x3 Ci={ci:3d} Co={co:3d} {h:3d}^2 {str(dtype)[6:]:8s} "
                f"max|d|={err:.3e} max|d|/max|y|={rel:.3e}")
            if rel > tol:
                raise AssertionError(f"conv3x3 {ci}->{co} @{h} {dtype}: {rel} > {tol}")
            if dtype == torch.float32:
                err32 = max(err32, err)
            else:
                err16 = max(err16, err)
    ms = plain_ms = 0.0
    for ci, co, h in sorted(set(shapes)):
        n = shapes.count((ci, co, h))
        x = torch.randn(BATCH, ci, h, h, device=device)
        w = torch.randn(co, ci, 3, 3, device=device) * math.sqrt(2.0 / (9 * (ci + co)))
        b = torch.zeros(co, device=device)
        k, p = in_turns(lambda: conv3x3_plain(x, w, b, True),
                        lambda: conv3x3(x, w, b, True), cuda_ms)
        log("kernels", f"conv3x3 B={BATCH} Ci={ci:3d} Co={co:3d} {h:3d}^2 x{n}: "
            f"kernel {k:.3f} ms, plain {p:.3f} ms")
        ms += n * k
        plain_ms += n * p
    return err32, err16, ms, plain_ms


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def check_backward(x, dy, w, label: str) -> tuple[float, float]:
    """dx (K2) and dk (K3) vs their plain versions on one set of tensors, dk
    also bitwise across two runs and against a float64 sum; raises beyond
    the limits and returns (max |Δdx|, max |Δdk|)."""
    dk = conv3x3_dk(x, dy)
    if not torch.equal(dk, conv3x3_dk(x, dy)):
        raise AssertionError(f"conv3x3_dk {label}: two runs differ")
    # dk: the same float32 products summed in another order (bf16 inputs are
    # widened exactly); dx: f32 summation order, or one rounding to bf16.
    dk_p = conv3x3_dk_plain(x, dy)
    dx, dx_p = conv3x3_dx(dy, w), conv3x3_dx_plain(dy, w)
    e_dk, e_dx = rel_err(dk, dk_p), rel_err(dx, dx_p)
    # Both dk against float64 sums of the same inputs. The kernel-vs-plain
    # limit on dk is set by cuDNN's wgrad, which is off from the float64 sum
    # by up to 8.3e-5 (64 -> 64 at 160^2, B = 16, on the H100); K3 stays
    # within 1.2e-6 of it there and everywhere else, hence its own 1e-5.
    dk64 = torch.nn.grad.conv2d_weight(x.double(), dk.shape, dy.double(), padding=1)
    e64, e64_p = rel_err(dk, dk64), rel_err(dk_p, dk64)
    bf = x.dtype == torch.bfloat16
    log("kernels", f"backward {label} dx rel {e_dx:.3e}, dk rel {e_dk:.3e} (vs float64: "
        f"kernel {e64:.3e}, plain {e64_p:.3e}), dk bitwise stable")
    if e_dk > 1e-4 or e64 > 1e-5 or e_dx > (2e-2 if bf else 1e-4):
        raise AssertionError(f"conv backward {label}: dx {e_dx}, dk {e_dk}, dk vs "
                             f"float64 {e64}")
    return (dx.float() - dx_p.float()).abs().max().item(), (dk - dk_p).abs().max().item()


def check_conv_backward(device, shapes) -> dict[str, float]:
    """dx (K2) and dk (K3) vs plain at every UNet stage shape, f32 and bf16 at
    B = 4 and f32 at the train step's B = 16 (K3 splits its work by B); then
    forward, dx and dk times next to their plain versions at B = 16, summed
    over one step (the first conv takes no dx: its input needs no gradient)."""
    g = torch.Generator().manual_seed(1)
    worst = {"dx_abs": 0.0, "dk_abs": 0.0, "dx_abs_bf16": 0.0, "dk_abs_bf16": 0.0}

    def check(x, dy, w, label):
        dx_abs, dk_abs = check_backward(x, dy, w, label)
        suffix = "_bf16" if x.dtype == torch.bfloat16 else ""
        worst["dx_abs" + suffix] = max(worst["dx_abs" + suffix], dx_abs)
        worst["dk_abs" + suffix] = max(worst["dk_abs" + suffix], dk_abs)

    for ci, co, h in sorted(set(shapes)):
        x = torch.randn(CHECK_BATCH, ci, h, h, generator=g)
        dy = torch.randn(CHECK_BATCH, co, h, h, generator=g)
        w = torch.randn(co, ci, 3, 3, generator=g) * math.sqrt(2.0 / (9 * (ci + co)))
        for dtype in (torch.float32, torch.bfloat16):
            check(*(t.to(device, dtype) for t in (x, dy, w)),
                  f"B={CHECK_BATCH} Ci={ci:3d} Co={co:3d} {h:3d}^2 {str(dtype)[6:]:8s}")
    first, gd = shapes[0], torch.Generator(device=device).manual_seed(2)
    ms = {k: 0.0 for k in ("fwd", "fwd_plain", "dx", "dx_plain", "dk", "dk_plain")}
    for ci, co, h in sorted(set(shapes)):
        n = shapes.count((ci, co, h))
        n_dx = n - int((ci, co, h) == first)
        x = torch.randn(TRAIN_BATCH, ci, h, h, generator=gd, device=device)
        dy = torch.randn(TRAIN_BATCH, co, h, h, generator=gd, device=device)
        w = torch.randn(co, ci, 3, 3, generator=gd, device=device) * math.sqrt(
            2.0 / (9 * (ci + co)))
        b = torch.zeros(co, device=device)
        check(x, dy, w, f"B={TRAIN_BATCH} Ci={ci:3d} Co={co:3d} {h:3d}^2 float32 ")
        f, fp = in_turns(lambda: conv3x3_plain(x, w, b, True),
                         lambda: conv3x3_forward(x, w, b, True), cuda_ms)
        dx, dxp = in_turns(lambda: conv3x3_dx_plain(dy, w), lambda: conv3x3_dx(dy, w), cuda_ms)
        dk, dkp = in_turns(lambda: conv3x3_dk_plain(x, dy), lambda: conv3x3_dk(x, dy), cuda_ms)
        log("kernels", f"B={TRAIN_BATCH} Ci={ci:3d} Co={co:3d} {h:3d}^2 x{n}: forward "
            f"{f:.3f} (plain {fp:.3f}) ms, dx {dx:.3f} ({dxp:.3f}) ms, dk {dk:.3f} "
            f"({dkp:.3f}) ms")
        for key, t, k in (("fwd", f, n), ("fwd_plain", fp, n), ("dx", dx, n_dx),
                          ("dx_plain", dxp, n_dx), ("dk", dk, n), ("dk_plain", dkp, n)):
            ms[key] += k * t
    log("kernels", f"one train step's convs at B={TRAIN_BATCH} (ms, kernel / plain): "
        f"forward {ms['fwd']:.2f} / {ms['fwd_plain']:.2f}, dx {ms['dx']:.2f} / "
        f"{ms['dx_plain']:.2f}, dk {ms['dk']:.2f} / {ms['dk_plain']:.2f}")
    return {**worst, **ms}


def time_conv_bf16(device, shapes) -> dict[str, float]:
    """One bfloat16 train step's forward, dx and dk at B = 16, stage by
    stage: the kernels beside their plain versions (float32 cuDNN on the
    widened inputs) and beside cuDNN's own bfloat16 calls (``F.conv2d``,
    ``conv2d_weight``), in turns; ms summed over the step's convs."""
    first, gd = shapes[0], torch.Generator(device=device).manual_seed(4)
    keys = [f"{job}{path}" for job in ("fwd", "dx", "dk") for path in ("", "_plain", "_lib")]
    ms = dict.fromkeys(keys, 0.0)
    for ci, co, h in sorted(set(shapes)):
        n = shapes.count((ci, co, h))
        n_dx = n - int((ci, co, h) == first)
        x = torch.randn(TRAIN_BATCH, ci, h, h, generator=gd, device=device).bfloat16()
        dy = torch.randn(TRAIN_BATCH, co, h, h, generator=gd, device=device).bfloat16()
        w = (torch.randn(co, ci, 3, 3, generator=gd, device=device) * math.sqrt(
            2.0 / (9 * (ci + co)))).bfloat16()
        b = torch.zeros(co, device=device, dtype=torch.bfloat16)
        jobs = {
            "fwd": (lambda: conv3x3_forward(x, w, b, True), lambda: conv3x3_plain(x, w, b, True),
                    lambda: torch.relu(F.conv2d(x, w, b, padding=1))),
            "dx": (lambda: conv3x3_dx(dy, w), lambda: conv3x3_dx_plain(dy, w),
                   lambda: torch.nn.grad.conv2d_input(x.shape, w, dy, padding=1)),
            "dk": (lambda: conv3x3_dk(x, dy), lambda: conv3x3_dk_plain(x, dy),
                   lambda: torch.nn.grad.conv2d_weight(x, w.shape, dy, padding=1)),
        }
        row = {}
        for job, (kernel, plain, lib) in jobs.items():
            k, lib_ms = in_turns(lib, kernel, cuda_ms)
            row[job] = (k, cuda_ms(plain), lib_ms)
            for path, t in zip(("", "_plain", "_lib"), row[job]):
                ms[job + path] += (n_dx if job == "dx" else n) * t
        log("kernels", f"bf16 B={TRAIN_BATCH} Ci={ci:3d} Co={co:3d} {h:3d}^2 x{n} (ms, kernel / "
            f"plain / cuDNN bf16): " + ", ".join(
                f"{job} {k:.3f} / {p:.3f} / {lb:.3f}" for job, (k, p, lb) in row.items()))
    log("kernels", f"one bf16 train step's convs at B={TRAIN_BATCH} (ms, kernel / plain / cuDNN "
        f"bf16): " + ", ".join(f"{job} {ms[job]:.2f} / {ms[job + '_plain']:.2f} / "
                               f"{ms[job + '_lib']:.2f}" for job in ("fwd", "dx", "dk")))
    return ms


def nn_inputs(batch):
    """Scan points under the initial guess and the map, as the ICP sees them."""
    scan = batch["loc_data"]["filtered_pc"][..., :3]
    p = transform_points(batch["transforms"]["T_ml_init"], scan).contiguous()
    return p, batch["map_data"]["pc"]


def check_dense(batch) -> tuple[float, float, float]:
    p, q = nn_inputs(batch)
    ps, qs = p[:CHECK_BATCH].contiguous(), q[:CHECK_BATCH]
    idx, d2 = nn_assoc.nn_argmin(ps, qs)
    with kernels.plain_versions():
        idx_p, d2_p = nn_assoc.nn_argmin(ps, qs)
    err = (d2 - d2_p).abs().max().item()
    log("kernels", f"nn_argmin {tuple(ps.shape[:2]) + (qs.shape[1],)}: idx equal "
        f"{bool(torch.equal(idx, idx_p))}, max|d2-d2_plain|={err:.3e}")
    if not torch.equal(idx, idx_p):
        raise AssertionError("nn_argmin: kernel and plain indices differ")
    q4 = nn_assoc.map_layout(q)
    q3 = q[..., :3]

    def plain():
        with kernels.plain_versions():
            nn_assoc.nn_argmin(p, q3)

    k_ms, p_ms = in_turns(plain, lambda: nn_assoc.nn_argmin(p, q3, q4),
                          lambda fn: cuda_ms(fn, reps=3))
    B, N, M = p.shape[0], p.shape[1], q.shape[1]
    # 8 operations per (scan, map) pair: 3 differences, 3 squares, 2 sums;
    # p and q in, index and d2 out.
    bound = bound_ms(8 * B * N * M, B * (12 * N + 12 * M + 8 * N), torch.float32)
    log("kernels", f"nn_argmin B={B} N={N} M={M}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
        f"bound {bound[0]:.4f} ms ({bound[1]})")
    return err, k_ms, p_ms, bound


def check_stripe(batch) -> tuple[float, float, float]:
    p, q = nn_inputs(batch)
    q_s, key_s, use_x = nn_assoc.stripe_sort_target(q)
    order = torch.argsort(torch.where(use_x[:, None], p[..., 0], p[..., 1]), dim=1,
                          stable=True)
    p = torch.gather(p, 1, order[..., None].expand(-1, -1, 3)).contiguous()
    B, N, M = p.shape[0], p.shape[1], q.shape[1]
    window = M // 4  # the dispatcher's default window, and its block size:
    tm = next(t for t in (1024, 512, 256, 128) if M % t == 0 and window % t == 0)
    start, nblk = nn_assoc.stripe_blocks(p, key_s, use_x, TRIM, TILE, tm)
    nblk = nblk.clamp(max=window // tm + 1)
    nblk[1::3] = 0  # frozen items, as the per-item tolerance freeze makes them
    log("kernels", f"nn_stripe nblk histogram "
        f"{torch.bincount(nblk.flatten().long()).tolist()}")
    q3, q4 = q_s[..., :3], nn_assoc.map_layout(q_s)
    idx, d2 = nn_assoc.nn_stripe(p, q3, start, nblk, tm, q4)
    with kernels.plain_versions():
        idx_p, d2_p = nn_assoc.nn_stripe(p, q3, start, nblk, tm)
    live = (nblk > 0).repeat_interleave(TILE, dim=1)
    same = torch.equal(idx[live], idx_p[live])
    err = (d2[live] - d2_p[live]).abs().max().item()
    log("kernels", f"nn_stripe B={B} N={N} M={M} tm={tm}: idx equal on live "
        f"items {same}, max|d2-d2_plain|={err:.3e}")
    if not same:
        raise AssertionError("nn_stripe: kernel and plain indices differ on live items")

    def plain():
        with kernels.plain_versions():
            nn_assoc.nn_stripe(p, q3, start, nblk, tm)

    k_ms, p_ms = in_turns(plain, lambda: nn_assoc.nn_stripe(p, q3, start, nblk, tm, q4),
                          lambda fn: cuda_ms(fn, reps=3))
    # The pairs this launch's nblk asks for: each live tile of TILE rows
    # against nblk blocks of tm map points, 8 operations each.
    pairs = int(nblk.long().sum()) * tm * TILE
    bound = bound_ms(8 * pairs, B * (12 * N + 12 * M + 8 * N) + 2 * nblk.numel() * 4,
                     torch.float32)
    log("kernels", f"nn_stripe: {pairs} candidate pairs; kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return err, k_ms, p_ms, bound


def yaw_deg(R: torch.Tensor) -> torch.Tensor:
    return torch.rad2deg(torch.atan2(R[..., 1, 0], R[..., 0, 0]))


def run_slice(trainer: Trainer, params: dict, batch) -> tuple[dict, dict]:
    """``Trainer.eval_step`` checked against the eager kernel path and the
    plain path; returns the counters of the main path's step and the
    solve's iterations and stop-test reads."""
    cfg = trainer.cfg
    trainer.eval_step(params, batch)  # warm-up: captures the solve's graph; allocator
    torch.cuda.synchronize()

    # The main path, through the user's entry point, with counters from 0.
    kernels.reset_launch_counts()
    err, stats, mask = trainer.eval_step(params, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log("slice", f"launches {counts}")
    log("slice", f"err (norm, rot, trans) {err.tolist()} mean_num_non0 "
        f"{float(stats.mean_num_non0)} mean_w {float(stats.mean_w):.4f}")
    n_conv = len(conv3x3_shapes(cfg.model.enc_channels, cfg.model.cart_pixel_width))
    if counts["conv3x3"] != n_conv:
        raise AssertionError(f"expected {n_conv} conv3x3 launches, got {counts['conv3x3']}")
    if counts["nn_stripe"] + counts["nn_argmin"] < 1:
        raise AssertionError("the ICP launched no NN kernel")
    width = cfg.model.cart_pixel_width
    loc, mp, T0 = batch["loc_data"], batch["map_data"], batch["transforms"]["T_ml_init"]
    if not torch.isfinite(err).all() or mask.shape != (len(T0), width, width):
        raise AssertionError(f"bad outputs: err {err}, mask {tuple(mask.shape)}")
    if not torch.isfinite(mask).all() or float(mask.max()) != 1.0:
        raise AssertionError("mask is not finite or not normalised to a max of 1")

    with torch.inference_mode():
        kernels.reset_launch_counts()
        out = trainer.policy.apply(params, loc, mp, T0)
        torch.cuda.synchronize()
        nn_launches = sum(kernels.launch_counts()[k] for k in ("nn_stripe", "nn_argmin"))
        with kernels.eager():
            eager = trainer.policy.apply(params, loc, mp, T0)
        with kernels.plain_versions():
            ref = trainer.policy.apply(params, loc, mp, T0)
    iters, stop_tests = int(out.icp_info["iterations"]), out.icp_info["stop_tests"]
    max_iter = cfg.model.inference_max_iter
    log("slice", f"ICP iterations {iters} (eager {int(eager.icp_info['iterations'])}, plain "
        f"path {int(ref.icp_info['iterations'])}), NN launches {nn_launches}; the solve read "
        f"its stop test {stop_tests} times (chunks of {STOP_TEST_EVERY} iterations, at most "
        f"{math.ceil(max_iter / STOP_TEST_EVERY)})")
    if nn_launches < iters:
        raise AssertionError(f"{nn_launches} NN launches for {iters} ICP iterations")
    if stop_tests > math.ceil(max_iter / STOP_TEST_EVERY):
        raise AssertionError(f"{stop_tests} stop-test reads for {max_iter} iterations")
    # The same kernels on the same inputs, replayed or launched one by one.
    # Each pose's own yaw: the yaw of R·R_eagerᵀ would read ~1e-7 rad of
    # float32 rounding even for equal poses.
    dt_e = (out.T_pred[:, :3, 3] - eager.T_pred[:, :3, 3]).norm(dim=-1).max().item()
    dyaw_e = (yaw_deg(out.T_pred[:, :3, :3]) - yaw_deg(eager.T_pred[:, :3, :3])).abs()
    log("slice", f"graph vs eager kernel path: every item max |dt|={dt_e:.3e} m, max "
        f"|dyaw|={dyaw_e.max().item():.3e} deg, poses bitwise equal "
        f"{bool(torch.equal(out.T_pred, eager.T_pred))}")
    if (iters != int(eager.icp_info["iterations"]) or dt_e > 1e-6
            or dyaw_e.max().item() > 1e-5):
        raise AssertionError("graph and eager eval solves differ beyond equal iterations, "
                             "1e-6 m / 1e-5 deg")
    conv = (out.icp_info["delta_norm"] < 1e-5) & (ref.icp_info["delta_norm"] < 1e-5)
    dt = (out.T_pred[:, :3, 3] - ref.T_pred[:, :3, 3]).norm(dim=-1)
    dyaw = yaw_deg(out.T_pred[:, :3, :3] @ ref.T_pred[:, :3, :3].transpose(1, 2)).abs()
    mask_d = (out.weight_mask - ref.weight_mask).abs().max().item()
    log("slice", f"kernel vs plain: mask max|d|={mask_d:.3e}; {int(conv.sum())}/{len(conv)} "
        f"items converged on both paths: max |dt|={dt[conv].max().item():.3e} m, "
        f"max |dyaw|={dyaw[conv].max().item():.3e} deg")
    if (~conv).any():
        log("slice", f"not converged: items {torch.nonzero(~conv).flatten().tolist()}, "
            f"|dt| {dt[~conv].tolist()} m, |dyaw| {dyaw[~conv].tolist()} deg")
    if not conv.any() or dt[conv].max().item() > 1e-3 or dyaw[conv].max().item() > 5e-3:
        raise AssertionError("kernel and plain poses differ beyond 1 mm / 0.005 deg")
    return counts, {"iterations": iters, "stop_tests": stop_tests}


PATHS = {"graph": contextlib.nullcontext, "eager": kernels.eager,
         "plain": kernels.plain_versions}


def spread(times: list[float]) -> str:
    return (f"median {statistics.median(times):.1f} ms (min {min(times):.1f}, max "
            f"{max(times):.1f}, n {len(times)})")


def three_paths(turn) -> dict[str, list[float]]:
    """``turn(path)`` (a list of host-clock ms) on the graph path (CUDA graphs
    on the kernels), the eager kernel path and the plain path, in turns
    plain, eager, graph, graph, eager, plain: {path: every time}."""
    times = {path: [] for path in PATHS}
    for path in ("plain", "eager", "graph", "graph", "eager", "plain"):
        with PATHS[path]():
            times[path] += turn(path)
    return times


def host_ms(fn, reps: int = 3) -> list[float]:
    """Host-clock ms of `reps` calls of fn, each ending in a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def time_eval(trainer: Trainer, params: dict, batch) -> dict[str, list[float]]:
    """Host-clock ms of ``Trainer.eval_step`` on the three paths, 3 steps a
    turn (the graph path's graphs are captured already)."""
    times = three_paths(lambda path: host_ms(lambda: trainer.eval_step(params, batch)))
    log("slice", f"eval_step B={len(batch['transforms']['T_ml_init'])} "
        f"{trainer.cfg.model.cart_pixel_width}^2 N={batch['loc_data']['raw_pc'].shape[1]} "
        f"M={batch['map_data']['pc'].shape[1]}, host clock: " + "; ".join(
            f"{path} {spread(t)}" for path, t in times.items()))
    return times


def check_unet_gradient(device, trainer: Trainer, params: dict) -> float:
    """Full-width UNet gradient under a fixed random cotangent, kernels vs
    plain; returns the worst per-tensor max |Δ| / max |g_plain|."""
    width = trainer.cfg.model.cart_pixel_width
    g = torch.Generator().manual_seed(3)
    x = torch.rand(TRAIN_BATCH, 1, width, width, generator=g).to(device)
    cot = torch.randn(TRAIN_BATCH, width, width, generator=g).to(device)
    names = [n for n, _ in trainer.policy.unet.named_parameters()]

    def grads(inp):
        leaves = {k: v.detach().clone().requires_grad_(k in names) for k, v in params.items()}
        mask = functional_call(trainer.policy.unet, leaves, (inp,))
        return torch.autograd.grad(mask, [leaves[n] for n in names], cot)

    got = grads(x)
    with kernels.plain_versions():
        want = grads(x)
        # The conditioning: the plain path against itself on an input moved
        # by about one float32 ulp.
        nudged = grads(x * (1.0 + 2.0 ** -23 * torch.randn(x.shape, generator=g).to(device)))
    self_err = max(rel_err(a, b) for a, b in zip(nudged, want))
    log("train", f"plain path vs itself on a 1-ulp-nudged input: worst max|d|/max|g| "
        f"{self_err:.3e}")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, got, want)}
    norm_errs = [((a - b).norm() / b.norm()).item() for a, b in zip(got, want)]
    worst = max(errs, key=errs.get)
    log("train", f"UNet gradient B={TRAIN_BATCH} {width}^2, kernels vs plain: worst "
        f"tensor {worst} max|d|/max|g| {errs[worst]:.3e}; median "
        f"{statistics.median(errs.values()):.3e}; worst |d|/|g| {max(norm_errs):.3e}")
    # Limit 1e-2: float32 sums in other orders through up to 30 convs of the
    # backward, amplified by the cancellation a random cotangent leaves in
    # the deep layers' gradients, and ReLU gates that flip where a
    # pre-activation is within rounding of 0; the upsample's index_add sums
    # with atomics on both paths. Each kernel alone agrees to <= 1e-4.
    if not all(math.isfinite(e) for e in errs.values()) or errs[worst] > 1e-2:
        raise AssertionError(f"UNet gradient differs from the plain path: {errs}")
    return errs[worst]


def time_train(trainer: Trainer, batch, label: str) -> dict[str, tuple[list[float], float]]:
    """Host-clock ms of 3 ``Trainer.train_step`` calls a turn on each path
    from a fresh state (the graph path's capture made first, outside the
    time), with each path's peak device memory in MiB (the graph's memory
    pool and its capture included): {path: (times, peak)}."""
    peaks = {}

    def turn(path):
        state = trainer.init_state(seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.capture_train_step(state, batch)
        times = host_ms(lambda: trainer.train_step(state, batch))
        peaks[path] = max(peaks.get(path, 0.0), torch.cuda.max_memory_allocated() / 2**20)
        return times

    times = three_paths(turn)
    width = trainer.cfg.model.cart_pixel_width
    log(label, f"train_step B={TRAIN_BATCH} {width}^2 N={N_SCAN} M={N_MAP} "
        f"{trainer.cfg.model.dtype}, host clock: " + "; ".join(
            f"{path} {spread(t)}, peak {peaks[path]:.0f} MiB" for path, t in times.items()))
    return {path: (t, peaks[path]) for path, t in times.items()}


def captured_steps(trainer: Trainer, batch, label: str):
    """Capture the train step for a fresh state, then run 3 steps (replays)
    with the counters from 0: (state, its parameters before and after the
    first step, the steps, the counters)."""
    state = trainer.init_state(seed=0)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    t0 = time.perf_counter()
    trainer.capture_train_step(state, batch)
    torch.cuda.synchronize()
    (graph,) = state.graphs.values()
    log(label, f"captured the train step in {time.perf_counter() - t0:.2f} s (warm-up "
        f"included): {sum(graph.step.launches.values())} launches of the port's kernels per "
        f"replay, {graph.step.launches}")
    # The main path, through the user's entry point, with counters from 0.
    kernels.reset_launch_counts()
    steps = [trainer.train_step(state, batch)]
    p1 = {k: v.detach().clone() for k, v in state.params.items()}
    steps += [trainer.train_step(state, batch) for _ in range(TRAIN_STEPS - 1)]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(label, f"launches over {TRAIN_STEPS} steps {counts}")
    cfg = trainer.cfg
    n_conv = len(conv3x3_shapes(cfg.model.enc_channels, cfg.model.cart_pixel_width))
    want = {"conv3x3": n_conv, "conv3x3_dx": n_conv - 1, "conv3x3_dk": n_conv}
    for name, n in want.items():
        if counts[name] != TRAIN_STEPS * n:
            raise AssertionError(f"expected {TRAIN_STEPS * n} {name} launches, got "
                                 f"{counts[name]}")
    n_nn = counts["nn_stripe"] + counts["nn_argmin"]
    if n_nn < TRAIN_STEPS * cfg.model.max_iter:
        raise AssertionError(f"{n_nn} NN launches for {TRAIN_STEPS} steps of "
                             f"{cfg.model.max_iter} ICP iterations")
    losses = [s[1].item() for s in steps]
    gnorms = [s[3].item() for s in steps]
    log(label, f"loss {losses} grad_norm {gnorms} components "
        f"{ {f: round(v.item(), 6) for f, v in steps[0][2]._asdict().items()} }")
    if not all(map(math.isfinite, losses + gnorms)) or int(state.opt.total_notfinite):
        raise AssertionError(f"non-finite step: loss {losses}, grad_norm {gnorms}, "
                             f"{int(state.opt.total_notfinite)} updates dropped")
    moved = {k: (state.params[k] - p0[k]).abs().max().item() for k in trainer._trained}
    if not all(math.isfinite(v) and v > 0 for v in moved.values()):
        raise AssertionError(f"parameters not updated or not finite: {moved}")
    log(label, f"every parameter tensor moved, by at most {max(moved.values()):.3e}")
    return state, p0, p1, steps, counts


def run_train(device, cfg: Config) -> tuple[dict, dict]:
    """``Trainer.train_step`` at full width, B = 16, replayed from its CUDA
    graph; returns (the counters of the main path's 3 steps, measured
    numbers)."""
    trainer = Trainer(cfg, device)
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    state, p0, p1, steps, counts = captured_steps(trainer, batch, "train")
    losses = [s[1].item() for s in steps]
    gnorms = [s[3].item() for s in steps]

    # The same 3 steps eagerly on the kernels, from the same seed (same
    # parameters and dropout masks), twice: the graph replays launch the same
    # kernels on the same data. The parameters are held after the first
    # step: later steps differ as far as the atomics of the upsample's and
    # grid_sample's backward move the first update, as two eager runs do.
    eager_states = [trainer.init_state(seed=0) for _ in range(2)]
    eager, eager_p1 = [], []
    with kernels.eager():
        for st in eager_states:
            eager.append([trainer.train_step(st, batch)])
            eager_p1.append({k: v.detach().clone() for k, v in st.params.items()})
            eager[-1] += [trainer.train_step(st, batch) for _ in range(TRAIN_STEPS - 1)]
    d_loss_e = max(abs(a - e[1].item()) / abs(e[1].item()) for a, e in zip(losses, eager[0]))
    d_gnorm_e = max(abs(a - e[3].item()) / e[3].item() for a, e in zip(gnorms, eager[0]))
    scale = max(v.abs().max().item() for k, v in eager_p1[0].items() if k in trainer._trained)

    def param_diff(a: dict, b: dict) -> tuple[float, str]:
        """Largest |Δp| over the trained tensors, over the largest |p| of all
        of them, and the tensor it is in."""
        d = {k: (a[k] - b[k]).abs().max().item() for k in trainer._trained}
        worst = max(d, key=d.get)
        return d[worst] / scale, f"{worst} (max |p| there {b[worst].abs().max().item():.3e})"

    d_param_e, where = param_diff(p1, eager_p1[0])
    d_param_3, where_3 = param_diff(state.params, eager_states[0].params)
    d_param_ee, where_ee = param_diff(eager_states[1].params, eager_states[0].params)
    log("train", f"graph vs eager kernel path: loss rel {d_loss_e:.3e}, grad_norm rel "
        f"{d_gnorm_e:.3e} over {TRAIN_STEPS} steps; parameters max|d| / max|p| {d_param_e:.3e} "
        f"after step 1 in {where}, {d_param_3:.3e} after step {TRAIN_STEPS} in {where_3} "
        f"(eager vs eager: {d_param_ee:.3e} in {where_ee})")
    if d_loss_e > 1e-6 or d_gnorm_e > 1e-6 or d_param_e > 1e-5:
        raise AssertionError("graph and eager train steps differ beyond loss / grad_norm 1e-6 "
                             "relative, parameters 1e-5 of max |p|")

    # The first step again on the plain path, from the same seed.
    with kernels.plain_versions():
        _, loss_p, _, gnorm_p = trainer.train_step(trainer.init_state(seed=0), batch)
    d_loss = abs(losses[0] - loss_p.item()) / abs(loss_p.item())
    d_gnorm = abs(gnorms[0] - gnorm_p.item()) / gnorm_p.item()
    log("train", f"step 1 kernel vs plain: loss {losses[0]:.7g} vs {loss_p.item():.7g} "
        f"(rel {d_loss:.3e}), grad_norm {gnorms[0]:.7g} vs {gnorm_p.item():.7g} "
        f"(rel {d_gnorm:.3e})")
    # grad_norm, limit 1e-4: the mask differs from the plain path's at the
    # 1e-6 level and the 10 unrolled GN iterations are smooth in it, and the
    # upsample's and grid_sample's backward sum with atomics; runs on the
    # H100 agreed to <= 2e-7. A nearest neighbour that flips between the two
    # paths would change one point's residual term by more; so would a dk or
    # dx off by 1e-3, which the limit is meant to catch.
    if d_loss > 1e-4 or d_gnorm > 1e-4:
        raise AssertionError("train step differs from the plain path beyond loss 1e-4 / "
                             "grad_norm 1e-4 relative")
    unet_rel = check_unet_gradient(device, trainer, p0)
    times = time_train(trainer, batch, "train")
    return counts, {"times": times, "loss_rel": d_loss, "gnorm_rel": d_gnorm,
                    "unet_grad_rel": unet_rel, "eager_loss_rel": d_loss_e,
                    "eager_gnorm_rel": d_gnorm_e, "eager_param_rel": d_param_e}


def run_train_bf16(device, cfg: Config) -> tuple[dict, dict]:
    """The same train step with ``model.dtype="bfloat16"`` (K2's and K3's
    bfloat16 kernels): 3 replays, finite, timed on the three paths. The
    loss is not held to the float32 step's: bfloat16 activations, and the
    grad_norm of 1e7 or more that bfloat16 gives the reference too."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    trainer = Trainer(cfg, device)
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    *_, counts = captured_steps(trainer, batch, "train_bf16")
    return counts, {"times": time_train(trainer, batch, "train_bf16")}


def run_probes(device) -> tuple[dict, dict]:
    """Phase 6, the conv-probe path: the checks, then the timing with the
    counters from 0; returns (those counters, {row: measured numbers})."""
    checks = probe_conv.check_all(probe_conv.PROBES, device)
    kernels.reset_launch_counts()
    times = probe_conv.time_all(probe_conv.PROBES, device)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log("probes", f"launches {counts}")
    idle = [w for name in PROBE_ROWS for w in KERNELS[name][2] if counts[w] < 1]
    if idle:
        raise AssertionError(f"probe kernels the probe path never launched: {idle}")
    rows = {}
    for name, label in PROBE_ROWS.items():
        probe = label.split()[0]
        errs = [c["abs"] for c in checks if c["label"].startswith(probe + " ")
                and c["dtype"] == "float32" and c["abs"] is not None]
        t = next(r for r in times if r["label"] == label)
        rows[name] = {"max_abs_err": max(errs), "ms": t["ms"], "plain_ms": t["plain_ms"],
                      "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                      "library_ms": t["library_ms"]}
    return counts, rows


def main() -> int:
    log("env", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"available={torch.cuda.is_available()} python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        log("env", "FAIL: no CUDA device; this script needs one GPU")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda:0")

    info = kernels.build()
    log("build", f"{info.path.name} in {info.seconds:.1f} s")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("build", line.strip())
    check_hmma(info.path)

    cfg = Config()  # full width: enc 8…256 at 640², f32, pt2pt, refresh 0
    batch = synthetic_batch(1, BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    shapes = conv3x3_shapes(cfg.model.enc_channels, cfg.model.cart_pixel_width)
    conv_err, conv_err16, conv_ms, conv_plain = check_conv(device, shapes)
    bwd = check_conv_backward(device, shapes)
    bf16 = time_conv_bf16(device, shapes)
    dense = check_dense(batch)
    stripe = check_stripe(batch)
    trainer = Trainer(cfg, device)
    params = trainer.init_state(seed=0).params
    counts, solve = run_slice(trainer, params, batch)
    eval_times = time_eval(trainer, params, batch)
    dense_trainer = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, icp_overrides=cfg.model.icp_overrides + ("nn_stripe=false",))), device)
    dense_counts, _ = run_slice(dense_trainer, dense_trainer.init_state(seed=0).params, batch)
    if dense_counts["nn_stripe"] or not dense_counts["nn_argmin"]:
        raise AssertionError(f"nn_stripe=false did not take the dense NN: {dense_counts}")
    del batch
    train_counts, train = run_train(device, cfg)
    bf16_counts, train_bf16 = run_train_bf16(device, cfg)
    probe_counts, probes = run_probes(device)

    # launches: the sum over the counted main-path runs of ROW_PHASES.
    # Errors: max |kernel − plain| over every stage, at B = 4 for the
    # forward and at B = 4 and 16 for dx and dk (bfloat16: B = 4). conv3x3
    # (forward and dx): one train step's forward + dx at B = 16 (the eval
    # step's forward at B = 32 is logged above); conv3x3_dk: one train
    # step's dk at B = 16. The float32 plain versions are cuDNN's calls
    # (F.conv2d, torch.nn.grad.conv2d_weight), so those are their library
    # times; the bfloat16 plain versions widen to float32, and the library
    # call is cuDNN's own bfloat16 one. No single PyTorch call computes an
    # NN argmin.
    works, works16 = conv_works(shapes, TRAIN_BATCH), conv_works(shapes, TRAIN_BATCH,
                                                                 torch.bfloat16)
    measured = {
        "conv3x3": {"max_abs_err": max(conv_err, bwd["dx_abs"]), "ms": bwd["fwd"] + bwd["dx"],
                    "plain_ms": bwd["fwd_plain"] + bwd["dx_plain"],
                    "library_ms": bwd["fwd_plain"] + bwd["dx_plain"]},
        "conv3x3_dk": {"max_abs_err": bwd["dk_abs"], "ms": bwd["dk"], "plain_ms": bwd["dk_plain"],
                       "library_ms": bwd["dk_plain"]},
        "conv3x3_bf16": {"max_abs_err": max(conv_err16, bwd["dx_abs_bf16"]),
                         "ms": bf16["fwd"] + bf16["dx"],
                         "plain_ms": bf16["fwd_plain"] + bf16["dx_plain"],
                         "library_ms": bf16["fwd_lib"] + bf16["dx_lib"]},
        "conv3x3_dk_bf16": {"max_abs_err": bwd["dk_abs_bf16"], "ms": bf16["dk"],
                            "plain_ms": bf16["dk_plain"], "library_ms": bf16["dk_lib"]},
        "nn_stripe": {"max_abs_err": stripe[0], "ms": stripe[1], "plain_ms": stripe[2],
                      "library_ms": None},
        "nn_argmin": {"max_abs_err": dense[0], "ms": dense[1], "plain_ms": dense[2],
                      "library_ms": None},
        **probes,
    }
    for name, bound in (("conv3x3", seq_bound(works["fwd"] + works["dx"])),
                        ("conv3x3_dk", seq_bound(works["dk"])),
                        ("conv3x3_bf16", seq_bound(works16["fwd"] + works16["dx"])),
                        ("conv3x3_dk_bf16", seq_bound(works16["dk"])),
                        ("nn_stripe", stripe[3]), ("nn_argmin", dense[3])):
        measured[name]["bound_ms"], measured[name]["bound_by"] = bound
    phases = {"slice": counts, "dense": dense_counts, "train": train_counts,
              "train_bf16": bf16_counts, "probes": probe_counts}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(phases[ph][w] for ph in ROW_PHASES.get(name, ("probes",))
                         for w in wrappers),
         **{k: measured[name][k] for k in keys}}
        for name, (src, rep, wrappers) in KERNELS.items()
    ]
    idle = [r["name"] for r in rows if r["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    med = statistics.median
    log("done", "host-clock medians (ms, graph / eager / plain): eval_step " + " / ".join(
        f"{med(t):.1f}" for t in eval_times.values()) + f" ({solve['stop_tests']} stop-test "
        f"reads, {solve['iterations']} iterations), its convs {conv_ms:.2f} (plain "
        f"{conv_plain:.2f}); train_step " + " / ".join(
            f"{med(t):.1f}" for t, _ in train["times"].values()) + "; bf16 train_step " +
        " / ".join(f"{med(t):.1f}" for t, _ in train_bf16["times"].values()) + f" on {smi}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
