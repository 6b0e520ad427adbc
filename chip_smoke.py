#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's eval and train paths once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 - --time-nn < path/to/chip_smoke.py       # from another tree's root
    python3 - --time-lookup < path/to/chip_smoke.py   # likewise

``--time-nn`` only builds that tree's kernels and times its K1 and K4 on this
script's inputs, as phase 3 does, through the wrappers' public names: a
parent commit's kernels timed the same way as this one's. ``--time-lookup``
does the same for the point lookup's backward (``bilinear_points_bwd``) on
the inputs of one eager train step of each type, as phase 3 times it, and
profiles the float32 call kernel by kernel beside ``grid_sampler_2d_backward``.

Phases, each printed as it runs; any failure raises and exits non-zero:

1. env     torch/CUDA versions and the card's name and power limit; fails
           without a CUDA device.
2. build   compiles ``mm_masking_tpu_torch/csrc/*.cu`` with nvcc (sm_90a),
           one process per source; prints ptxas's registers and spills and
           the count of HMMA (tensor-core) instructions in the SASS of each
           instantiation of the conv kernels and of the dk kernels (float32
           and bfloat16 each) and of the bfloat16 probe kernels (P1 and P2's
           full, dot-only, row2 and tap-dots, P3, P4; not asm-only, which
           contracts nothing), and fails if one has none.
3. kernels each CUDA kernel against its plain PyTorch version at the
           path's shapes: the 3x3 conv's forward, dx and dk at every UNet
           stage (f32 and bf16 at B = 4 and at the train step's B = 16;
           dk also bitwise across two runs and against a float64 sum, which
           alone decides dk at B = 16, where the plain version's own error
           nears the kernel-vs-plain limit; the bf16 forward and dx at
           B = 16 also elementwise against a float64 conv), the dense
           NN (K1) at (32, 4096, 16384) and the stripe NN (K4) on a sorted
           synthetic map with mixed block counts, zeros included, each also
           on tie-heavy inputs with rows that find no finite distance (idx 0,
           d2 inf), idx equal and d2 bit for bit, and bitwise across two
           runs; then the median time of each next to its plain version: the
           forward at the eval step's B = 32; K1 and K4 there, replayed from
           CUDA graphs, with their bound and issue floor; the conv's
           forward, dx and dk at the train step's B = 16 in float32 and in
           bfloat16, replayed from CUDA graphs beside cuDNN's own call in
           that type; each with the host-launched time logged beside. Then
           the train step's gather-form backwards (the upsample's axes,
           ``resize_bwd``, and the point lookup's image gradient,
           ``bilinear_points_bwd``) on the inputs an eager step of the
           default Config() and of its bfloat16 variant gives them: each
           call against its plain version (1e-6 of max |g| in float32, 2e-2
           in bfloat16, where the upsample's is also held elementwise against
           a float64 sum) and bitwise across two runs (the point lookup's
           also bit for bit its ordered reference), then one step's calls
           timed, replayed, beside the plain version and the library call
           (``index_add_``; ``grid_sampler_2d_backward``).
4. slice   ``Trainer.eval_step`` at the default ``Config()`` (full-width UNet,
           640x640, f32, pt2pt, 50-iteration stripe ICP) on a 32-item
           synthetic batch of 4096 scan and 16384 map points, with seeded
           random weights; its solve replays CUDA graphs of 5 iterations and
           reads the stop test at most 10 times. The launch counters must
           show the kernels ran; the poses must match the same step run
           eagerly on the kernels (same iteration count, 1e-6 m, 1e-5 deg)
           and with the plain versions. The step's own first stripe
           association, run eagerly, logs its nblk histogram, pairs, bound
           and K4's time on its inputs. Then the same step with the dense
           association (``icp_overrides=("nn_stripe=false",)``), the path of
           K1. Each step is timed on the graph, eager and plain paths. Then
           the eval step once more with ``model.dtype="bfloat16"`` (K2's
           bfloat16 kernel): graph against eager as above, the mask within
           5e-2 of the plain path's, timed on the three paths.
5. train   ``Trainer.train_step`` at the default ``Config()`` (dropout 0.05,
           10 unrolled ICP iterations, Adam at 1e-4) on a 16-item synthetic
           batch of 4096 / 16384 points: the step captured as a CUDA graph,
           then 3 replays. The counters must show every conv forward, dx and
           dk, both axes of every upsample's backward, one lookup backward
           and at least 10 NN launches per step; loss, gradients and
           updated parameters must be finite; each replay must match an
           eager kernel-path step from the state it started from (loss and
           grad_norm within 1e-6 relative, parameters within 1e-5 of max
           |p|, optimizer counters and dropout generator equal); the
           first step's loss and grad_norm must match the plain path's; a
           full-width UNet gradient must match the plain path's; then the
           host-clock step of the graph, eager and plain paths and their
           peak device memory (the graph's pool included). Then the same
           with ``model.dtype="bfloat16"``: 3 replays, finite, timed.
6. determinism  the train step at B = 16 in float32 and in bfloat16:
           two chains of 3 steps from one seed, on the graph path and on the
           eager kernel path, bitwise equal in parameters, Adam moments and
           counters, losses, grad_norms and the dropout generator; a step
           resumed from a checkpoint bitwise equal to the uninterrupted
           run's next step.
7. probes  the conv-probe path (``mm_masking_tpu_torch.benchmarks.probe_conv``):
           each probe kernel P1-P4 and each of P2's five variants against
           its plain version at the probes' check shapes (f32) and at
           B = 16, 640^2, 16 -> 16 (f32 and bf16; asm-only bit for bit),
           then, with counters from 0, each timed at the probes' timing
           shapes beside its library call (cuDNN's conv; for asm-only the
           copy it stores; none for dot-only) and K2, each of P2's variants
           and P4's shapes logged with its time, yardstick and bound; every
           probe kernel and variant must have launched.

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
import tempfile
import time

import torch
import torch.nn.functional as F
from torch.func import functional_call

from mm_masking_tpu_torch.benchmarks import probe_conv
from mm_masking_tpu_torch.benchmarks.timing import bound_ms, cuda_ms, graph_ms, in_turns
from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.dicp.icp import STOP_TEST_EVERY
from mm_masking_tpu_torch.geom import transform_points
from mm_masking_tpu_torch.models.unet import conv3x3_shapes, upsample_shapes
from mm_masking_tpu_torch.ops import kernels
from mm_masking_tpu_torch.ops.kernels import nn_assoc, resample
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
# one the default Config() runs, is conv3x3_tc.cu, and bfloat16 runs
# conv3x3_bf16_tc.cu, a row of its own (as is K3's bfloat16 entry, the
# tensor-core GEMM of conv3x3_dk_tc.cu; float32 dk runs the 3xTF32 GEMM of
# conv3x3_dk_tf32_tc.cu):
# the float32 and bfloat16 paths count their launches in separate phases
# (ROW_PHASES). One NN kernel has two launch modes: the sorted stripe (K4),
# which the eval and train steps run every ICP iteration, and dense (K1),
# which the eval step runs with nn_stripe=false. P2's row counts its five
# variants.
KERNELS = {
    "conv3x3": ("mm_masking_tpu_torch/csrc/conv3x3_tc.cu",
                "mm_masking_tpu/ops/pallas/conv2d.py:152", ("conv3x3", "conv3x3_dx")),
    "conv3x3_dk": ("mm_masking_tpu_torch/csrc/conv3x3_dk_tf32_tc.cu",
                   "mm_masking_tpu/ops/pallas/conv2d.py:184", ("conv3x3_dk",)),
    "conv3x3_bf16": ("mm_masking_tpu_torch/csrc/conv3x3_bf16_tc.cu",
                     "mm_masking_tpu/ops/pallas/conv2d.py:152", ("conv3x3", "conv3x3_dx")),
    "conv3x3_dk_bf16": ("mm_masking_tpu_torch/csrc/conv3x3_dk_tc.cu",
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
    # Beside the TPU kernels: the train step's gather-form backwards of the
    # upsample and the point lookup. The JAX package has no pallas_call
    # there; "replaces" names the JAX function whose VJP each computes.
    "resize_bwd": ("mm_masking_tpu_torch/csrc/resize_bwd.cu",
                   "mm_masking_tpu/models/unet.py:30", ("resize_bwd",)),
    "bilinear_points_bwd": ("mm_masking_tpu_torch/csrc/bilinear_points_bwd.cu",
                            "mm_masking_tpu/ops/grid_sample.py:80", ("bilinear_points_bwd",)),
}
# The counted main-path runs whose launches each row sums: the eval step,
# its dense variant and its bfloat16 run, the train steps, the bfloat16
# train steps and the probe timing (whose bfloat16 K2 yardstick is the
# bfloat16 K2 row's).
ROW_PHASES = {
    "conv3x3": ("slice", "dense", "train"),
    "conv3x3_dk": ("train",),
    "conv3x3_bf16": ("slice_bf16", "train_bf16", "probes"),
    "conv3x3_dk_bf16": ("train_bf16",),
    "nn_stripe": ("slice", "dense", "slice_bf16", "train", "train_bf16"),
    "nn_argmin": ("slice", "dense", "slice_bf16", "train", "train_bf16"),
    "resize_bwd": ("train", "train_bf16"),
    "bilinear_points_bwd": ("train", "train_bf16"),
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


# The tensor-core kernels, by a fragment of their SASS names: K2's float32
# and bfloat16 convs, K3's float32 and bfloat16 dk, and the bfloat16 probes:
# P3, P1 (P2's full), P2's dot-only, row2 and tap-dots, P4. P2's asm-only
# (probe_nhcw_asm_bf16) builds the stack and contracts nothing: exempt.
TENSOR_CORE_KERNELS = ("conv3x3_tf32x3_kernel", "conv3x3_mma_bf16", "conv3x3_dk_mma_tf32x3",
                       "conv3x3_dk_mma_bf16", "probe_halo_mma_bf16", "probe_nhcw_mma_bf16",
                       "probe_nhcw_dot_bf16", "probe_nhcw_row2_bf16", "probe_tapdots_mma_bf16",
                       "probe_flat_mma_bf16")


def check_hmma(lib) -> None:
    """Count the HMMA (tensor-core mma) instructions in the SASS of each
    instantiation of the tensor-core kernels; fail if one has none."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts = {kernel: {} for kernel in TENSOR_CORE_KERNELS}
    for section in sass.split("Function : ")[1:]:
        name = section.split(None, 1)[0]
        for kernel in TENSOR_CORE_KERNELS:
            if kernel in name:
                counts[kernel][name] = section.count("HMMA")
    for kernel, found in counts.items():
        for name, n in found.items():
            log("build", f"{n} HMMA instructions in {name}")
        if not found or not all(found.values()):
            raise AssertionError(f"the SASS of {kernel} lacks HMMA instructions: {found}")


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


def check_backward(x, dy, w, label: str, dk_vs_plain: bool = True) -> tuple[float, float]:
    """dx (K2) and dk (K3) vs their plain versions on one set of tensors, dk
    also bitwise across two runs and against a float64 sum; raises beyond
    the limits and returns (max |Δdx|, max |Δdk|). ``dk_vs_plain=False``
    logs dk against the plain version beside the plain version's own error
    and leaves the decision to the float64 limit (see the caller)."""
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
    # by up to 8.7e-5 (64 -> 64 at 160^2, B = 16, on the H100); K3 stays
    # within 1.2e-6 of it there and everywhere else, hence its own 1e-5,
    # which alone decides where the caller passes dk_vs_plain=False.
    dk64 = torch.nn.grad.conv2d_weight(x.double(), dk.shape, dy.double(), padding=1)
    e64, e64_p = rel_err(dk, dk64), rel_err(dk_p, dk64)
    bf = x.dtype == torch.bfloat16
    log("kernels", f"backward {label} dx rel {e_dx:.3e}, dk rel {e_dk:.3e}"
        f"{'' if dk_vs_plain else ' (no limit)'} (vs float64: "
        f"kernel {e64:.3e}, plain {e64_p:.3e}), dk bitwise stable")
    if (dk_vs_plain and e_dk > 1e-4) or e64 > 1e-5 or e_dx > (2e-2 if bf else 1e-4):
        raise AssertionError(f"conv backward {label}: dx {e_dx}, dk {e_dk}, dk vs "
                             f"float64 {e64}")
    return (dx.float() - dx_p.float()).abs().max().item(), (dk - dk_p).abs().max().item()


def check_bf16_float64(x, dy, w, label: str) -> None:
    """K2's bf16 forward (with a bias) and dx against float64 convs of the
    same bf16 values, elementwise: |y − y64| within 2^-8 |y64| + 1e-5 max
    |y64|, one bf16 rounding of a float32-accurate sum; logs the share of
    the limit used and raises beyond it."""
    b = torch.linspace(-0.1, 0.1, w.shape[0], device=x.device)
    jobs = {"forward": (conv3x3_forward(x, w, b),
                        F.conv2d(x.double(), w.double(), b.double(), padding=1)),
            "dx": (conv3x3_dx(dy, w),
                   torch.nn.grad.conv2d_input(x.shape, w.double(), dy.double(), padding=1))}
    share = {}
    for job, (got, want) in jobs.items():
        limit = 2.0 ** -8 * want.abs() + 1e-5 * want.abs().max()
        share[job] = ((got.double() - want).abs() / limit).max().item()
    log("kernels", f"bf16 {label} vs float64, worst share of 2^-8 |y64| + 1e-5 max|y64|: "
        + ", ".join(f"{job} {v:.3f}" for job, v in share.items()))
    if max(share.values()) > 1.0:
        raise AssertionError(f"bf16 conv {label} beyond its float64 limit: {share}")


def check_conv_backward(device, shapes) -> dict[str, float]:
    """dx (K2) and dk (K3) vs plain at every UNet stage shape, f32 and bf16 at
    B = 4 and at the train step's B = 16 (K3 splits its work by B), and the
    bf16 forward and dx at B = 16 against float64 convs; returns the largest
    absolute differences from the plain versions."""
    g = torch.Generator().manual_seed(1)
    worst = {"dx_abs": 0.0, "dk_abs": 0.0, "dx_abs_bf16": 0.0, "dk_abs_bf16": 0.0}

    def check(x, dy, w, label, dk_vs_plain=True):
        dx_abs, dk_abs = check_backward(x, dy, w, label, dk_vs_plain)
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
    gd = torch.Generator(device=device).manual_seed(2)
    for ci, co, h in sorted(set(shapes)):
        x = torch.randn(TRAIN_BATCH, ci, h, h, generator=gd, device=device)
        dy = torch.randn(TRAIN_BATCH, co, h, h, generator=gd, device=device)
        w = torch.randn(co, ci, 3, 3, generator=gd, device=device) * math.sqrt(
            2.0 / (9 * (ci + co)))
        # dk at B = 16, both types: the plain version (cuDNN's float32
        # wgrad) is up to 8.7e-5 (f32) and 7.5e-5 (bf16) off the float64 sum
        # of these inputs at 64 -> 64, 160^2 (on the H100), most of the 1e-4
        # that kernel vs plain may differ by, while K3 stays within 1.2e-6 of
        # it. Whether kernel vs plain passes then depends on the data, not on
        # K3: the float64 limit (1e-5, ten times tighter) and the bitwise
        # check decide, and kernel vs plain is logged beside the plain
        # version's own error.
        label = f"B={TRAIN_BATCH} Ci={ci:3d} Co={co:3d} {h:3d}^2"
        check(x, dy, w, f"{label} float32 ", dk_vs_plain=False)
        xb, dyb, wb = (t.bfloat16() for t in (x, dy, w))
        check(xb, dyb, wb, f"{label} bfloat16", dk_vs_plain=False)
        check_bf16_float64(xb, dyb, wb, label)
    return worst


def time_convs(device, shapes, dtype) -> dict[str, float]:
    """One train step's forward, dx and dk at B = 16 in ``dtype``, stage by
    stage, as device time replayed from CUDA graphs (``graph_ms``, as the
    graph train step runs them): the kernels beside their plain versions
    (float32 cuDNN, on the widened inputs for bfloat16) and beside cuDNN's
    own calls in ``dtype`` (``F.conv2d``, ``conv2d_input``,
    ``conv2d_weight``; TF32 off), in turns; and each kernel's call launched
    from the host (``cuda_ms``, which also counts the wrapper's host time
    where the card waits for it). ms summed over the step's convs (the first
    conv takes no dx: its input needs no gradient)."""
    first, gd = shapes[0], torch.Generator(device=device).manual_seed(4)
    name = str(dtype)[6:]
    keys = [f"{job}{path}" for job in ("fwd", "dx", "dk")
            for path in ("", "_plain", "_lib", "_host")]
    ms = dict.fromkeys(keys, 0.0)
    for ci, co, h in sorted(set(shapes)):
        n = shapes.count((ci, co, h))
        n_dx = n - int((ci, co, h) == first)
        x = torch.randn(TRAIN_BATCH, ci, h, h, generator=gd, device=device).to(dtype)
        dy = torch.randn(TRAIN_BATCH, co, h, h, generator=gd, device=device).to(dtype)
        w = (torch.randn(co, ci, 3, 3, generator=gd, device=device) * math.sqrt(
            2.0 / (9 * (ci + co)))).to(dtype)
        b = torch.zeros(co, device=device, dtype=dtype)
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
            k, lib_ms = in_turns(lib, kernel, graph_ms)
            row[job] = (k, graph_ms(plain), lib_ms, cuda_ms(kernel))
            for path, t in zip(("", "_plain", "_lib", "_host"), row[job]):
                ms[job + path] += (n_dx if job == "dx" else n) * t
        log("kernels", f"{name} B={TRAIN_BATCH} Ci={ci:3d} Co={co:3d} {h:3d}^2 x{n} (ms "
            f"replayed, kernel / plain / cuDNN {name}; host-launched kernel): " + ", ".join(
                f"{job} {k:.3f} / {p:.3f} / {lb:.3f}; {hk:.3f}"
                for job, (k, p, lb, hk) in row.items()))
    log("kernels", f"one {name} train step's convs at B={TRAIN_BATCH} (ms replayed, kernel / "
        f"plain / cuDNN {name}; host-launched kernel): " + ", ".join(
            f"{job} {ms[job]:.2f} / {ms[job + '_plain']:.2f} / {ms[job + '_lib']:.2f}; "
            f"{ms[job + '_host']:.2f}" for job in ("fwd", "dx", "dk")))
    return ms


def nn_inputs(batch):
    """Scan points under the initial guess and the map, as the ICP sees them."""
    scan = batch["loc_data"]["filtered_pc"][..., :3]
    p = transform_points(batch["transforms"]["T_ml_init"], scan).contiguous()
    return p, batch["map_data"]["pc"]


def stripe_inputs(batch):
    """The smoke's stripe call on ``batch``: the map sorted and the scan rows
    grouped by key, the dispatcher's default window and block size, each
    tile's blocks within the budget, and every third item frozen (nblk 0), as
    the per-item tolerance freeze makes them: (p, q3, q4, start, nblk, tm)."""
    p, q = nn_inputs(batch)
    q_s, key_s, use_x = nn_assoc.stripe_sort_target(q)
    order = torch.argsort(torch.where(use_x[:, None], p[..., 0], p[..., 1]), dim=1,
                          stable=True)
    p = torch.gather(p, 1, order[..., None].expand(-1, -1, 3)).contiguous()
    M = q.shape[1]
    window = M // 4  # the dispatcher's default window, and its block size:
    tm = next(t for t in (1024, 512, 256, 128) if M % t == 0 and window % t == 0)
    start, nblk = nn_assoc.stripe_blocks(p, key_s, use_x, TRIM, TILE, tm)
    nblk = nblk.clamp(max=window // tm + 1)
    nblk[1::3] = 0
    return p, q_s[..., :3], nn_assoc.map_layout(q_s), start, nblk, tm


def tie_heavy(device, B, N, M, seed):
    """Scan and map points on a coarse grid (many equal distances), exact
    duplicate map points, map pad rows at 1000, and rows 3 and 4 with no
    finite distance (a NaN scan point; one whose every d2 overflows)."""
    g = torch.Generator().manual_seed(seed)
    p = torch.randint(-12, 12, (B, N, 3), generator=g).float() * 0.5
    q = torch.randint(-12, 12, (B, M, 3), generator=g).float() * 0.5
    q[:, M // 2:M // 2 + 40] = q[:, 7:47]
    q[:, -9:] = 1000.0
    p[:, 3] = float("nan")
    p[:, 4] = torch.tensor([1e30, 0.0, 0.0])
    return p.to(device), q.to(device)


def hold_nn(label: str, run, live=None, no_finite=()) -> float:
    """``run()`` (an NN wrapper's call) on the kernel, again, and on the plain
    version: idx equal and d2 bit for bit on the ``live`` rows (every row
    where None), the rows ``no_finite`` at idx 0 and d2 inf, and the two
    kernel runs bit for bit; raises otherwise and returns max |Δd2| over the
    finite rows (0 where the bits agree)."""
    idx, d2 = run()
    idx2, d22 = run()
    with kernels.plain_versions():
        idx_p, d2_p = run()
    if live is None:
        live = torch.ones_like(idx, dtype=torch.bool)

    def same(a, b):
        return torch.equal(a[live].view(torch.int32), b[live].view(torch.int32))

    ok = same(idx, idx_p) and same(d2, d2_p)
    stable = same(idx, idx2) and same(d2, d22)
    none = all(bool((idx[:, r] == 0).all() and torch.isinf(d2[:, r]).all()) for r in no_finite)
    diff = torch.where(d2 == d2_p, 0.0, (d2 - d2_p).abs())[live]
    err = diff[torch.isfinite(diff)].max().item() if diff.numel() else 0.0
    log("kernels", f"{label}: idx and d2 bits equal to plain {ok}, two runs bitwise "
        f"{stable}" + (f", rows {list(no_finite)} idx 0 / d2 inf {none}" if no_finite else ""))
    if not (ok and stable and none):
        raise AssertionError(f"{label}: kernel differs from plain, between runs, or on the "
                             f"rows with no finite distance")
    return err


def check_nn(batch) -> dict[str, float]:
    """K1 (dense) and K4 (stripe) against their plain versions, each on the
    smoke's inputs at B = 32, on tie-heavy inputs with rows that find no
    finite distance, bitwise across two runs (``hold_nn``); K4's tie-heavy
    case at B = 32, N = 4096, M = 16384 with tiles of 0 to 16 map blocks
    (one scanning the whole map, runs past its end). Returns the largest
    |Δd2| of each."""
    device = batch["map_data"]["pc"].device
    p, q = nn_inputs(batch)
    q3 = q[..., :3]
    err = {"nn_argmin": hold_nn(f"nn_argmin {tuple(p.shape[:2]) + (q.shape[1],)}",
                                lambda: nn_assoc.nn_argmin(p, q3))}
    pt, qt = tie_heavy(device, 3, 1000, 3001, seed=5)
    err["nn_argmin"] = max(err["nn_argmin"], hold_nn(
        "nn_argmin tie-heavy (3, 1000, 3001)", lambda: nn_assoc.nn_argmin(pt, qt),
        no_finite=(3, 4)))
    ps, qs3, qs4, start, nblk, tm = stripe_inputs(batch)
    live = (nblk > 0).repeat_interleave(TILE, dim=1)
    err["nn_stripe"] = hold_nn(
        f"nn_stripe {tuple(ps.shape[:2]) + (qs3.shape[1],)} tm={tm}, nblk histogram "
        f"{torch.bincount(nblk.flatten().long()).tolist()}",
        lambda: nn_assoc.nn_stripe(ps, qs3, start, nblk, tm, qs4), live)
    B, N, M = ps.shape[0], ps.shape[1], qs3.shape[1]
    pt, qt = tie_heavy(device, B, N, M, seed=6)
    g = torch.Generator(device=device).manual_seed(7)
    start_t = torch.randint(0, M // tm, (B, N // TILE), generator=g, device=device,
                            dtype=torch.int32)
    nblk_t = torch.randint(0, M // tm + 1, (B, N // TILE), generator=g, device=device,
                           dtype=torch.int32)
    start_t[:, 0], nblk_t[:, 0] = 3, 2  # rows 3 and 4: a live tile from block 3
    start_t[:, 1], nblk_t[:, 1] = 0, M // tm
    live = (nblk_t > 0).repeat_interleave(TILE, dim=1)
    err["nn_stripe"] = max(err["nn_stripe"], hold_nn(
        f"nn_stripe tie-heavy {(B, N, M)}, nblk 0-{M // tm}",
        lambda: nn_assoc.nn_stripe(pt, qt, start_t, nblk_t, tm), live, no_finite=(3, 4)))
    return err


# One float32 instruction a lane a clock: 132 SMs x 128 lanes at the H100
# SXM's 1.98 GHz boost clock. The NN kernels' issue floor takes 8 such
# instructions a (scan, map) pair, the exact form's, which may not fuse.
ISSUE_PER_S = 132 * 128 * 1.98e9
NN_CALLS = 10  # calls in the CUDA graph that times an NN kernel


def time_nn(label: str, kernel, plain, pairs: int, nbytes: int) -> dict:
    """One NN call: the kernel replayed from a CUDA graph of NN_CALLS calls
    (``graph_ms``, divided), launched from the host (``cuda_ms``), and the
    plain version launched from the host (its stripe reads nblk's maximum on
    the host and cannot be captured), in turns; its bound (8 operations a
    pair at the float32 peak, the rows' bound from the start) and issue
    floor. Logs and returns the row's numbers."""
    def replayed():
        return graph_ms(lambda: [kernel() for _ in range(NN_CALLS)]) / NN_CALLS

    g1, h1, p1 = replayed(), cuda_ms(kernel), cuda_ms(plain, reps=3)
    p2, h2, g2 = cuda_ms(plain, reps=3), cuda_ms(kernel), replayed()
    row = {"ms": (g1 + g2) / 2, "host_ms": (h1 + h2) / 2, "plain_ms": (p1 + p2) / 2}
    row["bound_ms"], row["bound_by"] = bound_ms(8 * pairs, nbytes, torch.float32)
    floor = 8 * pairs / ISSUE_PER_S * 1e3
    log("kernels", f"{label}: {pairs} pairs; kernel {row['ms']:.4f} ms replayed "
        f"[{row['host_ms']:.4f} host-launched], plain {row['plain_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), issue floor {floor:.4f} ms")
    return row


def time_nn_rows(batch) -> dict[str, dict]:
    """The K1 and K4 rows' times on the smoke's inputs: dense at B = 32,
    N = 4096, M = 16384 and the stripe call of ``stripe_inputs``. Uses only
    the wrappers' public names, so ``--time-nn`` times another tree's
    kernels the same way."""
    p, q = nn_inputs(batch)
    q3, q4 = q[..., :3], nn_assoc.map_layout(q)
    B, N, M = p.shape[0], p.shape[1], q.shape[1]
    io = B * (12 * N + 12 * M + 8 * N)  # p and q in, idx and d2 out

    def plain_dense():
        with kernels.plain_versions():
            nn_assoc.nn_argmin(p, q3)

    rows = {"nn_argmin": time_nn(f"nn_argmin B={B} N={N} M={M}",
                                 lambda: nn_assoc.nn_argmin(p, q3, q4), plain_dense,
                                 B * N * M, io)}
    ps, qs3, qs4, start, nblk, tm = stripe_inputs(batch)

    def plain_stripe():
        with kernels.plain_versions():
            nn_assoc.nn_stripe(ps, qs3, start, nblk, tm)

    # The pairs this launch's nblk asks for: each live tile of TILE rows
    # against nblk blocks of tm map points.
    rows["nn_stripe"] = time_nn(
        f"nn_stripe B={B} nblk histogram {torch.bincount(nblk.flatten().long()).tolist()}",
        lambda: nn_assoc.nn_stripe(ps, qs3, start, nblk, tm, qs4), plain_stripe,
        int(nblk.long().sum()) * tm * TILE, io + 2 * nblk.numel() * 4)
    return rows


def first_stripe_call(trainer: Trainer, params: dict, batch) -> None:
    """The eval step's own first stripe association, run eagerly: logs its
    nblk histogram, pairs, bound and issue floor, and K4's time on its
    inputs replayed from a CUDA graph, the number to set beside K4's share
    of the step's device time (50 such calls, later ones with frozen items)."""
    calls, orig = [], nn_assoc.nn_stripe

    def record(p, q, start_blk, nblk, tm, q4=None):
        if not calls:
            calls.append((p.clone(), q, start_blk.clone(), nblk.clone(), tm, q4))
        return orig(p, q, start_blk, nblk, tm, q4)

    # The wrapper counts its launch under its module name, which is record's
    # while it stands in (this run is not a counted one).
    record.launches = 0
    nn_assoc.nn_stripe = record
    try:
        with kernels.eager():
            trainer.eval_step(params, batch)
    finally:
        nn_assoc.nn_stripe = orig
    p, q, start, nblk, tm, q4 = calls[0]
    B, N, M = p.shape[0], p.shape[1], q.shape[1]
    rows = N // nblk.shape[1]
    pairs = int(nblk.long().sum()) * tm * rows
    bound, by = bound_ms(8 * pairs, B * (12 * N + 12 * M + 8 * N) + 2 * nblk.numel() * 4,
                         torch.float32)
    ms = graph_ms(lambda: [orig(p, q, start, nblk, tm, q4) for _ in range(NN_CALLS)])
    log("slice", f"the eval step's first stripe association: nblk histogram "
        f"{torch.bincount(nblk.flatten().long()).tolist()} (tm={tm}, {rows} rows a tile), "
        f"{pairs} pairs; K4 {ms / NN_CALLS:.4f} ms replayed, bound {bound:.4f} ms ({by}), "
        f"issue floor {8 * pairs / ISSUE_PER_S * 1e3:.4f} ms")


def record_backward_calls(trainer: Trainer, batch) -> dict[str, list[tuple]]:
    """The inputs of every call of the two gather-form backwards in one eager
    kernel-path train step from a fresh state: {"resize_bwd": [(dy, i0, w0,
    w1, n_in, axis), ...] (each upsample's two axes), "bilinear_points_bwd":
    [(dout, image, coords, align_corners)]}, as copies. Not a counted run."""
    calls = {"resize_bwd": [], "bilinear_points_bwd": []}
    origs = {name: getattr(resample, name) for name in calls}

    def spy(name):
        def record(*args):
            calls[name].append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args))
            return origs[name](*args)

        # The wrapper counts its launch under its module name, which is the
        # spy's while it stands in.
        record.launches = 0
        return record

    for name in calls:
        setattr(resample, name, spy(name))
    try:
        with kernels.eager():
            trainer.train_step(trainer.init_state(seed=0), batch)
    finally:
        for name, fn in origs.items():
            setattr(resample, name, fn)
    return calls


def check_backward_kernels(calls, label: str) -> dict[str, float]:
    """Each recorded call of the two gather-form backwards on its kernel,
    again, and on its plain version: the two kernel runs bit for bit, and
    kernel vs plain within 1e-6 of max |g| in float32 (the same float32
    products summed in another order: the plain versions add with atomics)
    or 2e-2 in bfloat16 (the plain versions round each product and partial
    sum to 8 bits); a bfloat16 upsample backward also elementwise against
    its plain version in float64 within 2^-8 |g64| + 1e-5 max |g64| (one
    rounding of a float32 sum); the lookup's backward also bit for bit its
    ordered reference (``bilinear_points_bwd_ordered``: each pixel's taps
    in ascending point order). Returns the largest |kernel − plain| of each
    kernel."""
    err = {}
    for name, recs in calls.items():
        fn, err[name] = getattr(resample, name), 0.0
        for args in recs:
            got, again = fn(*args), fn(*args)
            with kernels.plain_versions():
                want = fn(*args)
            rel, same = rel_err(got, want), torch.equal(got, again)
            bf16 = got.dtype == torch.bfloat16
            tol, share = 2e-2 if bf16 else 1e-6, 0.0
            if bf16 and name == "resize_bwd":
                with kernels.plain_versions():
                    ref = fn(*(a.double() if torch.is_tensor(a) and a.is_floating_point() else a
                               for a in args))
                share = ((got.double() - ref).abs()
                         / (2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max())).max().item()
            ordered = True
            if name == "bilinear_points_bwd":
                ordered = torch.equal(got, resample.bilinear_points_bwd_ordered(*args))
            log("kernels", f"{name} {label} {tuple(args[0].shape)} -> {tuple(got.shape)} "
                f"{str(got.dtype)[6:]}: max|d|/max|g| {rel:.3e} (limit {tol:g}) from the plain "
                f"version, two runs bitwise {same}"
                + (f", worst share of the float64 limit {share:.3f}" if share else "")
                + (f", bitwise the ordered reference {ordered}"
                   if name == "bilinear_points_bwd" else ""))
            if not same or not ordered or not rel <= tol or share > 1.0:
                raise AssertionError(f"{name} {label} {tuple(args[0].shape)}: {rel} from the "
                                     f"plain version, float64 share {share}, two runs bitwise "
                                     f"{same}, bitwise the ordered reference {ordered}")
            err[name] = max(err[name], (got.float() - want.float()).abs().max().item())
    return err


def backward_jobs(name: str, args):
    """(kernel, plain version, library call, operations, bytes) of one
    recorded call. The library call: the two ``index_add_`` calls of an
    axis, on the products its plain version forms first (the index_add path
    the train step took before the kernel); ``grid_sampler_2d_backward``,
    the op of ``F.grid_sample``'s autograd. Bytes: each input read once, the
    output written once; operations: 2 for each (source, destination) pair."""
    fn = getattr(resample, name)

    def plain():
        with kernels.plain_versions():
            return fn(*args)

    if name == "resize_bwd":
        dy, i0, w0, w1, n_in, axis = args
        shape = [1] * dy.ndim
        shape[axis] = -1
        p0, p1 = dy * w0.reshape(shape), dy * w1.reshape(shape)
        size = list(dy.shape)
        size[axis] = n_in

        def library():
            return dy.new_zeros(size).index_add_(axis, i0, p0).index_add_(axis, i0 + 1, p1)

        out = dy.numel() // dy.shape[axis] * n_in
        return (lambda: fn(*args), plain, library, 4 * dy.numel(),
                (dy.numel() + out) * dy.element_size())
    dout, image, coords, align = args

    def library():
        return torch.ops.aten.grid_sampler_2d_backward(
            dout[:, None, :, None], image[:, None], coords[:, :, None, :], 0, 0, align,
            [True, False])

    return (lambda: fn(*args), plain, library, 8 * dout.numel(),
            (dout.numel() + coords.numel() + image.numel()) * image.element_size())


def time_backward_kernels(calls, label: str) -> dict[str, dict]:
    """The two gather-form backwards over one train step's calls, summed:
    the kernel and the library call replayed from CUDA graphs in turns
    (``graph_ms``), the plain version replayed, the kernel launched from the
    host (``cuda_ms``), and the bound (``timing.bound_ms`` at the float32
    peak: the sums are float32). Returns {kernel: row}."""
    rows = {}
    for name, recs in calls.items():
        row = dict.fromkeys(("ms", "plain_ms", "library_ms", "host_ms", "bound_ms"), 0.0)
        by = {"bytes": 0.0, "operations": 0.0}
        for args in recs:
            kernel, plain, library, ops, nbytes = backward_jobs(name, args)
            k, lib = in_turns(library, kernel, graph_ms)
            bound, which = bound_ms(ops, nbytes, torch.float32)
            by[which] += bound
            log("kernels", f"{name} {label} {tuple(args[0].shape)}: kernel {k:.4f} ms "
                f"replayed, library {lib:.4f}, bound {bound:.4f} ({which})")
            for key, t in (("ms", k), ("library_ms", lib), ("plain_ms", graph_ms(plain)),
                           ("host_ms", cuda_ms(kernel)), ("bound_ms", bound)):
                row[key] += t
        row["bound_by"] = max(by, key=by.get)
        lib_name = "index_add_" if name == "resize_bwd" else "grid_sampler_2d_backward"
        log("kernels", f"{name} {label}, one train step's {len(recs)} calls (ms): kernel "
            f"{row['ms']:.4f} replayed [{row['host_ms']:.4f} host-launched], plain "
            f"{row['plain_ms']:.4f}, {lib_name} {row['library_ms']:.4f}, bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']})")
        rows[name] = row
    return rows


def run_backward_kernels(device, cfg: Config) -> tuple[dict, dict]:
    """The gather-form backwards at the train step's own inputs (B = 16,
    640^2, 4096 points), recorded from an eager step of the default Config()
    and of its bfloat16 variant: each call held against its plain version
    and bitwise across two runs, then timed. Returns (the float32 step's
    rows, the largest |kernel − plain| of each kernel over both types)."""
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    rows, err = {}, {}
    for dtype in ("float32", "bfloat16"):
        trainer = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dtype=dtype)), device)
        calls = record_backward_calls(trainer, batch)
        for name, e in check_backward_kernels(calls, dtype).items():
            err[name] = max(err.get(name, 0.0), e)
        timed = time_backward_kernels(calls, dtype)
        if dtype == "float32":
            rows = timed
    return rows, err


def kernel_spans(fn, calls: int = 20) -> tuple[float, dict[str, float]]:
    """One replay, under ``torch.profiler``, of a CUDA graph of ``calls``
    calls of fn: the card's span a call and each kernel's mean duration,
    in µs, by the kernel's short name."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = name.split("(")[0].split("<")[0].split("::")[-1].strip()
            by.setdefault(name, []).append(e.time_range.end - e.time_range.start)
    span = (max(r.end for r in spans) - min(r.start for r in spans)) / calls
    return span, {k: statistics.mean(v) for k, v in by.items()}


def time_lookup(device, cfg: Config) -> None:
    """``--time-lookup``: the point lookup's backward over one eager train
    step's call of the default Config() and of its bfloat16 variant, timed
    as the kernels phase times it, through the wrappers' public names only
    (another tree's kernels timed the same way); then, in float32, the
    card's span a call and each kernel's duration for it and for
    ``grid_sampler_2d_backward`` (``kernel_spans``): where its time goes."""
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    for dtype in ("float32", "bfloat16"):
        trainer = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, dtype=dtype)), device)
        calls = record_backward_calls(trainer, batch)
        time_backward_kernels({"bilinear_points_bwd": calls["bilinear_points_bwd"]}, dtype)
        if dtype == "float32":
            kernel, _, library, _, _ = backward_jobs("bilinear_points_bwd",
                                                     calls["bilinear_points_bwd"][0])
            for label, fn in (("kernel", kernel), ("grid_sampler_2d_backward", library)):
                span, by = kernel_spans(fn)
                log("kernels", f"bilinear_points_bwd float32, {label}, a graph of 20 calls: "
                    f"{span:.2f} us of the card a call; " + ", ".join(
                        f"{k} {t:.2f} us" for k, t in by.items()))


def most(t: torch.Tensor) -> float:
    """The largest element, NaN for an empty tensor."""
    return t.max().item() if t.numel() else float("nan")


def yaw_deg(R: torch.Tensor) -> torch.Tensor:
    return torch.rad2deg(torch.atan2(R[..., 1, 0], R[..., 0, 0]))


def run_slice(trainer: Trainer, params: dict, batch, label: str = "slice") -> tuple[dict, dict]:
    """``Trainer.eval_step`` checked against the eager kernel path and the
    plain path; returns the counters of the main path's step and the
    solve's iterations and stop-test reads. In bfloat16 the mask is held
    within 5e-2 of the plain path's (each conv output is rounded to 8 bits
    on both paths, and a sum in another order can flip that rounding, as in
    ``tests/test_torch_gpu.py::test_bf16_eval_step_matches_plain``) and the
    poses, which follow the mask, are logged."""
    cfg = trainer.cfg
    bf16 = cfg.model.dtype == "bfloat16"
    trainer.eval_step(params, batch)  # warm-up: captures the solve's graph; allocator
    torch.cuda.synchronize()

    # The main path, through the user's entry point, with counters from 0.
    kernels.reset_launch_counts()
    err, stats, mask = trainer.eval_step(params, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(label, f"launches {counts}")
    log(label, f"err (norm, rot, trans) {err.tolist()} mean_num_non0 "
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
    log(label, f"ICP iterations {iters} (eager {int(eager.icp_info['iterations'])}, plain "
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
    log(label, f"graph vs eager kernel path: every item max |dt|={dt_e:.3e} m, max "
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
    log(label, f"kernel vs plain: mask max|d|={mask_d:.3e}; {int(conv.sum())}/{len(conv)} "
        f"items converged on both paths: max |dt|={most(dt[conv]):.3e} m, "
        f"max |dyaw|={most(dyaw[conv]):.3e} deg")
    if (~conv).any():
        log(label, f"not converged: items {torch.nonzero(~conv).flatten().tolist()}, "
            f"|dt| {dt[~conv].tolist()} m, |dyaw| {dyaw[~conv].tolist()} deg")
    if bf16:
        if mask_d > 5e-2:
            raise AssertionError(f"bf16 kernel and plain masks differ by {mask_d} > 5e-2")
    elif not conv.any() or most(dt[conv]) > 1e-3 or most(dyaw[conv]) > 5e-3:
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


def time_eval(trainer: Trainer, params: dict, batch,
              label: str = "slice") -> dict[str, list[float]]:
    """Host-clock ms of ``Trainer.eval_step`` on the three paths, 3 steps a
    turn (the graph path's graphs are captured already)."""
    times = three_paths(lambda path: host_ms(lambda: trainer.eval_step(params, batch)))
    log(label, f"eval_step B={len(batch['transforms']['T_ml_init'])} "
        f"{trainer.cfg.model.cart_pixel_width}^2 N={batch['loc_data']['raw_pc'].shape[1]} "
        f"M={batch['map_data']['pc'].shape[1]} {trainer.cfg.model.dtype}, host clock: "
        + "; ".join(
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
    # pre-activation is within rounding of 0; the plain path's upsample and
    # lookup backwards sum with atomics. Each kernel alone agrees to <= 1e-4.
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


def snapshot(state):
    """Copies of what a train step updates: the optimizer's tensors
    (parameters, moments, counters) and the dropout generator's state."""
    return [t.detach().clone() for t in state.opt.tensors()], state.generator.get_state()


def captured_steps(trainer: Trainer, batch, label: str):
    """Capture the train step for a fresh state, then run 3 steps (replays)
    with the counters from 0: (state, its parameters before the first step,
    the steps, a snapshot of the state before each step and after the last,
    the counters)."""
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
    steps, snaps = [], [snapshot(state)]
    for _ in range(TRAIN_STEPS):
        steps.append(trainer.train_step(state, batch))
        snaps.append(snapshot(state))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(label, f"launches over {TRAIN_STEPS} steps {counts}")
    cfg = trainer.cfg
    n_conv = len(conv3x3_shapes(cfg.model.enc_channels, cfg.model.cart_pixel_width))
    n_up = len(upsample_shapes(cfg.model.enc_channels, cfg.model.cart_pixel_width))
    want = {"conv3x3": n_conv, "conv3x3_dx": n_conv - 1, "conv3x3_dk": n_conv,
            "resize_bwd": 2 * n_up, "bilinear_points_bwd": 1}
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
    return state, p0, steps, snaps, counts


def check_replays(trainer: Trainer, batch, steps, snaps) -> tuple[float, float, float]:
    """Each replay of ``steps`` against an eager kernel-path step from the
    state that replay started from (``snaps``, from ``captured_steps``);
    raises beyond the limits and returns the largest (loss, grad_norm,
    parameter) differences. The state is the parameters, moments, counters
    and dropout generator: a replay launches the same kernels on the same
    data as the eager step, and ends in the same state. Each eager step
    starts from the graph's state, so that a difference shows at the step
    that makes it (the determinism phase holds chains of steps)."""
    eager_state = trainer.init_state(seed=0)
    n_params = len(eager_state.opt.params)
    scale = max(t.abs().max().item() for t in snaps[0][0][:n_params])
    d_loss_e = d_gnorm_e = d_param_e = 0.0
    per_step, where = [], ""
    with kernels.eager():
        for (before, gen), (after, gen_after), (_, loss, _, gnorm) in zip(snaps, snaps[1:],
                                                                           steps):
            with torch.no_grad():
                for a, b in zip(eager_state.opt.tensors(), before):
                    a.copy_(b)
            eager_state.generator.set_state(gen)
            _, loss_e, _, gnorm_e = trainer.train_step(eager_state, batch)
            dl = abs(loss.item() - loss_e.item()) / abs(loss_e.item())
            dg = abs(gnorm.item() - gnorm_e.item()) / gnorm_e.item()
            d_p = [(a - b).abs().max().item() / scale
                   for a, b in zip(eager_state.opt.tensors()[:n_params], after)]
            worst = max(range(n_params), key=d_p.__getitem__)
            if d_p[worst] >= d_param_e:
                where = f"{trainer._trained[worst]} after step {len(per_step) + 1}"
            d_loss_e, d_gnorm_e, d_param_e = (max(d_loss_e, dl), max(d_gnorm_e, dg),
                                              max(d_param_e, d_p[worst]))
            per_step.append(f"{dg:.3e}")
            counters = eager_state.opt.tensors()[-2:]
            if not (all(torch.equal(a, b) for a, b in zip(counters, after[-2:]))
                    and torch.equal(eager_state.generator.get_state(), gen_after)):
                raise AssertionError("a replay and the eager step from its state end with "
                                     "other optimizer counters or dropout generator states")
    log("train", f"graph vs eager kernel path, each replay against an eager step from its "
        f"state: loss rel {d_loss_e:.3e}, grad_norm rel {d_gnorm_e:.3e} (per step "
        f"{per_step}) over {TRAIN_STEPS} steps; parameters max|d| / max|p| {d_param_e:.3e} "
        f"in {where}; optimizer counters and dropout generator equal")
    if d_loss_e > 1e-6 or d_gnorm_e > 1e-6 or d_param_e > 1e-5:
        raise AssertionError("graph and eager train steps differ beyond loss / grad_norm 1e-6 "
                             "relative, parameters 1e-5 of max |p|")
    return d_loss_e, d_gnorm_e, d_param_e


def run_train(device, cfg: Config) -> tuple[dict, dict]:
    """``Trainer.train_step`` at full width, B = 16, replayed from its CUDA
    graph; returns (the counters of the main path's 3 steps, measured
    numbers)."""
    trainer = Trainer(cfg, device)
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    state, p0, steps, snaps, counts = captured_steps(trainer, batch, "train")
    losses = [s[1].item() for s in steps]
    gnorms = [s[3].item() for s in steps]

    d_loss_e, d_gnorm_e, d_param_e = check_replays(trainer, batch, steps, snaps)

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
    # plain path's upsample and lookup backwards sum with atomics; runs on the
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


def train_chain(trainer: Trainer, batch, state, steps: int = TRAIN_STEPS) -> list:
    """``steps`` train steps from ``state``: every tensor a step updates
    (parameters, Adam moments, counters), each step's loss and grad_norm,
    and the dropout generator's state, as copies."""
    out = []
    for _ in range(steps):
        _, loss, _, gnorm = trainer.train_step(state, batch)
        out += [loss, gnorm]
    torch.cuda.synchronize()
    return [t.detach().clone() for t in state.opt.tensors()] + out + [
        state.generator.get_state()]


def bitwise(a: list, b: list) -> list[int]:
    """The positions where two ``train_chain`` records differ in any bit."""
    return [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]


def run_determinism(device, cfg: Config) -> None:
    """Phase 6: the train step at full width (B = 16), float32 and
    bfloat16, is bitwise repeatable on the card. Two chains of 3 steps from
    one seed must end in the same bits (parameters, Adam moments and
    counters, every loss and grad_norm, the dropout generator), on the graph
    path and on the eager kernel path; a state saved after one step and
    restored into a fresh state must give the next step of the uninterrupted
    run, bit for bit. Whether the graph and eager chains agree bit for bit
    is logged, without a limit. Raises on any difference."""
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            trainer = Trainer(dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, dtype=dtype),
                train=dataclasses.replace(cfg.train, checkpoint_dir=tmp)), device)
            chains = {}
            for path in ("graph", "eager"):
                with PATHS[path]():
                    a, b = (train_chain(trainer, batch, trainer.init_state(seed=0))
                            for _ in range(2))
                diff = bitwise(a, b)
                results[f"{dtype} {path}"] = not diff
                log("determinism", f"{dtype} {path}: two chains of {TRAIN_STEPS} steps from "
                    f"one seed bitwise equal {not diff} ({len(a)} tensors compared"
                    + (f"; differ at {diff}" if diff else "") + ")")
                chains[path] = a
            log("determinism", f"{dtype} graph chain vs eager chain (no limit): bitwise equal "
                f"{not bitwise(chains['graph'], chains['eager'])}")
            state = trainer.init_state(seed=0)
            trainer.train_step(state, batch)
            trainer.save(state, "determinism")
            want = train_chain(trainer, batch, state, steps=1)
            resumed = trainer.restore(trainer.init_state(seed=1), "determinism")
            diff = bitwise(train_chain(trainer, batch, resumed, steps=1), want)
            results[f"{dtype} resume"] = not diff
            log("determinism", f"{dtype} resume: the step after a checkpoint, restored into a "
                f"fresh state, bitwise equal to the uninterrupted run's {not diff}"
                + (f" (differ at {diff})" if diff else ""))
            del trainer, state, resumed, chains
    failed = [k for k, ok in results.items() if not ok]
    if failed:
        raise AssertionError(f"train steps not bitwise repeatable: {failed}")


def run_probes(device) -> tuple[dict, dict]:
    """Phase 7, the conv-probe path: the checks, then the timing with the
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
    for t in times:
        if t["label"].split()[0] in ("P2", "P4"):
            lib = t["library_ms"]
            vs = ("no library call" if lib is None else
                  f"library {lib:.4f} ms ({t['ms'] / lib:.2f}x its time)")
            log("probes", f"{t['label']}: {t['ms']:.4f} ms, {vs}, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}% of it)")
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
    batch = synthetic_batch(1, BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    if sys.argv[1:] == ["--time-nn"]:
        time_nn_rows(batch)
        return 0
    if sys.argv[1:] == ["--time-lookup"]:
        time_lookup(device, Config())
        return 0
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("build", line.strip())
    check_hmma(info.path)

    cfg = Config()  # full width: enc 8…256 at 640², f32, pt2pt, refresh 0
    shapes = conv3x3_shapes(cfg.model.enc_channels, cfg.model.cart_pixel_width)
    conv_err, conv_err16, conv_ms, conv_plain = check_conv(device, shapes)
    bwd = check_conv_backward(device, shapes)
    f32 = time_convs(device, shapes, torch.float32)
    bf16 = time_convs(device, shapes, torch.bfloat16)
    nn_err = check_nn(batch)
    nn_rows = time_nn_rows(batch)
    bwd_rows, bwd_err = run_backward_kernels(device, cfg)
    trainer = Trainer(cfg, device)
    params = trainer.init_state(seed=0).params
    counts, solve = run_slice(trainer, params, batch)
    first_stripe_call(trainer, params, batch)
    eval_times = time_eval(trainer, params, batch)
    dense_trainer = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, icp_overrides=cfg.model.icp_overrides + ("nn_stripe=false",))), device)
    dense_counts, _ = run_slice(dense_trainer, dense_trainer.init_state(seed=0).params, batch)
    if dense_counts["nn_stripe"] or not dense_counts["nn_argmin"]:
        raise AssertionError(f"nn_stripe=false did not take the dense NN: {dense_counts}")
    bf16_trainer = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype="bfloat16")), device)
    bf16_params = bf16_trainer.init_state(seed=0).params
    bf16_slice_counts, bf16_solve = run_slice(bf16_trainer, bf16_params, batch, "slice_bf16")
    bf16_eval_times = time_eval(bf16_trainer, bf16_params, batch, "slice_bf16")
    del batch, bf16_trainer, bf16_params
    train_counts, train = run_train(device, cfg)
    bf16_counts, train_bf16 = run_train_bf16(device, cfg)
    run_determinism(device, cfg)
    probe_counts, probes = run_probes(device)

    # launches: the sum over the counted main-path runs of ROW_PHASES.
    # Errors: max |kernel − plain| over every stage, at B = 4 for the
    # forward and at B = 4 and 16 for dx and dk (both types). conv3x3
    # (forward and dx): one train step's forward + dx at B = 16 (the eval
    # step's forward at B = 32 is logged above); conv3x3_dk: one train
    # step's dk at B = 16. The conv rows' times are replayed from CUDA
    # graphs (graph_ms; their host-launched sums are logged above), and the
    # library call is cuDNN's own in the input type (F.conv2d,
    # conv2d_input, conv2d_weight); the bfloat16 plain versions widen to
    # float32. The NN rows are replayed from CUDA graphs too (their
    # host-launched times are logged above), their plain versions launched
    # from the host. No single PyTorch call computes an NN argmin.
    works, works16 = conv_works(shapes, TRAIN_BATCH), conv_works(shapes, TRAIN_BATCH,
                                                                 torch.bfloat16)
    measured = {
        "conv3x3": {"max_abs_err": max(conv_err, bwd["dx_abs"]), "ms": f32["fwd"] + f32["dx"],
                    "plain_ms": f32["fwd_plain"] + f32["dx_plain"],
                    "library_ms": f32["fwd_lib"] + f32["dx_lib"]},
        "conv3x3_dk": {"max_abs_err": bwd["dk_abs"], "ms": f32["dk"], "plain_ms": f32["dk_plain"],
                       "library_ms": f32["dk_lib"]},
        "conv3x3_bf16": {"max_abs_err": max(conv_err16, bwd["dx_abs_bf16"]),
                         "ms": bf16["fwd"] + bf16["dx"],
                         "plain_ms": bf16["fwd_plain"] + bf16["dx_plain"],
                         "library_ms": bf16["fwd_lib"] + bf16["dx_lib"]},
        "conv3x3_dk_bf16": {"max_abs_err": bwd["dk_abs_bf16"], "ms": bf16["dk"],
                            "plain_ms": bf16["dk_plain"], "library_ms": bf16["dk_lib"]},
        **{name: {"max_abs_err": nn_err[name], "library_ms": None, **row}
           for name, row in nn_rows.items()},
        **{name: {"max_abs_err": bwd_err[name], **row} for name, row in bwd_rows.items()},
        **probes,
    }
    for name, bound in (("conv3x3", seq_bound(works["fwd"] + works["dx"])),
                        ("conv3x3_dk", seq_bound(works["dk"])),
                        ("conv3x3_bf16", seq_bound(works16["fwd"] + works16["dx"])),
                        ("conv3x3_dk_bf16", seq_bound(works16["dk"]))):
        measured[name]["bound_ms"], measured[name]["bound_by"] = bound
    phases = {"slice": counts, "dense": dense_counts, "slice_bf16": bf16_slice_counts,
              "train": train_counts, "train_bf16": bf16_counts, "probes": probe_counts}
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
        f"{conv_plain:.2f}); bf16 eval_step " + " / ".join(
            f"{med(t):.1f}" for t in bf16_eval_times.values()) + f" ({bf16_solve['stop_tests']} "
        f"stop-test reads, {bf16_solve['iterations']} iterations); train_step " + " / ".join(
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
