#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's eval and train paths once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 - --time-nn < path/to/chip_smoke.py       # from another tree's root
    python3 - --time-lookup < path/to/chip_smoke.py   # likewise
    python3 chip_smoke.py --time-mask

``--time-nn`` only builds that tree's kernels and times its K1 and K4 on this
script's inputs, as phase 3 does, through the wrappers' public names: a
parent commit's kernels timed the same way as this one's. ``--time-lookup``
does the same for the point lookup's backward (``bilinear_points_bwd``) on
the inputs of one eager train step of each type, as phase 3 times it, and
profiles the float32 call kernel by kernel beside ``grid_sampler_2d_backward``.
``--time-mask`` times the conv backward's ReLU mask and bias gradient
(``relu_bias_bwd``) over one train step's calls of the cartesian bfloat16
and the polar float32 UNet, beside the plain version and the bound.

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
5. refresh the eval step at bench.py's configuration (bfloat16, pt2pt,
           ``nn_refresh_dist = 0.05``, the motion-gated solve) on the slice's
           batch, with the stripe association (K4, items whose gate is
           closed given no blocks) and with the dense one (K1, every item
           searched and the select dropping it): the counters from 0 over
           one step; the solve on the step's own weights against the gated
           solve on the plain path (1 mm / 0.005 deg on items converged in
           both), and logged against the same solve ungated from the batch's
           guesses and from near ones (0.4 m, 0.1 rad), where the gate can
           part from it as the JAX package's does; at most 10 stop-test
           reads; the iterations and the item-iterations that skipped the
           search; the graph-path step time and the NN kernel's device time
           (``torch.profiler``) of the gated and the ungated step.
6. train   ``Trainer.train_step`` at the default ``Config()`` (dropout 0.05,
           10 unrolled ICP iterations, Adam at 1e-4) on a 16-item synthetic
           batch of 4096 / 16384 points: the step captured as a CUDA graph,
           then 3 replays. The counters must show every conv forward, dx,
           dk and mask-and-bias backward (``relu_bias_bwd``), both axes of
           every upsample's backward, one lookup backward and at least 10
           NN launches per step; loss, gradients and
           updated parameters must be finite; each replay must match an
           eager kernel-path step from the state it started from (loss and
           grad_norm within 1e-6 relative, parameters within 1e-5 of max
           |p|, optimizer counters and dropout generator equal); the
           first step's loss and grad_norm must match the plain path's; a
           full-width UNet gradient must match the plain path's; then the
           host-clock step of the graph, eager and plain paths and their
           peak device memory (the graph's pool included). Then the same
           with ``model.dtype="bfloat16"``: 3 replays, finite, timed.
7. determinism  the train step at B = 16 in float32 and in bfloat16:
           two chains of 3 steps from one seed, on the graph path and on the
           eager kernel path, bitwise equal in parameters, Adam moments and
           counters, losses, grad_norms and the dropout generator; a step
           resumed from a checkpoint bitwise equal to the uninterrupted
           run's next step.
8. implicit  ``Trainer.train_step`` with ``icp_diff_mode="implicit"`` at
           the default Config()'s widths, B = 16 (pt2pt and pt2pl in
           float32, pt2pl in bfloat16): the solve to tolerance (50
           iterations, each item frozen on the device, K4) in the forward
           and the implicit-function-theorem weight gradient, whose dense
           association is K1, in the backward, all one CUDA graph. With the
           counters from 0, 3 replays: every conv, K1 exactly once a step;
           each replay against an eager kernel-path step from its state
           (loss and grad_norm 1e-6 relative, parameters 1e-5 of max |p|);
           the first step against the plain path (float32: loss 1e-5,
           grad_norm 1e-3 relative; bfloat16: 2e-2); timed on the three
           paths.
9. data    the training CLI (``train_icp_weights.main``) on a Boreas-layout
           tree written by ``data.testing.write_synthetic_dataset`` to a
           temporary directory at the default Config()'s widths (12 training
           pairs of 3 frames, 32 validation frames, 400 x 3360 polar scans,
           4096 / 16384 points, about 90 MB), with only ``data.data_dir``,
           ``train.num_epochs=1`` and the checkpoint directory set: baseline,
           pre-training validation, two B = 16 steps replayed from the
           captured graph, validation, final validation; every logged number
           finite, the checkpoints written, and the validation artifacts
           (``learned_mask_epre``, ``learned_mask_e0``, ``raw_scan``,
           ``cfar_mask``, ``fft_mask``, ``map_mask``) valid 640 x 640 PNGs
           (signature, IHDR size, data that decompresses). Then one
           collated batch's
           ``preprocess_batch`` on the card against the CPU (u8/255 bit for
           bit; the warp within its float32 conditioning, two ulps of a
           sampling coordinate times the largest step between neighbouring
           polar pixels), baselines 1-3,
           ``evaluate_sequence`` and ``gt_tools.eval_localization_run`` (with
           its error plot, a valid PNG) on the validation batch, their errors
           logged.
10. localize the localization path at full width. (a) 32
           polar 400 x 3360 scans of ``synthetic_batch(seed=3, …, polar)``
           (4096 scan, 16384 map points with normals) through
           ``localize_frame`` in 4 chunks of 8 at the default
           ``LocalizationConfig`` (modified CA-CFAR, pt2pl, 4 + 50
           iterations) with beta 0: with uniform weights, with a seeded
           default-Config() policy's ``mask_for_scan`` (f32), and in
           bfloat16; counters from 0 (K1, K2, K4), each held against the
           plain path (uniform: equal iterations, poses within 1e-6 m /
           1e-5 deg; masked: 1 mm / 0.005 deg on items converged in both,
           or the plain pose a fixed point of the kernel path's solve; the
           bf16 mask within 5e-2; matched ratio and ok equal), the median
           translation error logged against the initial one. (b) the CLI
           on a written tree of two 24-frame sequences of raw 400 x 3360
           scans with Applanix CSVs: ``teach`` (8192 map points),
           ``datagen`` (whose shards the port's ``ICPWeightDataset`` loads)
           and ``localize`` with a seeded checkpoint, GT stats and
           ``--init-chain``; every pose finite; the teach pass on the
           kernels against the plain path (keyframes, 1e-4 m) and bitwise
           across two passes; wall times, frames per second and the
           captured ICP chunk graphs logged.
11. e2e    the product recipe (``mm_masking_tpu_torch.benchmarks.e2e_product``)
           at full width (400 x 3360 polar, 640^2, 4096 / 16384 points, UNet
           8...256, bf16, pt2pl) with one training sequence and 2 epochs, in a
           temporary directory, counters from 0: the summary's 16 keys
           present and finite, no update dropped, every epoch's
           grad_norm_max under 100 (the gate's G3 limit; ROADMAP §3 fault
           4), K1, K2 bf16 (forward and dx), K3 bf16 and K4 launched; the
           wall times of synthesis, datagen, each epoch's train and val pass
           and val_init_baseline logged, and the float32 mask of a fresh bf16
           UNet's distinct values and pixels at each image's max. Then the
           train step on the recipe's first training batch
           (detector-extracted clouds, a map with normals): 3 replays of its
           captured graph, each against an eager step from its state (loss
           and grad_norm 1e-6 relative, parameters 1e-5 of max |p|), and
           the first against the plain path (loss and grad_norm 2e-2
           relative, bf16's rounding).
12. polar  the policy with polar network input and output
           (``network_input_type = network_output_type = "polar"``) at full
           width: the UNet 8...256 on the 400 x 3360 scan (stages 400 x 3360
           ... 25 x 210, pooled to 12 x 105), its mask warped to 640^2 before
           the weight lookup, 4096 / 16384 points, pt2pt, ``loss.mask_pts =
           0`` (ROADMAP §3). K2 and K3, f32 and bf16, against their plain
           versions at every polar stage (forward, dx, dk; the kernels
           phase's limits, B = 4), ``resize_bwd`` at every polar upsample
           (both axes, B = 16), then one step's convs timed beside cuDNN's
           with their bounds. ``Trainer.train_step`` on
           ``synthetic_batch(seed=2, batch=16, polar)``: captured, 3
           replays, each against an eager kernel-path step from its state
           (loss and grad_norm 1e-6 relative, parameters 1e-5 of max |p|),
           the first against the plain path (1e-4 relative; bf16 2e-2), two
           chains of 3 graph steps bitwise equal, timed on the three paths
           with peak memory and the warp's lookup scratch; the counters from 0
           must show every conv, dx, dk, both axes of every upsample and two
           lookup backwards a step (the weights' and the warp's); then the
           same in bfloat16; then ``Trainer.eval_step`` at B = 32 (K4), graph
           against eager (equal iterations, 1e-6 m / 1e-5 deg), timed.
13. ct     the localize phase's tree of 24 raw 400 x 3360 scans, clouds by
           ``extract_pc(..., return_times=True)`` (4096 points): the
           continuous-time teach pass (8192 map points; the joint pose and
           twist solve, K1 in every GN iteration) on the kernels against the
           plain path (keyframes, poses 1e-4 m) and bitwise across two
           passes, the rigid pass (K4) beside it, K1 / K4 launches and ms a
           frame of both; ``pose_at`` at the frames' midpoints;
           ``teach --interp-period-us 50000`` through the CLI.
14. ransac the same clouds: the teach pass with ``use_mcransac`` (K1's
           pre-association, K4's ICP) against the plain path and bitwise
           across two passes, ms a frame; ``descriptor_bootstrap`` (ORB and
           BASD) on 8 pairs of consecutive frames' 640^2 images and their
           4096 keypoints, its pose logged against the rigid teach pass's
           relative pose, the card's matches and pose against the CPU's
           (99% of the matches equal, the pose within 1e-3), ms a call.
15. probes the conv-probe path (``mm_masking_tpu_torch.benchmarks.probe_conv``):
           each probe kernel P1-P4 and each of P2's five variants against
           its plain version at the probes' check shapes (f32) and at
           B = 16, 640^2, 16 -> 16 (f32 and bf16; asm-only bit for bit),
           then, with counters from 0, each timed at the probes' timing
           shapes beside its library call (cuDNN's conv; for asm-only the
           copy it stores; none for dot-only) and K2, each of P2's variants
           and P4's shapes logged with its time, yardstick and bound; every
           probe kernel and variant must have launched.

16. mesh   (after determinism) data parallelism: a NCCL group of one
           process, the train step at B = 16 with its gradient all-reduce
           and batch reductions captured in its CUDA graph, 3 replays bitwise
           equal to the step without a mesh and timed beside it; the eval
           step at B = 32 and ``localize_sequence(mesh=)`` on 8 polar frames
           with the mask, bitwise equal to the calls without a mesh. Then two
           processes on the one card in a gloo group, eager (gloo cannot be
           captured), 8 rows each, 2 steps against one process's eager steps
           (loss 1e-5 relative and parameters within 4 learning rates, the
           CPU tests' limits; grad_norm 1e-3, the gradient's own conditioning
           on the card), K2, K3 and K4 launched on each rank.
           The machine has one card: no run on two cards.
17. bn     (after mesh) ``model.batch_norm=True`` at full width, B = 16, f32
           and bf16: the step captured with its running statistics updated
           in place, 3 replays against eager steps from their states, two
           graph chains bitwise equal (running statistics included), ms and
           peak MiB beside the step without batch norm.
18. deploy (after e2e) the e2e run exported with ``torch.export`` on the
           card (bf16, 400 x 3360 → 640^2, K2 as the custom operator
           ``mm_masking::conv3x3``) and the localizer at N = 4096, M = 16384
           (K1 and K4 as custom operators; 10 refined iterations, the export
           tracing each); both loaded in a fresh process:
           the mask at B = 1 and 8 and the localizer at B = 8 bitwise equal
           to the direct calls, K2 and K1 launched; export seconds and ms a
           frame, artifact against direct.

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
import gc
import json
import math
import os
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.nn.functional as F
from torch.func import functional_call

from mm_masking_tpu_torch.benchmarks import e2e_product, probe_conv
from mm_masking_tpu_torch.benchmarks.timing import (
    HBM_BYTES_PER_S,
    bound_ms,
    cuda_ms,
    graph_ms,
    in_turns,
)
from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.data import (
    ICPWeightDataset,
    SyntheticSpec,
    epoch_batches,
    preprocess_batch,
    synthetic_batch,
)
from mm_masking_tpu_torch.data.boreas import yawPitchRollToRot
from mm_masking_tpu_torch.data.loader import _collate, to_tensors
from mm_masking_tpu_torch.data.testing import write_synthetic_dataset
from mm_masking_tpu_torch.deploy import export_from_run_dir, export_localizer, write_artifact
from mm_masking_tpu_torch.dicp import icp
from mm_masking_tpu_torch.dicp.icp import STOP_TEST_EVERY
from mm_masking_tpu_torch.evaluation import (
    baselines,
    evaluate_sequence,
    frame_errors,
    make_constant_weight_localizer,
    summarize,
)
from mm_masking_tpu_torch.evaluation import gt_tools
from mm_masking_tpu_torch.geom import se3_exp, se3_inv, transform_points
from mm_masking_tpu_torch.localization import __main__ as localization_cli
from mm_masking_tpu_torch.localization import pipeline as localization_pipeline
from mm_masking_tpu_torch.localization.odometry import (
    OdometryConfig,
    TeachPass,
    descriptor_bootstrap,
)
from mm_masking_tpu_torch.localization.pipeline import (
    LocalizationConfig,
    localize_frame,
    project_map,
)
from mm_masking_tpu_torch.models import LearnICPWeightPolicy
from mm_masking_tpu_torch.models.unet import conv3x3_shapes, upsample_shapes
from mm_masking_tpu_torch.ops import (
    POLAR_SHAPE,
    extract_weights,
    kernels,
    radar_polar_to_cartesian,
)
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
from mm_masking_tpu_torch.parallel import make_mesh
from mm_masking_tpu_torch.train import Trainer, train_icp_weights
from mm_masking_tpu_torch.train.checkpoint import load_checkpoint, load_policy_variables

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
# its dense variant and its bfloat16 run, the motion-gated bfloat16 eval
# steps (stripe and dense), the train steps, the bfloat16 train steps, the
# implicit-gradient train steps (pt2pt and pt2pl in float32, bfloat16), the
# training CLI on a written tree (float32), the localize phase (float32;
# its bfloat16 mask run apart), the product recipe (bfloat16 pt2pl), the
# polar train steps (float32, bfloat16) and eval step, the continuous-time
# and MC-RANSAC teach passes and the probe timing (whose bfloat16 K2
# yardstick is the bfloat16 K2 row's).
# Then the mesh phase's train steps over a NCCL group of one and over two
# gloo ranks on the card (float32), the batch-norm train steps (float32,
# bfloat16) and the deploy phase's loaded artifacts (the bfloat16 recipe's
# mask policy, the localizer).
NN_PHASES = ("slice", "dense", "slice_bf16", "refresh", "refresh_dense", "train", "train_bf16",
             "implicit", "implicit_pt2pl", "implicit_bf16", "data", "localize", "localize_bf16",
             "e2e", "polar", "polar_bf16", "polar_eval", "ct", "ransac", "mesh", "mesh_gloo",
             "bn", "bn_bf16", "deploy")
ROW_PHASES = {
    "conv3x3": ("slice", "dense", "train", "implicit", "implicit_pt2pl", "data", "localize",
                "polar", "polar_eval", "mesh", "mesh_gloo", "bn"),
    "conv3x3_dk": ("train", "implicit", "implicit_pt2pl", "data", "polar", "mesh", "mesh_gloo",
                   "bn"),
    "conv3x3_bf16": ("slice_bf16", "refresh", "refresh_dense", "train_bf16", "implicit_bf16",
                     "probes", "localize_bf16", "e2e", "polar_bf16", "bn_bf16", "deploy"),
    "conv3x3_dk_bf16": ("train_bf16", "implicit_bf16", "e2e", "polar_bf16", "bn_bf16"),
    "nn_stripe": NN_PHASES,
    "nn_argmin": NN_PHASES,
    "resize_bwd": ("train", "train_bf16", "implicit", "implicit_pt2pl", "implicit_bf16", "data",
                   "e2e", "polar", "polar_bf16", "mesh", "mesh_gloo", "bn", "bn_bf16"),
    "bilinear_points_bwd": ("train", "train_bf16", "implicit", "implicit_pt2pl",
                            "implicit_bf16", "data", "e2e", "polar", "polar_bf16", "mesh",
                            "mesh_gloo", "bn", "bn_bf16"),
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


def stage(shape: tuple[int, ...]) -> tuple[int, int, int, int]:
    """(Ci, Co, H, W) of a conv stage listed by ``conv3x3_shapes``: (Ci, Co,
    H) for a square image, (Ci, Co, H, W) for the polar scan."""
    return (*shape, shape[2])[:4]


def unet_size(model) -> int | tuple[int, int]:
    """The UNet's input size: the cartesian width, or the polar (A, R)."""
    return model.polar_shape if model.network_input_type == "polar" else model.cart_pixel_width


def conv_works(shapes, batch, dtype=torch.float32) -> dict[str, list]:
    """(operations, bytes, type) of one step's convs at ``batch``: the
    forward (x, weight and bias in, y out), dx (dy and weight in, dx out;
    every conv but the first) and dk (x and dy in, dk out). Activations take
    ``dtype``'s bytes, the weights (and dk) float32's."""
    works = {"fwd": [], "dx": [], "dk": []}
    elem = torch.finfo(dtype).bits // 8
    for i, shape in enumerate(shapes):
        ci, co, h, w = stage(shape)
        ops = 18 * ci * co * batch * h * w
        io = elem * batch * h * w * (ci + co) + 4 * 9 * ci * co
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


def time_convs(device, shapes, dtype, label: str = "kernels") -> dict[str, float]:
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
    for shape in sorted(set(shapes)):
        ci, co, h, wd = stage(shape)
        n = shapes.count(shape)
        n_dx = n - int(shape == first)
        x = torch.randn(TRAIN_BATCH, ci, h, wd, generator=gd, device=device).to(dtype)
        dy = torch.randn(TRAIN_BATCH, co, h, wd, generator=gd, device=device).to(dtype)
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
        log(label, f"{name} B={TRAIN_BATCH} Ci={ci:3d} Co={co:3d} {h:3d}x{wd} x{n} (ms "
            f"replayed, kernel / plain / cuDNN {name}; host-launched kernel): " + ", ".join(
                f"{job} {k:.3f} / {p:.3f} / {lb:.3f}; {hk:.3f}"
                for job, (k, p, lb, hk) in row.items()))
    log(label, f"one {name} train step's convs at B={TRAIN_BATCH} (ms replayed, kernel / "
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


def time_mask(device, log_lines: str) -> None:
    """``--time-mask``: the conv backward's ReLU mask and bias gradient
    (``relu_bias_bwd``) over one train step's calls at B = 16, one a conv:
    the cartesian 640² UNet in bfloat16 and the polar 400 x 3360 one in
    float32. Each distinct shape is held against its plain version (dy_m bit
    for bit, db within 1e-5 of a float64 sum), then the kernel and the plain
    version (the compare, cast, multiply, float32 copy and sum it replaces)
    are replayed from CUDA graphs in turns, beside the bound by bytes (y and
    dy read, dy_m written, once each). Then the kernel alone at B = 16, 16 x
    640², bfloat16, against its bound. ``log_lines``: nvcc's log of this
    build, whose ptxas lines for the kernel are printed."""
    from mm_masking_tpu_torch.ops.kernels.conv2d import relu_bias_bwd, relu_bias_bwd_plain

    ours = False
    for line in log_lines.splitlines():
        if "Compiling entry" in line:
            ours = "relu_bias_bwd" in line
        if ours and ("ptxas" in line or "spill" in line):
            log("build", line.strip())
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    g = torch.Generator(device=device).manual_seed(27)

    def calls(Co, H, W, dtype):
        y = torch.randn(TRAIN_BATCH, Co, H, W, generator=g, device=device).to(dtype)
        dy = torch.randn(TRAIN_BATCH, Co, H, W, generator=g, device=device).to(dtype)
        return (lambda: relu_bias_bwd(y, dy, True)), (lambda: relu_bias_bwd_plain(y, dy, True))

    for label, width, dtype in (("cart 640 bfloat16", 640, torch.bfloat16),
                                ("polar 400x3360 float32", POLAR_SHAPE, torch.float32)):
        shapes = [stage(s)[1:] for s in conv3x3_shapes(width=width)]
        rows = {}
        for shape in sorted(set(shapes)):
            kernel, plain = calls(*shape, dtype)
            (got, db), (want, db_plain) = kernel(), plain()
            db64 = want.double().sum((0, 2, 3))
            err = ((db.double() - db64).abs().max() / db64.abs().max()).item()
            if not torch.equal(got.view(bits[dtype]), want.view(bits[dtype])) or err > 1e-5:
                raise AssertionError(f"relu_bias_bwd {label} {shape}: dy_m not the plain "
                                     f"version's bits, or db {err:.2e} from a float64 sum")
            k, p = in_turns(plain, kernel, graph_ms)
            bound = 3 * got.numel() * got.element_size() / HBM_BYTES_PER_S * 1e3
            rows[shape] = (k, p, bound)
            log("kernels", f"relu_bias_bwd {label} B={TRAIN_BATCH} {shape}: kernel {k:.4f} ms "
                f"replayed, plain {p:.4f}, bound {bound:.4f} (bytes), db {err:.2e} from a "
                f"float64 sum")
            del kernel, plain, got, db, want, db_plain
            torch.cuda.empty_cache()
        k, p, bound = (sum(rows[s][i] for s in shapes) for i in range(3))
        log("kernels", f"relu_bias_bwd {label}, one train step's {len(shapes)} calls (ms): "
            f"kernel {k:.4f} replayed, plain {p:.4f}, bound {bound:.4f} (bytes): "
            f"{100 * bound / k:.1f}% of the bound")
    kernel, _ = calls(16, 640, 640, torch.bfloat16)
    k = graph_ms(kernel)
    bound = 3 * TRAIN_BATCH * 16 * 640 * 640 * 2 / HBM_BYTES_PER_S * 1e3
    log("kernels", f"relu_bias_bwd B={TRAIN_BATCH} 16 x 640^2 bfloat16: kernel {k:.4f} ms "
        f"replayed, bound {bound:.4f} (bytes): {100 * bound / k:.1f}% of the bound")


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
    n_conv = len(conv3x3_shapes(cfg.model.enc_channels, unet_size(cfg.model)))
    if counts["conv3x3"] != n_conv:
        raise AssertionError(f"expected {n_conv} conv3x3 launches, got {counts['conv3x3']}")
    if counts["nn_stripe"] + counts["nn_argmin"] < 1:
        raise AssertionError("the ICP launched no NN kernel")
    size = unet_size(cfg.model)
    loc, mp, T0 = batch["loc_data"], batch["map_data"], batch["transforms"]["T_ml_init"]
    if not torch.isfinite(err).all() or mask.shape != (len(T0), *(
            size if isinstance(size, tuple) else (size, size))):
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
        f"{unet_size(trainer.cfg.model)} N={batch['loc_data']['raw_pc'].shape[1]} "
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
        state.graphs.clear()  # the graph holds its state: free it now, not at a gc pass
        return times

    times = three_paths(turn)
    log(label, f"train_step B={TRAIN_BATCH} {unet_size(trainer.cfg.model)} N={N_SCAN} M={N_MAP} "
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
    n_conv = len(conv3x3_shapes(cfg.model.enc_channels, unet_size(cfg.model)))
    n_up = len(upsample_shapes(cfg.model.enc_channels, unet_size(cfg.model)))
    # The lookup backward: the weights', and a polar mask's warp to cartesian.
    n_lookup = 1 + (cfg.model.network_output_type == "polar")
    want = {"conv3x3": n_conv, "conv3x3_dx": n_conv - 1, "conv3x3_dk": n_conv,
            "relu_bias_bwd": n_conv, "resize_bwd": 2 * n_up, "bilinear_points_bwd": n_lookup}
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


def check_replays(trainer: Trainer, batch, steps, snaps, label: str = "train"
                  ) -> tuple[float, float, float]:
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
    log(label, f"graph vs eager kernel path, each replay against an eager step from its "
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
    loss is not held to the float32 step's: bfloat16 activations."""
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    trainer = Trainer(cfg, device)
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    *_, counts = captured_steps(trainer, batch, "train_bf16")
    return counts, {"times": time_train(trainer, batch, "train_bf16")}


# The implicit phase's runs: (label, ICP type, UNet type).
IMPLICIT_RUNS = (("implicit", "pt2pt", "float32"), ("implicit_pt2pl", "pt2pl", "float32"),
                 ("implicit_bf16", "pt2pl", "bfloat16"))


def run_implicit(device, cfg: Config) -> dict[str, dict]:
    """The train step with ``icp_diff_mode="implicit"`` at full width, B =
    16 (pt2pt and pt2pl in float32, pt2pl in bfloat16): the solve to
    tolerance (max(5 * max_iter, 50) iterations, each item frozen on the
    device) in the forward, and the implicit-function-theorem weight
    gradient, with its dense association (K1), in the backward, all in the
    step's one CUDA graph. Per run: captured, 3 replays with the counters
    from 0 (every conv, K4 in the forward, K1 exactly once a step), each
    against an eager kernel-path step from its state (loss and grad_norm
    1e-6 relative, parameters 1e-5 of max |p|), the first against the plain
    path (float32: loss 1e-5, grad_norm 1e-3 relative; bfloat16: 2e-2, the
    bf16 train steps' limit), then timed on the three paths. Returns
    {label: the replays' counters}."""
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    out = {}
    for label, icp_type, dtype in IMPLICIT_RUNS:
        trainer = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, icp_diff_mode="implicit", icp_type=icp_type, dtype=dtype)), device)
        _, _, steps, snaps, counts = captured_steps(trainer, batch, label)
        if counts["nn_argmin"] != TRAIN_STEPS or counts["nn_stripe"] < TRAIN_STEPS:
            raise AssertionError(f"{label}: expected K1 once a step (the backward's dense "
                                 f"association) and K4 in the forward's solve, got {counts}")
        check_replays(trainer, batch, steps, snaps, label)
        with kernels.plain_versions():
            _, loss_p, _, gnorm_p = trainer.train_step(trainer.init_state(seed=0), batch)
        loss, gnorm = steps[0][1].item(), steps[0][3].item()
        d_loss = abs(loss - loss_p.item()) / abs(loss_p.item())
        d_gnorm = abs(gnorm - gnorm_p.item()) / gnorm_p.item()
        log(label, f"step 1 kernel vs plain ({dtype} {icp_type}): loss {loss:.7g} vs "
            f"{loss_p.item():.7g} (rel {d_loss:.3e}), grad_norm {gnorm:.7g} vs "
            f"{gnorm_p.item():.7g} (rel {d_gnorm:.3e})")
        lim_loss, lim_gnorm = (1e-5, 1e-3) if dtype == "float32" else (2e-2, 2e-2)
        if d_loss > lim_loss or d_gnorm > lim_gnorm:
            raise AssertionError(f"{label}: the implicit train step differs from the plain path "
                                 f"beyond loss {lim_loss} / grad_norm {lim_gnorm} relative")
        time_train(trainer, batch, label)
        out[label] = counts
        del trainer, steps, snaps
    return out


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
    """Phase 7: the train step at full width (B = 16), float32 and
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


DATA_TRAIN_FRAMES = 3  # frames a training pair: 12 pairs, 36 items, two batches of 16
DATA_VAL_FRAMES = 32  # one validation batch of 32


def write_tree(root: str, cfg: Config) -> float:
    """A Boreas-layout tree at full width under the default Config()'s pair
    names (the port's fixture writer): 400 x 3360 polar scans, 4096 scan and
    16384 map points; returns its size in MB."""
    for i, (map_seq, loc_seq) in enumerate(cfg.train_loc_pairs):
        write_synthetic_dataset(root, map_seq, loc_seq, n_frames=DATA_TRAIN_FRAMES,
                                n_scan=N_SCAN, n_map=N_MAP, polar_shape=POLAR_SHAPE, seed=i)
    for map_seq, loc_seq in cfg.val_loc_pairs:
        write_synthetic_dataset(root, map_seq, loc_seq, n_frames=DATA_VAL_FRAMES,
                                n_scan=N_SCAN, n_map=N_MAP, polar_shape=POLAR_SHAPE, seed=99)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs) / 1e6


def warp_limit(polar: torch.Tensor) -> float:
    """The polar→cartesian warp's float32 conditioning: two ulps of a
    sampling coordinate (its pixel index, up to R − 1 along range and A + 1
    along azimuth) times the largest step between neighbouring polar
    pixels. The card's arithmetic (fused multiply-adds) and the CPU's may
    round a coordinate apart by that much."""
    A, R = polar.shape[-2:]
    d_range = (polar[..., 1:] - polar[..., :-1]).abs().max().item()
    d_az = (polar[:, 1:] - polar[:, :-1]).abs().max().item()
    return 2 * 2.0 ** -23 * ((R - 1) * d_range + (A + 1) * d_az)


def errors_line(T_pred: torch.Tensor, batch) -> str:
    r, t = frame_errors(T_pred, batch["transforms"]["T_ml_gt"])
    e = summarize(r.cpu().numpy(), t.cpu().numpy())
    return (f"rot mean {e.rot_mean:.4g} (max {e.rot_max:.4g}) rad, trans mean "
            f"{e.trans_mean:.4g} (max {e.trans_max:.4g}) m over {e.n_frames} frames")


# The validation artifacts the training CLI's fit writes (the JAX package's names).
ARTIFACTS = ("learned_mask_epre", "learned_mask_e0", "raw_scan", "cfar_mask", "fft_mask",
             "map_mask")


def check_png(path: str, size: tuple[int, int]) -> None:
    """Raise unless ``path`` is an 8-bit PNG of ``size`` (width, height): the
    signature, the IHDR's size and depth, and IDAT data that decompresses to
    one filter byte and the pixels of each row."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError(f"{path}: not a PNG")
    width, height, depth, color = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    channels = {0: 1, 2: 3}.get(color, 0)
    if ((width, height) != size or depth != 8 or not channels
            or len(zlib.decompress(idat)) != height * (1 + width * channels)):
        raise AssertionError(f"{path}: {width} x {height}, depth {depth}, colour type {color}; "
                             f"expected an 8-bit {size[0]} x {size[1]} image")


def run_data(device, cfg: Config) -> dict:
    """The data path at the default Config(): a full-width tree written to a
    temporary directory, the training CLI's ``main`` on it (baseline,
    pre-training validation, one epoch of two graph-replayed B = 16 steps,
    validation, final validation) with the counters from 0; one collated
    batch's preprocessing on the card against the CPU (``warp_limit``);
    baselines 1-3,
    ``evaluate_sequence`` and ``gt_tools.eval_localization_run`` on the
    validation batch. Returns the CLI run's counters."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        mb = write_tree(root, cfg)
        log("data", f"wrote a {mb:.0f} MB tree ({len(cfg.train_loc_pairs)} training pairs of "
            f"{DATA_TRAIN_FRAMES} frames, {DATA_VAL_FRAMES} validation frames, polar "
            f"{POLAR_SHAPE}, {N_SCAN} / {N_MAP} points) in {time.perf_counter() - t0:.1f} s")
        ckpt = os.path.join(root, "ckpt")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        train_icp_weights.main(["--set", f"data.data_dir={root}", "--set",
                                "train.num_epochs=1", "--set", f"train.checkpoint_dir={ckpt}"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        log("data", f"train_icp_weights.main on the tree: {time.perf_counter() - t0:.1f} s; "
            f"launches {counts}")
        records = [json.loads(line) for line in open(os.path.join(ckpt, "run_metrics.jsonl"))]
        events = [r["event"] for r in records]
        numbers = [v for r in records for k, v in r.items()
                   if k not in ("event", "time") and isinstance(v, float)]
        if events != ["baseline", "pretrain_val", "epoch", "final_val"]:
            raise AssertionError(f"the CLI logged {events}")
        if not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"a logged number is not finite: {records}")
        if not {"best_policy.pt", "epoch_0.pt", "config.json"} <= set(os.listdir(ckpt)):
            raise AssertionError(f"checkpoints missing: {os.listdir(ckpt)}")
        art_dir = os.path.join(ckpt, "run_artifacts")
        if sorted(os.listdir(art_dir)) != sorted(f"{n}.png" for n in ARTIFACTS):
            raise AssertionError(f"the CLI's artifacts: {sorted(os.listdir(art_dir))}")
        width = cfg.model.cart_pixel_width
        for name in ARTIFACTS:
            check_png(os.path.join(art_dir, f"{name}.png"), (width, width))
        log("data", f"fit wrote {len(ARTIFACTS)} artifacts, valid {width} x {width} PNGs: "
            f"{', '.join(ARTIFACTS)}")
        n_conv = len(conv3x3_shapes(cfg.model.enc_channels, cfg.model.cart_pixel_width))
        # Two steps of one captured graph: the capture's warm-up and two replays.
        if counts["conv3x3_dk"] != 3 * n_conv or counts["bilinear_points_bwd"] != 3:
            raise AssertionError(f"expected the warm-up and 2 replays of the train step "
                                 f"({3 * n_conv} dk launches), got {counts}")
        epoch = records[2]
        log("data", f"epoch loss {epoch['loss']:.6g}, grad_norm {epoch['grad_norm']:.6g} (max "
            f"{epoch['grad_norm_max']:.6g}), val norm {epoch['acc']:.6g}; baseline "
            f"{records[0]}; checkpoints {sorted(os.listdir(ckpt))}")

        c = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_dir=root))
        train_ds = ICPWeightDataset(list(c.train_loc_pairs), c, "train")
        batch = _collate([train_ds[i] for i in range(TRAIN_BATCH)])
        got = preprocess_batch(to_tensors(batch, device), c)["loc_data"]
        want = preprocess_batch(to_tensors(batch, "cpu"), c)["loc_data"]
        polar = dataclasses.replace(c, model=dataclasses.replace(
            c.model, network_input_type="polar"))
        planes = preprocess_batch(to_tensors(batch, "cpu"), polar)["loc_data"]
        u8_equal = torch.equal(preprocess_batch(to_tensors(batch, device), polar)[
            "loc_data"]["fft_data"].cpu(), planes["fft_data"])
        warp = {k: ((got[k].cpu() - want[k]).abs().max().item(), warp_limit(planes[k]))
                for k in ("fft_data", "fft_cfar")}
        log("data", f"preprocess_batch B={TRAIN_BATCH} on the card vs the CPU: u8/255 bit for "
            f"bit {u8_equal}; warp max|d| and its limit " + ", ".join(
                f"{k} {d:.3e} (limit {lim:.3e}, max {want[k].abs().max().item():.3g})"
                for k, (d, lim) in warp.items()))
        if not u8_equal or any(d > lim for d, lim in warp.values()):
            raise AssertionError("preprocess_batch on the card differs from the CPU path")

        val_ds = ICPWeightDataset(list(c.val_loc_pairs), c, "test")
        vb = next(epoch_batches(val_ds, c.train.batch_size_test, c, shuffle=False,
                                drop_last=False, device=device))
        vpolar = next(epoch_batches(val_ds, c.train.batch_size_test, polar, shuffle=False,
                                    drop_last=False, device=device))
        trainer = Trainer(c, device)
        params = load_checkpoint(ckpt, "best_policy", map_location=device)["params"]
        T1 = baselines.config1_unweighted_pt2pl(c, vb)
        T2, pc2 = baselines.config2_cacfar_constant_icp(c, vpolar)
        T3, mask3 = baselines.config3_learned_mask_icp(trainer.policy, params, vb)
        for name, T in (("1 unweighted pt2pl", T1), ("2 CFAR peaks + constant weights", T2),
                        ("3 learned mask", T3)):
            if not torch.isfinite(T).all():
                raise AssertionError(f"baseline {name}: poses not finite")
            log("data", f"baseline {name}: {errors_line(T, vb)}")
        n_pc = int(((pc2[..., 0] != 0) | (pc2[..., 1] != 0)).sum(1).float().mean())
        log("data", f"baseline 2 extracted {n_pc} points a scan on average (of 4096 slots)")
        localize = make_constant_weight_localizer(c)
        seq = evaluate_sequence([vb], lambda b: localize(
            b["loc_data"]["filtered_pc"], b["map_data"]["pc"], b["transforms"]["T_ml_init"]))
        log("data", f"evaluate_sequence (constant weights): {seq.as_dict()}")

        # The learned mask's estimates as a trajectory file: T_loc_map per
        # frame (gt_eye: the map is aligned by T_ml_gt), against the CSVs.
        est = (T3 @ vb["transforms"]["T_ml_gt"]).double().cpu().numpy()
        stamps = vb["loc_data"]["timestamp"].tolist()
        traj = os.path.join(root, "est_traj.txt")
        gt_tools.write_traj_file(traj, list(est), stamps)
        map_seq, loc_seq = c.val_loc_pairs[0]
        stats = gt_tools.eval_localization_run(
            traj, os.path.join(root, "vtr_data", map_seq, "applanix", "lidar_poses.csv"),
            os.path.join(root, "vtr_data", loc_seq, "applanix", "radar_poses.csv"),
            plots_dir=os.path.join(root, "plots"), seq_name="est_traj")
        plots = stats.pop("plots")
        log("data", f"gt_tools.eval_localization_run on the learned mask's trajectory: {stats}; "
            f"plots {sorted(os.path.basename(p) for p in plots.values())}")
        if stats["n_frames"] != DATA_VAL_FRAMES or not all(
                math.isfinite(v) for v in stats.values()):
            raise AssertionError(f"eval_localization_run: {stats}")
        check_png(plots["png"], (900, 3 * 220 + 2 * 2))
    return counts


def nn_kernel_ms(fn) -> tuple[float, int]:
    """One call of fn under ``torch.profiler``: the summed device ms of the
    NN kernel's launches (K1 or K4, ``nn_argmin_kernel``, and its unpack)
    and their count."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    durs = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "nn_argmin" in e.name]
    return sum(durs) / 1e3, len(durs)


def run_refresh(device, cfg: Config, batch) -> dict[str, dict]:
    """The eval step at bench.py's configuration (``bench.py:215-246``:
    bfloat16, pt2pt, ``nn_refresh_dist = 0.05``) on the slice's batch, with
    the stripe association and with the dense one: its counters from 0; the
    solve on the step's own weights held against the same solve ungated
    (``nn_refresh_dist = 0``) and against the gated solve on the plain path,
    1 mm / 0.005 deg on items converged on both, at most 10 stop-test reads;
    the item-iterations that skipped the search; the graph-path step time
    and the NN kernel's device time of the gated and the ungated step.
    Returns {label: counters}."""
    counts = {}
    for label, overrides in (("refresh", ()), ("refresh_dense", ("nn_stripe=false",))):
        model = dataclasses.replace(cfg.model, dtype="bfloat16", nn_refresh_dist=0.05,
                                    icp_overrides=overrides)
        trainer = Trainer(dataclasses.replace(cfg, model=model), device)
        ungated = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
            model, nn_refresh_dist=0.0)), device)
        params = trainer.init_state(seed=0).params
        trainer.eval_step(params, batch)  # warm-up: captures the gated solve's chunk
        ungated.eval_step(params, batch)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        err, _, _ = trainer.eval_step(params, batch)
        torch.cuda.synchronize()
        counts[label] = kernels.launch_counts()
        log(label, f"launches {counts[label]}; err (norm, rot, trans) {err.tolist()}")
        if not torch.isfinite(err).all():
            raise AssertionError(f"{label}: the eval step's error is not finite")

        loc, mp, T0 = batch["loc_data"], batch["map_data"], batch["transforms"]["T_ml_init"]
        icp_cfg = dataclasses.replace(trainer.policy._icp_inference, dim=2)
        with torch.inference_mode():
            mask = trainer.policy.apply(params, loc, mp, T0, mask_only=True)
            w, _ = extract_weights(mask, loc["raw_pc"], cart_resolution=cfg.model.cart_resolution,
                                   cart_pixel_width=cfg.model.cart_pixel_width)
            args = (loc["filtered_pc"], mp["pc"], T0)
            gated = icp(*args, weight=w, cfg=icp_cfg)
            flat = icp(*args, weight=w, cfg=dataclasses.replace(icp_cfg, nn_refresh_dist=0.0))
            with kernels.plain_versions():
                plain = icp(*args, weight=w, cfg=icp_cfg)
            searched = count_searches(args, w, icp_cfg)
        iters = int(gated["iterations"])
        B = len(T0)
        log(label, f"gated solve: {iters} iterations (ungated {int(flat['iterations'])}, plain "
            f"path {int(plain['iterations'])}), {gated['stop_tests']} stop-test reads; "
            f"{B * iters - searched} of {B * iters} item-iterations skipped the search "
            f"({int((gated['delta_norm'] < 1e-5).sum())}/{B} items converged)")
        if gated["stop_tests"] > math.ceil(cfg.model.inference_max_iter / STOP_TEST_EVERY):
            raise AssertionError(f"{label}: {gated['stop_tests']} stop-test reads")
        # The gated solve is held to its plain path. Against the ungated
        # solve it is logged: an item whose gate stays closed converges on the
        # correspondences of its last search, and on this dense map that can
        # be far from where the ungated solve crawls to, in the JAX package
        # alike (tests/test_torch_refresh.py); the JAX package bounds the
        # two only on converging scenes (tests/test_icp.py:385).
        hold_poses(label, "gated vs plain path", gated, plain)
        hold_poses(label, "gated vs ungated (logged)", gated, flat, limit=False)
        g = torch.Generator().manual_seed(27)
        xi = torch.zeros(B, 6)
        xi[:, :2] = (torch.rand(B, 2, generator=g) * 2 - 1) * 0.4
        xi[:, 5] = (torch.rand(B, generator=g) * 2 - 1) * 0.1
        near = (se3_exp(xi).to(device) @ batch["transforms"]["T_ml_gt"]).contiguous()
        with torch.inference_mode():
            args = (loc["filtered_pc"], mp["pc"], near)
            near_gated = icp(*args, weight=w, cfg=icp_cfg)
            near_flat = icp(*args, weight=w,
                            cfg=dataclasses.replace(icp_cfg, nn_refresh_dist=0.0))
        log(label, f"from near guesses (x, y within 0.4 m, yaw within 0.1 rad of T_ml_gt): "
            f"gated {int(near_gated['iterations'])} iterations, ungated "
            f"{int(near_flat['iterations'])}")
        hold_poses(label, "gated vs ungated from near guesses (logged)", near_gated, near_flat,
                   limit=False)
        for name, t in (("gated", trainer), ("ungated", ungated)):
            ms = host_ms(lambda: t.eval_step(params, batch), reps=5)
            nn_ms, n_nn = nn_kernel_ms(lambda: t.eval_step(params, batch))
            log(label, f"{name} eval_step B={B} bf16, graph path, host clock: {spread(ms)}; "
                f"NN kernel {nn_ms:.3f} ms of the card in {n_nn} launches")
        del trainer, ungated
    return counts


def hold_poses(label: str, what: str, got: dict, ref: dict, limit: bool = True) -> None:
    """Two solves' poses on the items converged in both: logged, and held
    within 1 mm / 0.005 deg (with ``limit``; then some item must have
    converged in both)."""
    conv = (got["delta_norm"] < 1e-5) & (ref["delta_norm"] < 1e-5)
    dt = (got["T"][:, :3, 3] - ref["T"][:, :3, 3]).norm(dim=-1)
    dyaw = yaw_deg(got["T"][:, :3, :3] @ ref["T"][:, :3, :3].transpose(1, 2)).abs()
    close = conv & (dt <= 1e-3) & (dyaw <= 5e-3)
    log(label, f"{what}: {int(conv.sum())}/{len(conv)} items converged in both, "
        f"{int(close.sum())} of them within 1 mm / 0.005 deg: max |dt|={most(dt[conv]):.3e} "
        f"m, max |dyaw|={most(dyaw[conv]):.3e} deg")
    if limit and (not conv.any() or most(dt[conv]) > 1e-3 or most(dyaw[conv]) > 5e-3):
        raise AssertionError(f"{label}, {what}: poses differ beyond 1 mm / 0.005 deg")


def count_searches(args, w, icp_cfg) -> int:
    """The gated solve run eagerly with each association's ``refresh`` (the
    gate ``need``) summed: the item-iterations that searched the map."""
    icp_module = sys.modules["mm_masking_tpu_torch.dicp.icp"]
    total, orig = [], icp_module._associate

    def spy(inp, p, cfg, stripe, refresh=None):
        if refresh is not None:
            total.append(refresh.sum())
        return orig(inp, p, cfg, stripe, refresh)

    icp_module._associate = spy
    try:
        with kernels.eager():
            icp(*args, weight=w, cfg=icp_cfg)
    finally:
        icp_module._associate = orig
    return int(torch.stack(total).sum())


LOC_BATCH, LOC_CHUNK = 32, 8  # the batched localization: 4 chunks of 8 frames
CLI_FRAMES, CLI_MAP_PTS = 24, 8192  # each sequence of the CLI tree; the teach map's rows
SCAN_STEP_US = 250_000  # a Navtech sweep


def localize_chunks(batch, policy=None, params=None) -> tuple[dict, list, torch.Tensor | None]:
    """``localize_frame`` over the batch in chunks of ``LOC_CHUNK`` (each
    item against its own map) at the default ``LocalizationConfig`` with
    beta 0, with ``policy.mask_for_scan`` per chunk when given: (the
    results, the refined solves' outputs, the masks)."""
    loc, mp, T0 = batch["loc_data"], batch["map_data"]["pc"], batch["transforms"]["T_ml_init"]
    cfg = LocalizationConfig(beta=0.0)
    mkw = {}
    if policy is not None:
        mkw = dict(mask_cart_resolution=policy.cfg.model.cart_resolution,
                   mask_cart_width=policy.cfg.model.cart_pixel_width)
    pipe = localization_pipeline
    solves, orig = [], pipe.icp

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        if not kwargs["cfg"].differentiable:
            solves.append(out)
        return out

    outs, masks = [], []
    pipe.icp = spy
    try:
        with torch.no_grad():
            for s in range(0, len(T0), LOC_CHUNK):
                sl = slice(s, s + LOC_CHUNK)
                wm = None
                if policy is not None:
                    wm = policy.mask_for_scan(params, loc["fft_data"][sl], loc["azimuths"][sl])
                    masks.append(wm)
                outs.append(localize_frame(loc["fft_data"][sl], loc["azimuths"][sl],
                                           loc["az_times"][sl], mp[sl], T0[sl], cfg,
                                           weight_mask=wm, **mkw))
    finally:
        pipe.icp = orig
    out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return out, solves, (torch.cat(masks) if masks else None)


def restart_moves(out: dict, batch, T_from: torch.Tensor) -> torch.Tensor:
    """How far the refined solve, restarted at T_from on out's own points and
    weights (tolerance 1e-7), moves each item: T_from is a fixed point of it
    where this is below 1e-4 m."""
    cfg = LocalizationConfig(beta=0.0)
    refined = dataclasses.replace(localization_pipeline._icp_configs(cfg)[1], tolerance=1e-7)
    with torch.no_grad():
        again = icp(out["points"], project_map(batch["map_data"]["pc"], cfg), T_from,
                    weight=out["weights"], cfg=refined)["T"]
    return (again[:, :3, 3] - T_from[:, :3, 3]).norm(dim=-1)


def hold_localized(label: str, got, ref, batch, exact: bool) -> None:
    """The kernel path (got = (out, solves, masks)) against the plain path:
    with ``exact`` (uniform weights; the NN kernels are bit-identical to
    their plain versions) equal refined iteration counts, every pose within
    1e-6 m / 1e-5 deg, matched ratio and ok equal. Otherwise (the mask in
    the loop, whose convs differ from cuDNN's in float32 rounding) the items
    converged in both within 1 mm / 0.005 deg, with equal matched ratio and
    ok; an item converged in both that parts further passes only if the
    plain path's pose is a fixed point of the kernel path's refined solve
    (``restart_moves`` below 1e-4 m): two converged solutions of one
    problem, which the tests on the CPU meet against the JAX package."""
    (out, solves, mask), (rout, rsolves, rmask) = got, ref
    iters = [int(s["iterations"]) for s in solves]
    riters = [int(s["iterations"]) for s in rsolves]
    dn = torch.cat([s["delta_norm"] for s in solves])
    rdn = torch.cat([s["delta_norm"] for s in rsolves])
    conv = (dn < 1e-5) & (rdn < 1e-5)
    dt = (out["T"][:, :3, 3] - rout["T"][:, :3, 3]).norm(dim=-1)
    dyaw = (yaw_deg(out["T"][:, :3, :3]) - yaw_deg(rout["T"][:, :3, :3])).abs()
    same_ratio = (out["matched_ratio"] == rout["matched_ratio"]) & (out["ok"] == rout["ok"])
    log(label, f"kernel vs plain: refined iterations per chunk {iters} (plain {riters}), "
        f"stop-test reads {[s['stop_tests'] for s in solves]}; {int(conv.sum())}/{len(conv)} "
        f"items converged in both; max |dt| {dt.max().item():.3e} m, max |dyaw| "
        f"{dyaw.max().item():.3e} deg (converged: {most(dt[conv]):.3e} m, "
        f"{most(dyaw[conv]):.3e} deg); matched ratio and ok equal on "
        f"{int(same_ratio.sum())}/{len(same_ratio)}"
        + ("" if mask is None else f"; mask max|d| {(mask - rmask).abs().max().item():.3e}"))
    if max(s["stop_tests"] for s in solves) > math.ceil(50 / STOP_TEST_EVERY):
        raise AssertionError(f"{label}: more than 10 stop-test reads in a refined solve")
    if exact:
        if iters != riters or dt.max() > 1e-6 or dyaw.max() > 1e-5 or not same_ratio.all():
            raise AssertionError(f"{label}: kernel and plain paths differ beyond equal "
                                 f"iterations, 1e-6 m / 1e-5 deg and equal matched ratios")
        return
    held = conv & (dt <= 1e-3) & (dyaw <= 5e-3)
    parted = conv & ~held
    if not held.any() or not same_ratio[held].all():
        raise AssertionError(f"{label}: no converged item within 1 mm / 0.005 deg, or their "
                             "matched ratios differ")
    if parted.any():
        moved = restart_moves(out, batch, rout["T"])
        log(label, f"items {torch.nonzero(parted).flatten().tolist()} converged in both but "
            f"parted by {dt[parted].tolist()} m; restarting the kernel path's refined solve "
            f"at the plain pose moves them {moved[parted].tolist()} m")
        if (moved[parted] > 1e-4).any():
            raise AssertionError(f"{label}: kernel and plain poses part beyond 1 mm / 0.005 deg "
                                 "and the plain pose is no fixed point of the kernel path")


def run_localize_batch(device, cfg: Config) -> tuple[dict, dict]:
    """Part (a) of the localize phase: 32 polar 400 x 3360 scans (4096 scan,
    16384 map points with normals) localized in chunks of 8 with uniform
    weights, with a seeded default-Config() policy's mask (float32), and
    with its bfloat16 variant; counters from 0 over each main-path run,
    held against the plain path. Returns the float32 and bfloat16 runs'
    summed counters."""
    spec = SyntheticSpec(network_input_type="polar", n_scan=N_SCAN, n_map=N_MAP)
    batch = synthetic_batch(3, LOC_BATCH, spec, device=device)
    T0 = batch["transforms"]["T_ml_init"]
    init_err = T0[:, :2, 3].norm(dim=-1)
    counts = {"localize": {}, "localize_bf16": {}}
    for label, dtype in (("uniform", None), ("mask f32", "float32"), ("mask bf16", "bfloat16")):
        policy = params = None
        if dtype is not None:
            pcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
            policy = LearnICPWeightPolicy(pcfg, device)
            params = policy.init(torch.Generator().manual_seed(0))
        localize_chunks(batch, policy, params)  # warm-up: the refined solves' graphs
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = localize_chunks(batch, policy, params)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c = kernels.launch_counts()
        phase = "localize_bf16" if dtype == "bfloat16" else "localize"
        counts[phase] = {k: counts[phase].get(k, 0) + v for k, v in c.items()}
        need = ("nn_stripe", "nn_argmin") + (() if policy is None else ("conv3x3",))
        if any(c[k] < 1 for k in need):
            raise AssertionError(f"localize {label}: a kernel of the path did not launch: {c}")
        err = got[0]["T"][:, :2, 3].norm(dim=-1)
        if not torch.isfinite(got[0]["T"]).all():
            raise AssertionError(f"localize {label}: poses not finite")
        log("localize", f"{label}: {LOC_BATCH} frames in chunks of {LOC_CHUNK}, graph path "
            f"{ms:.1f} ms host clock ({1e3 * LOC_BATCH / ms:.1f} frames/s); launches "
            f"{ {k: v for k, v in c.items() if v} }; median translation error "
            f"{err.median().item():.4f} m (initial {init_err.median().item():.4f} m), "
            f"matched ratio mean {got[0]['matched_ratio'].mean().item():.3f}")
        with kernels.plain_versions():
            ref = localize_chunks(batch, policy, params)
        if dtype == "bfloat16":
            mask_d = (got[2] - ref[2]).abs().max().item()
            if mask_d > 5e-2:
                raise AssertionError(f"localize {label}: masks differ by {mask_d} > 5e-2")
        hold_localized(f"localize {label}", got, ref, batch, exact=policy is None)
        del policy, params
    return counts["localize"], counts["localize_bf16"]


def render_scan(world: np.ndarray, T_world_robot: np.ndarray, stamp_us: int,
                rng: np.random.Generator) -> np.ndarray:
    """A raw Navtech scan (400 x 3360 polar, the load_radar byte layout) of
    the world seen from T_world_robot: bright two-bin returns at each
    point's (azimuth, range) bin over a noise floor."""
    A, R = POLAR_SHAPE
    Ti = np.linalg.inv(T_world_robot)
    s = world @ Ti[:3, :3].T + Ti[:3, 3]
    rr = np.hypot(s[:, 0], s[:, 1])
    aa = np.mod(np.arctan2(s[:, 1], s[:, 0]), 2 * np.pi)
    keep = (rr > 3.0) & (rr < 75.0)
    ai = np.clip((aa[keep] / (2 * np.pi / A)).astype(int), 0, A - 1)
    ri = np.clip((rr[keep] / 0.0596).astype(int), 0, R - 3)
    fft = (0.05 * rng.random((A, R)) ** 2).astype(np.float32)
    for dr, level in ((0, 0.9), (1, 0.7)):
        fft[ai, ri + dr] = np.maximum(fft[ai, ri + dr], level)
    img = np.zeros((A, 11 + R), np.uint8)
    ts = stamp_us + np.arange(A, dtype=np.int64) * (SCAN_STEP_US // A)
    img[:, :8] = np.frombuffer(ts.tobytes(), np.uint8).reshape(A, 8)
    enc = (np.arange(A, dtype=np.float64) / A * 5600).astype(np.uint16)
    img[:, 8:10] = np.frombuffer(enc.tobytes(), np.uint8).reshape(A, 2)
    img[:, 11:] = np.clip(fft * 255, 0, 255).astype(np.uint8)
    return img


def write_loc_tree(root: str) -> dict[str, list]:
    """One world (a ring of scatterers and four walls) and two sequences of
    CLI_FRAMES raw scans rendered along a path (teach, and a repeat offset
    from it), with their Applanix CSVs and identity calibration, in the
    Boreas layout: {seq: [(stamp, x, y, heading)]}."""
    rng = np.random.default_rng(23)
    r, a = rng.uniform(8.0, 40.0, 2500), rng.uniform(0.0, 2 * np.pi, 2500)
    ring = np.stack([r * np.cos(a), r * np.sin(a)], -1)
    t = rng.uniform(-30.0, 50.0, 1500)
    walls = np.concatenate([np.stack([t[:500], np.full(500, 18.0)], -1),
                            np.stack([t[500:1000], np.full(500, -16.0)], -1),
                            np.stack([np.full(250, 50.0), rng.uniform(-16, 18, 250)], -1),
                            np.stack([np.full(250, -30.0), rng.uniform(-16, 18, 250)], -1)])
    world = np.concatenate([ring, walls])
    world = np.concatenate([world, np.zeros((len(world), 1))], -1)
    rows = {"loc-teach": [(1_000_000 + SCAN_STEP_US * i, 0.5 * i, 0.02 * i, 0.004 * i)
                          for i in range(CLI_FRAMES)],
            "loc-repeat": [(90_000_000 + SCAN_STEP_US * i, 0.3 + 0.5 * i, 0.2 + 0.02 * i,
                            0.02 + 0.004 * i) for i in range(CLI_FRAMES)]}
    for seq, seq_rows in rows.items():
        d = os.path.join(root, "vtr_data", seq)
        for sub in ("radar", "applanix", "calib"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for name in ("T_applanix_lidar.txt", "T_radar_lidar.txt"):
            np.savetxt(os.path.join(d, "calib", name), np.eye(4))
        with open(os.path.join(d, "applanix", "radar_poses.csv"), "w") as f:
            f.write("GPSTime,easting,northing,altitude,vel_e,vel_n,vel_u,roll,pitch,heading\n")
            for st, x, y, h in seq_rows:
                f.write(f"{st / 1e6:.6f},{x},{y},0.0,0,0,0,0.0,0.0,{h}\n")
        for st, x, y, h in seq_rows:
            T = np.eye(4)
            T[:3, :3] = yawPitchRollToRot(h, 0.0, 0.0)
            T[:2, 3] = (x, y)
            np.save(os.path.join(d, "radar", f"{st}.npy"), render_scan(world, T, st, rng))
    return rows


def teach_pass(clouds: torch.Tensor) -> TeachPass:
    teach = TeachPass(OdometryConfig(max_map_pts=CLI_MAP_PTS))
    for c in clouds:
        teach.process(c)
    return teach


def run_localize_cli(device, cfg: Config, smi: str) -> dict:
    """Part (b) of the localize phase: the CLI's teach, datagen and localize
    (with a seeded default-Config() checkpoint, GT stats and --init-chain)
    on a written tree of raw 400 x 3360 scans, counters from 0 over the
    three commands; the teach pass on the kernels against the plain path
    and bitwise across two runs. Returns the commands' counters."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rows = write_loc_tree(root)
        teach_dir = os.path.join(root, "vtr_data", "loc-teach", "radar")
        loc_dir = os.path.join(root, "vtr_data", "loc-repeat", "radar")
        ckpt = os.path.join(root, "ckpt")
        run_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                      checkpoint_dir=ckpt))
        trainer = Trainer(run_cfg, device)
        trainer.save(trainer.init_state(seed=0), "best_policy")
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(run_cfg), f)
        del trainer
        log("localize", f"wrote 2 x {CLI_FRAMES} raw scans {POLAR_SHAPE} and a seeded checkpoint "
            f"in {time.perf_counter() - t0:.1f} s")
        map_npz, traj = os.path.join(root, "map.npz"), os.path.join(root, "traj.txt")
        gt = {seq: os.path.join(root, "vtr_data", seq, "applanix", "radar_poses.csv")
              for seq in rows}
        commands = {
            "teach": ["teach", "--scans", teach_dir, "--out-map", map_npz, "--out-traj",
                      os.path.join(root, "odo.txt"), "--max-map-pts", str(CLI_MAP_PTS)],
            "datagen": ["datagen", "--data-root", root, "--map-seq", "loc-teach", "--loc-seq",
                        "loc-repeat", "--max-points", str(N_SCAN), "--max-map-pts",
                        str(CLI_MAP_PTS)],
            "localize": ["localize", "--scans", loc_dir, "--map", map_npz, "--out-traj", traj,
                         "--checkpoint", ckpt, "--map-gt", gt["loc-teach"], "--loc-gt",
                         gt["loc-repeat"], "--stats", os.path.join(root, "stats.json"),
                         "--init-chain", "--icp-type", "pt2pt", "--normal-threshold", "1.0"],
        }
        secs, per_command = {}, {}
        for name, argv in commands.items():
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            if localization_cli.main(argv + ["--device", str(device)]) != 0:
                raise AssertionError(f"localize CLI {name} failed")
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            per_command[name] = {k: v for k, v in kernels.launch_counts().items() if v}
        counts = {k: sum(c.get(k, 0) for c in per_command.values())
                  for k in kernels.launch_counts()}
        stats = json.load(open(os.path.join(root, "stats.json")))
        poses, _ = gt_tools.read_traj_file(traj)
        odo, _ = gt_tools.read_traj_file(os.path.join(root, "odo.txt"))
        m = np.load(map_npz)["map_pc"]
        log("localize", "CLI wall times: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
            + f"; localize {CLI_FRAMES / secs['localize']:.1f} frames/s (--init-chain, mask in "
            f"the loop, B = 1) on {smi}; launches by command {per_command}")
        log("localize", f"stats {stats}; map {int((np.abs(m[:, 0]) < 500).sum())} of "
            f"{len(m)} rows real")
        if not (all(np.isfinite(p).all() for p in poses + odo) and np.isfinite(m).all()
                and all(math.isfinite(v) for v in stats.values())):
            raise AssertionError("localize CLI: a pose, map row or stat is not finite")
        if any(counts[k] < 1 for k in ("nn_stripe", "nn_argmin", "conv3x3")):
            raise AssertionError(f"localize CLI: a kernel of the path did not launch: {counts}")

        ds_cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, map_sensor="radar", loc_sensor="radar", data_dir=root))
        item = ICPWeightDataset([("loc-teach", "loc-repeat")], ds_cfg, "test")[0]
        log("localize", f"datagen: ICPWeightDataset item 0: raw_pc "
            f"{item['loc_data']['raw_pc'].shape}, map {item['map_data']['pc'].shape}, fft "
            f"{item['loc_data']['fft_data'].shape}")
        if not np.isfinite(item["transforms"]["T_ml_gt"]).all():
            raise AssertionError("datagen: the dataset's item is not finite")

        paths = [os.path.join(teach_dir, f"{st}.npy") for st, *_ in rows["loc-teach"]]
        clouds = localization_cli._extract_clouds(localization_cli._load_radar_frames(paths),
                                                  LocalizationConfig(), 8, device)
        t0 = time.perf_counter()
        one, two = teach_pass(clouds), teach_pass(clouds)
        torch.cuda.synchronize()
        per_frame = (time.perf_counter() - t0) * 1e3 / (2 * CLI_FRAMES)
        with kernels.plain_versions():
            plain = teach_pass(clouds)
        T1, T2, Tp = (torch.stack(t._poses) for t in (one, two, plain))
        bitwise = (torch.equal(one.map_pts, two.map_pts) and torch.equal(one.map_w, two.map_w)
                   and torch.equal(T1, T2))
        dt = (T1[:, :3, 3] - Tp[:, :3, 3]).norm(dim=-1).max().item()
        log("localize", f"teach pass ({CLI_FRAMES} frames, {N_SCAN} points, map "
            f"{CLI_MAP_PTS}): {per_frame:.2f} ms a frame; two passes bitwise equal {bitwise}; "
            f"keyframes {one.n_keyframes} (plain path {plain.n_keyframes}), max |dt| vs plain "
            f"{dt:.3e} m; captured ICP chunk graphs {len(sys.modules['mm_masking_tpu_torch.dicp.icp']._CHUNKS)}")
        if not bitwise:
            raise AssertionError("two teach passes on the card differ")
        if one.n_keyframes != plain.n_keyframes or dt > 1e-4:
            raise AssertionError("the teach pass on the kernels differs from the plain path")
    return counts


POLAR_STEPS = 3  # replays of the polar train step


def polar_config(cfg: Config, dtype: str = "float32") -> Config:
    """The default Config() with polar network input and output, the mask
    loss's map-points term off (a polar mask has no cartesian BEV to match,
    ROADMAP §3), in ``dtype``."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, network_input_type="polar",
                                       network_output_type="polar", dtype=dtype),
        loss=dataclasses.replace(cfg.loss, mask_pts=0.0))


def check_polar_convs(device, shapes) -> dict[str, float]:
    """K2 (forward, dx) and K3 (dk) at every polar stage shape (Ci, Co, H, W),
    f32 and bf16, B = 4, against their plain versions with the kernels
    phase's limits (forward and dx 1e-4 of max |plain|, 2e-2 in bf16; dk
    within 1e-5 of a float64 sum and bitwise across two runs, kernel vs
    plain logged), the bf16 forward and dx also elementwise against float64
    convs. Returns the largest absolute differences from the plain versions."""
    g = torch.Generator().manual_seed(5)
    worst = dict.fromkeys(("fwd", "fwd_bf16", "dx", "dx_bf16", "dk", "dk_bf16"), 0.0)
    for shape in sorted(set(shapes)):
        ci, co, h, wd = stage(shape)
        x = torch.randn(CHECK_BATCH, ci, h, wd, generator=g)
        dy = torch.randn(CHECK_BATCH, co, h, wd, generator=g)
        w = torch.randn(co, ci, 3, 3, generator=g) * math.sqrt(2.0 / (9 * (ci + co)))
        b = torch.randn(co, generator=g) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            xs, dys, ws, bs = (t.to(device, dtype) for t in (x, dy, w, b))
            label = f"B={CHECK_BATCH} Ci={ci:3d} Co={co:3d} {h:3d}x{wd:4d} {str(dtype)[6:]:8s}"
            got = conv3x3(xs, ws, bs, True).float()
            want = conv3x3_plain(xs, ws, bs, True).float()
            rel = rel_err(got, want)
            log("polar", f"conv3x3 {label} forward max|d|/max|y|={rel:.3e}")
            if rel > (1e-4 if dtype == torch.float32 else 2e-2):
                raise AssertionError(f"polar conv3x3 forward {label}: {rel}")
            dx_abs, dk_abs = check_backward(xs, dys, ws, f"polar {label}", dk_vs_plain=False)
            sfx = "_bf16" if dtype == torch.bfloat16 else ""
            worst["fwd" + sfx] = max(worst["fwd" + sfx], (got - want).abs().max().item())
            worst["dx" + sfx] = max(worst["dx" + sfx], dx_abs)
            worst["dk" + sfx] = max(worst["dk" + sfx], dk_abs)
            if dtype == torch.bfloat16:
                check_bf16_float64(xs, dys, ws, f"polar {label}")
    return worst


def check_polar_resize(device, enc) -> float:
    """``resize_bwd`` at every polar upsample (12x105 -> 25x210 ... 200x1680
    -> 400x3360), each axis as the backward meets it (W, then H), B = 16, f32
    and bf16: against its plain version (1e-6 of max |g| in f32, 2e-2 in
    bf16) and bitwise across two runs. Returns the largest f32 relative
    difference."""
    gd = torch.Generator(device=device).manual_seed(6)
    worst = 0.0
    for c, h, w, H, W in upsample_shapes(enc, POLAR_SHAPE):
        for dtype in (torch.float32, torch.bfloat16):
            for axis, n_in, n_out, size in ((3, w, W, (H, W)), (2, h, H, (H, w))):
                dy = torch.randn(TRAIN_BATCH, c, *size, generator=gd, device=device).to(dtype)
                i0, w0, w1 = resample.resize_tables(n_in, n_out, dtype, device)
                got = resample.resize_bwd(dy, i0, w0, w1, n_in, axis)
                if not torch.equal(got, resample.resize_bwd(dy, i0, w0, w1, n_in, axis)):
                    raise AssertionError(f"resize_bwd {n_out}->{n_in} axis {axis}: two runs "
                                         "differ")
                rel = rel_err(got, resample.resize_bwd_plain(dy, i0, w0, w1, n_in, axis))
                log("polar", f"resize_bwd C={c} {tuple(dy.shape[2:])} axis {axis} {n_out}->"
                    f"{n_in} {str(dtype)[6:]}: rel {rel:.3e}, bitwise stable")
                if rel > (1e-6 if dtype == torch.float32 else 2e-2):
                    raise AssertionError(f"resize_bwd at a polar stage: {rel}")
                if dtype == torch.float32:
                    worst = max(worst, rel)
    return worst


def fresh_chain(trainer: Trainer, batch) -> list:
    """``train_chain`` from a fresh state (seed 0), its graph freed after."""
    state = trainer.init_state(seed=0)
    try:
        return train_chain(trainer, batch, state)
    finally:
        state.graphs.clear()


def run_polar(device, cfg: Config) -> tuple[dict, dict]:
    """Phase 12: the policy with polar network input and output at full
    width (UNet 8...256 on the 400 x 3360 scan, the mask warped to 640^2
    before the weight lookup; 4096 / 16384 points, pt2pt, mask_pts = 0).
    K2 and K3 at every polar stage, both types, and resize_bwd at every
    polar upsample against their plain versions; the convs of one step timed
    beside cuDNN's; ``Trainer.train_step`` at B = 16 captured, 3 replays each
    against an eager step from its state, the first against the plain path,
    two chains bitwise equal, timed with peak memory; then bf16; then
    ``Trainer.eval_step`` at B = 32, graph against eager. Returns ({label:
    counters}, measured numbers)."""
    t0 = time.perf_counter()
    pcfg = polar_config(cfg)
    shapes = conv3x3_shapes(cfg.model.enc_channels, POLAR_SHAPE)
    errs = check_polar_convs(device, shapes)
    resize_rel = check_polar_resize(device, cfg.model.enc_channels)
    conv_ms = {str(dt)[6:]: time_convs(device, shapes, dt, "polar")
               for dt in (torch.float32, torch.bfloat16)}
    bounds = {}
    for dt in (torch.float32, torch.bfloat16):
        works = conv_works(shapes, TRAIN_BATCH, dt)
        bounds[str(dt)[6:]] = {"fwd+dx": seq_bound(works["fwd"] + works["dx"]),
                               "dk": seq_bound(works["dk"])}
    log("polar", f"bounds of one polar step's convs at B={TRAIN_BATCH} (ms, by): {bounds}")
    spec = SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP, network_input_type="polar")
    batch = synthetic_batch(2, TRAIN_BATCH, spec, device=device)
    if batch["loc_data"]["fft_data"].shape != (TRAIN_BATCH, *POLAR_SHAPE):
        raise AssertionError(f"polar batch: {tuple(batch['loc_data']['fft_data'].shape)}")
    n_chunks, bins = resample.lookup_layout(TRAIN_BATCH, cfg.model.cart_pixel_width ** 2,
                                            POLAR_SHAPE[0] + 2, POLAR_SHAPE[1])
    scratch = (TRAIN_BATCH * n_chunks * 4 * resample.CHUNK * 4 * 4
               + TRAIN_BATCH * (bins + 1) * n_chunks * 4)
    log("polar", f"the warp's lookup backward at B={TRAIN_BATCH}: "
        f"{cfg.model.cart_pixel_width ** 2} points an image on {POLAR_SHAPE[0] + 2} x "
        f"{POLAR_SHAPE[1]} (crossover rows included): {n_chunks} chunks, {bins} bins, scratch "
        f"{scratch / 2**20:.1f} MiB a call")
    out, measured = {}, {"errs": errs, "resize_rel": resize_rel, "conv_ms": conv_ms,
                         "bounds": bounds, "scratch_mib": scratch / 2**20}
    for label, dtype, lim in (("polar", "float32", 1e-4), ("polar_bf16", "bfloat16", 2e-2)):
        trainer = Trainer(polar_config(cfg, dtype), device)
        state, _, steps, snaps, counts = captured_steps(trainer, batch, label)
        state.graphs.clear()  # one polar graph at a time: each holds ~1/3 of the card
        del state
        check_replays(trainer, batch, steps, snaps, label)
        with kernels.plain_versions():
            _, loss_p, _, gnorm_p = trainer.train_step(trainer.init_state(seed=0), batch)
        loss, gnorm = steps[0][1].item(), steps[0][3].item()
        d_loss = abs(loss - loss_p.item()) / abs(loss_p.item())
        d_gnorm = abs(gnorm - gnorm_p.item()) / gnorm_p.item()
        log(label, f"step 1 kernel vs plain: loss {loss:.7g} vs {loss_p.item():.7g} (rel "
            f"{d_loss:.3e}), grad_norm {gnorm:.7g} vs {gnorm_p.item():.7g} (rel {d_gnorm:.3e})")
        if d_loss > lim or d_gnorm > lim:
            raise AssertionError(f"{label}: the polar train step differs from the plain path "
                                 f"beyond {lim} relative")
        a, b = (fresh_chain(trainer, batch) for _ in range(2))
        diff = bitwise(a, b)
        log(label, f"two chains of {TRAIN_STEPS} graph steps from one seed bitwise equal "
            f"{not diff}" + (f" (differ at {diff})" if diff else ""))
        if diff:
            raise AssertionError(f"{label}: two train chains differ")
        measured[label] = {"times": time_train(trainer, batch, label), "loss_rel": d_loss,
                           "gnorm_rel": d_gnorm}
        out[label] = counts
        del trainer, steps, snaps, a, b
    del batch
    trainer = Trainer(pcfg, device)
    params = trainer.init_state(seed=0).params
    eval_batch = synthetic_batch(1, BATCH, spec, device=device)
    out["polar_eval"], solve = run_slice(trainer, params, eval_batch, "polar_eval")
    measured["eval_times"] = time_eval(trainer, params, eval_batch, "polar_eval")
    measured["eval_solve"] = solve
    log("polar", f"phase: {time.perf_counter() - t0:.1f} s")
    return out, measured


def clouds_with_times(frames: dict, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The CLI's detector and peak extraction over stacked raw scans, with
    each point's azimuth time (``extract_pc(..., return_times=True)``):
    ((F, 4096, 3), (F, 4096)) on the device."""
    from mm_masking_tpu_torch.ops import extract_pc
    from mm_masking_tpu_torch.ops.detectors import detect

    cfg = LocalizationConfig()
    clouds, times = [], []
    with torch.no_grad():
        for s in range(0, frames["fft"].shape[0], 8):
            fft, az, azt = (torch.as_tensor(frames[k][s:s + 8], device=device)
                            for k in ("fft", "azimuths", "az_times"))
            mask = detect(cfg.detector, fft, cfg.radar_resolution, **dict(cfg.detector_kwargs))
            pc, t = extract_pc(mask, cfg.radar_resolution, az, azt, max_points=N_SCAN,
                               diff=False, return_times=True)
            clouds.append(pc)
            times.append(t)
    return torch.cat(clouds), torch.cat(times)


def odometry_pass(clouds, stamps, times=None, **cfg) -> TeachPass:
    teach = TeachPass(OdometryConfig(max_map_pts=CLI_MAP_PTS, **cfg))
    for i, c in enumerate(clouds):
        teach.process(c, stamp_us=stamps[i], times=None if times is None else times[i])
    return teach


def timed_pass(label: str, *args, **cfg) -> tuple[TeachPass, dict, float]:
    """A teach pass with the counters from 0: (pass, counters, ms a frame)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    teach = odometry_pass(*args, **cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(args[0])
    return teach, kernels.launch_counts(), ms


def hold_teach(label: str, one: TeachPass, two: TeachPass, plain: TeachPass) -> float:
    """Two passes on the kernels bitwise equal; the kernels against the plain
    path: equal keyframes, poses within 1e-4 m. Returns max |dt|."""
    T1, T2, Tp = (torch.stack(t._poses) for t in (one, two, plain))
    same = (torch.equal(one.map_pts, two.map_pts) and torch.equal(one.map_w, two.map_w)
            and torch.equal(T1, T2))
    dt = (T1[:, :3, 3] - Tp[:, :3, 3]).norm(dim=-1).max().item()
    log(label, f"two passes bitwise equal {same}; keyframes {one.n_keyframes} (plain path "
        f"{plain.n_keyframes}); max |dt| vs plain {dt:.3e} m; poses finite "
        f"{bool(torch.isfinite(T1).all())}")
    if not same:
        raise AssertionError(f"{label}: two passes on the card differ")
    if one.n_keyframes != plain.n_keyframes or dt > 1e-4 or not torch.isfinite(T1).all():
        raise AssertionError(f"{label}: the pass on the kernels differs from the plain path")
    return dt


def run_ct_ransac(device, cfg: Config, smi: str) -> tuple[dict, dict]:
    """Phases 13 and 14 on the localize phase's raw-scan tree (24 frames of
    400 x 3360, the clouds by extract_pc with their per-point times, 4096
    points, 8192 map points). ct: the continuous-time teach pass (the joint
    pose and twist solve, K1 every GN iteration) on the kernels against the
    plain path and bitwise across two passes, beside the rigid pass (K4);
    ``pose_at`` between frames; ``teach --interp-period-us 50000``. ransac:
    the teach pass with MC-RANSAC (K1's pre-association, then K4), kernels
    against plain; ``descriptor_bootstrap`` (ORB and BASD) on consecutive
    frames' 640^2 images and keypoints, its pose against the teach pass's
    relative pose, the card against the CPU. Returns ({"ct": counters,
    "ransac": counters}, measured numbers)."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rows = write_loc_tree(root)
        teach_dir = os.path.join(root, "vtr_data", "loc-teach", "radar")
        stamps = [st for st, *_ in rows["loc-teach"]]
        paths = [os.path.join(teach_dir, f"{st}.npy") for st in stamps]
        frames = localization_cli._load_radar_frames(paths)
        clouds, times = clouds_with_times(frames, device)
        log("ct", f"{len(paths)} raw scans {POLAR_SHAPE} → clouds {tuple(clouds.shape)} with "
            f"times {tuple(times.shape)} in {time.perf_counter() - t0:.1f} s")

        odometry_pass(clouds, stamps, times, continuous_time=True)  # warm-up: chunk graphs
        one, ct_counts, ct_ms = timed_pass("ct", clouds, stamps, times, continuous_time=True)
        two = odometry_pass(clouds, stamps, times, continuous_time=True)
        with kernels.plain_versions():
            plain = odometry_pass(clouds, stamps, times, continuous_time=True)
        log("ct", f"continuous-time teach pass: launches {ct_counts}; K1 "
            f"{ct_counts['nn_argmin'] / (len(paths) - 1):.1f} a frame; {ct_ms:.2f} ms a frame")
        ct_dt = hold_teach("ct", one, two, plain)
        if ct_counts["nn_argmin"] < len(paths) - 1:
            raise AssertionError(f"ct: K1 launched {ct_counts['nn_argmin']} times for "
                                 f"{len(paths) - 1} registered frames")
        odometry_pass(clouds, stamps)  # warm-up
        rigid, rigid_counts, rigid_ms = timed_pass("ct", clouds, stamps)
        T_ct, T_rigid = torch.stack(one._poses), torch.stack(rigid._poses)
        log("ct", f"rigid teach pass: launches {rigid_counts}; K4 "
            f"{rigid_counts['nn_stripe'] / (len(paths) - 1):.1f} a frame; {rigid_ms:.2f} ms a "
            f"frame; continuous-time vs rigid final pose {T_ct[-1, :2, 3].tolist()} vs "
            f"{T_rigid[-1, :2, 3].tolist()}, GT {rows['loc-teach'][-1][1:3]} (m) on {smi}")
        mids = [(a + b) // 2 for a, b in zip(stamps, stamps[1:])]
        q = torch.stack([one.pose_at(m)[0] for m in mids])
        gap = (q[:, :2, 3] - 0.5 * (T_ct[:-1, :2, 3] + T_ct[1:, :2, 3])).norm(dim=-1)
        step = (T_ct[1:, :2, 3] - T_ct[:-1, :2, 3]).norm(dim=-1).max().item()
        log("ct", f"pose_at at the {len(mids)} midpoints: max distance from the knots' "
            f"midpoint {gap.max().item():.3e} m (steps up to {step:.3f} m)")
        if not torch.isfinite(q).all() or gap.max().item() > 0.1:
            raise AssertionError("ct: pose_at between frames is not finite or leaves the path")
        traj = os.path.join(root, "odo.txt")
        argv = ["teach", "--scans", teach_dir, "--out-map", os.path.join(root, "map.npz"),
                "--out-traj", traj, "--max-map-pts", str(CLI_MAP_PTS),
                "--interp-period-us", "50000", "--device", str(device)]
        if localization_cli.main(argv) != 0:
            raise AssertionError("teach --interp-period-us failed")
        poses, q_us = gt_tools.read_traj_file(os.path.join(root, "odo_interp.txt"))
        want_n = (stamps[-1] - stamps[0]) // 50000 + 1
        log("ct", f"teach --interp-period-us 50000: {len(q_us)} poses from {q_us[0]} to "
            f"{q_us[-1]} us")
        if len(q_us) != want_n or not np.isfinite(np.stack(poses)).all():
            raise AssertionError(f"teach --interp-period-us: {len(q_us)} rows, {want_n} wanted")

        rcfg = dict(use_mcransac=True)
        odometry_pass(clouds, stamps, **rcfg)  # warm-up
        r_one, r_counts, r_ms = timed_pass("ransac", clouds, stamps, **rcfg)
        r_two = odometry_pass(clouds, stamps, **rcfg)
        with kernels.plain_versions():
            r_plain = odometry_pass(clouds, stamps, **rcfg)
        log("ransac", f"MC-RANSAC teach pass: launches {r_counts}; K1 "
            f"{r_counts['nn_argmin'] / (len(paths) - 1):.1f}, K4 "
            f"{r_counts['nn_stripe'] / (len(paths) - 1):.1f} a frame; {r_ms:.2f} ms a frame")
        r_dt = hold_teach("ransac", r_one, r_two, r_plain)
        if r_counts["nn_argmin"] < len(paths) - 1 or r_counts["nn_stripe"] < 1:
            raise AssertionError(f"ransac: K1 and K4 did not both launch: {r_counts}")

        k = 8  # pairs (frame i, frame i + 1)
        m = cfg.model
        az = torch.as_tensor(frames["azimuths"], device=device)
        imgs = radar_polar_to_cartesian(torch.as_tensor(frames["fft"], device=device), az,
                                        m.res, m.cart_resolution, m.cart_pixel_width)
        T_rel = se3_inv(T_rigid[1:k + 1]) @ T_rigid[:k]  # maps frame i's points into i + 1's
        boot = {}
        for kind in ("orb", "basd"):
            args = (imgs[:k], clouds[:k], imgs[1:k + 1], clouds[1:k + 1], m.cart_resolution)
            descriptor_bootstrap(*args, descriptor=kind)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = descriptor_bootstrap(*args, descriptor=kind)
            torch.cuda.synchronize()
            call_ms = (time.perf_counter() - t0) * 1e3
            cpu = descriptor_bootstrap(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                                       descriptor=kind)
            d_T = (res["T"].cpu() - cpu["T"]).abs().max().item()
            ok = res["match_ok"].cpu() & cpu["match_ok"]
            agree = ((res["matches"].cpu() == cpu["matches"]) & ok).sum() / max(
                1, int((res["match_ok"].cpu() | cpu["match_ok"]).sum()))
            err = (res["T"] @ se3_inv(T_rel))[:, :2, 3].norm(dim=-1)
            log("ransac", f"descriptor_bootstrap {kind}, {k} pairs of 640^2 images with {N_SCAN} "
                f"keypoints: {call_ms:.1f} ms a call; matches {res['match_ok'].sum(1).tolist()}, "
                f"inlier_frac {[round(v, 3) for v in res['inlier_frac'].tolist()]}; |dt| vs the "
                f"teach pass's relative pose {[round(v, 3) for v in err.tolist()]} m; card vs "
                f"CPU: {float(agree):.4f} of the matches agree, max|dT| {d_T:.2e}")
            # The card's sin, cos, atan2 and sums may part from the CPU's by
            # an ulp, which can flip a bit that compares two near-equal
            # samples: the matches may differ in a few places, the pose not.
            if not torch.isfinite(res["T"]).all() or agree < 0.99 or d_T > 1e-3:
                raise AssertionError(f"descriptor_bootstrap {kind}: not finite, or the card "
                                     "differs from the CPU")
            boot[kind] = {"ms": call_ms, "err_m": err.tolist()}
    return {"ct": ct_counts, "ransac": r_counts}, {
        "ct_ms": ct_ms, "rigid_ms": rigid_ms, "ransac_ms": r_ms, "ct_dt": ct_dt,
        "ransac_dt": r_dt, "bootstrap": boot}


E2E_EPOCHS = 2  # the e2e phase's epochs of the recipe at full width, one training sequence


def run_e2e(device, smi: str, keep: str) -> dict:
    """Phase 11: the product recipe (``benchmarks/e2e_product.py``'s
    ``main``) at full width in a temporary directory, with the counters from
    0: synthesis, datagen, 2 epochs of bf16 pt2pl training, the baselines;
    the summary's 16 keys present and finite, no update dropped, and K1, K2
    bf16 (forward and dx), K3 bf16 and K4 launched. Then the train step on
    the recipe's first training batch (detector-extracted clouds, map with
    normals): captured and replayed against eager steps from each replay's
    state, and against the plain path. The run's ``config.json`` and
    ``best_policy.pt`` are copied to ``keep`` (the deploy phase exports
    them). Returns the main path's counters."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--scale", "full", "--train-seqs", "1", "--epochs", str(E2E_EPOCHS),
                "--root", os.path.join(tmp, "tree"), "--run-name", "e2e_smoke",
                "--device", str(device)]
        here = os.getcwd()
        os.chdir(tmp)  # the recipe writes results/checkpoints/<run> under the cwd
        try:
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            summary, walls = e2e_product.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = kernels.launch_counts()
        finally:
            os.chdir(here)
        log("e2e", f"e2e_product.main {' '.join(argv[:-2])}: {seconds:.1f} s on {smi}; "
            f"synthesis {walls['synthesis_s']:.1f} s, datagen {walls['datagen_s']:.1f} s, fit "
            f"{walls['fit_s']:.1f} s, closing baselines {walls['baselines_s']:.1f} s; epochs' "
            f"train s {[round(t, 2) for t in walls['epochs_train_s']]}, val s "
            f"{[round(t, 2) for t in walls['epochs_val_s']]}")
        log("e2e", f"summary {json.dumps(summary)}")
        log("e2e", f"val_init_baseline {summary['val_init_baseline']!r} (the full recipe's "
            f"seeded perturbations); launches {counts}")
        if tuple(summary) != e2e_product.SUMMARY_KEYS:
            raise AssertionError(f"e2e summary keys {list(summary)}")
        if not all(math.isfinite(v) for v in summary.values() if not isinstance(v, str)):
            raise AssertionError(f"e2e summary not finite: {summary}")
        if summary["notfinite_count"] != 0 or summary["epochs"] != E2E_EPOCHS:
            raise AssertionError(f"e2e: {summary['notfinite_count']} updates dropped, "
                                 f"{summary['epochs']} epochs")
        idle = [k for k in ("nn_argmin", "nn_stripe", "conv3x3", "conv3x3_dx", "conv3x3_dk")
                if counts[k] < 1]
        if idle:
            raise AssertionError(f"e2e: kernels of the recipe's path did not launch: {idle}")
        run_dir = os.path.join(tmp, "results", "checkpoints", "e2e_smoke")
        for name in ("config.json", "best_policy.pt"):
            shutil.copy(os.path.join(run_dir, name), keep)
        metrics = os.path.join(run_dir, "run_metrics.jsonl")
        with open(metrics) as f:
            gmax = [r["grad_norm_max"] for r in map(json.loads, f) if r["event"] == "epoch"]
        log("e2e", f"grad_norm_max by epoch {gmax} (the gate's G3 limit: under 100)")
        if len(gmax) != E2E_EPOCHS or not all(g < 100.0 for g in gmax):
            raise AssertionError(f"e2e: grad_norm_max {gmax}, 100 or more (ROADMAP §3 fault 4)")

        args = e2e_product.build_parser().parse_args(argv)
        sc = dataclasses.replace(e2e_product.Scale(), epochs=E2E_EPOCHS)
        root = e2e_product.tree_root(args.root, args.scale, args.train_seqs)
        cfg = e2e_product.make_config(args, sc, root, ((e2e_product.MAP_SEQ,
                                                         e2e_product.TRAIN_SEQ),))
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, checkpoint_dir=os.path.join(tmp, "step")))
        train_ds = ICPWeightDataset(list(cfg.train_loc_pairs), cfg, "train")
        batches = epoch_batches(train_ds, cfg.train.batch_size_train, cfg, shuffle=True, seed=0,
                                device=device)
        batch = next(batches)
        batches.close()  # stops the loader's thread before the tree goes
    scan = batch["loc_data"]["raw_pc"]
    n_pts = (scan[..., :2] != 0).any(-1).sum(1).float().mean().item()
    log("e2e", f"the recipe's first training batch: {cfg.model.dtype} {cfg.model.icp_type}, "
        f"scan {tuple(scan.shape)} ({n_pts:.1f} real points a scan), map "
        f"{tuple(batch['map_data']['pc'].shape)}")
    trainer = Trainer(cfg, device)
    with torch.inference_mode():
        mask = trainer.policy.compute_mask(trainer.init_state(seed=0).params,
                                           batch["loc_data"]["fft_data"],
                                           batch["loc_data"]["fft_cfar"])
    ties = (mask >= mask.amax(dim=(1, 2), keepdim=True)).sum((1, 2))
    # ROADMAP §3 faults 1 and 4: a bf16 sigmoid took few values near its max,
    # so pixels tied there and the mask-points BCE's gradient stopped
    # cancelling; the head now sums, adds and takes its sigmoid in float32.
    log("e2e", f"the {mask.dtype} mask of a fresh bf16 UNet on this batch: "
        f"{mask.unique().numel()} distinct values, pixels at each image's max {ties.tolist()}")
    _, _, steps, snaps, _ = captured_steps(trainer, batch, "e2e")
    check_replays(trainer, batch, steps, snaps, "e2e")
    with kernels.plain_versions():
        _, loss_p, _, gnorm_p = trainer.train_step(trainer.init_state(seed=0), batch)
    loss, gnorm = steps[0][1].item(), steps[0][3].item()
    d_loss = abs(loss - loss_p.item()) / abs(loss_p.item())
    d_gnorm = abs(gnorm - gnorm_p.item()) / gnorm_p.item()
    log("e2e", f"step 1 kernel vs plain (bf16 pt2pl): loss {loss:.7g} vs {loss_p.item():.7g} "
        f"(rel {d_loss:.3e}), grad_norm {gnorm:.7g} vs {gnorm_p.item():.7g} (rel {d_gnorm:.3e})")
    # bf16: each activation is rounded to 8 bits on both paths and a sum in
    # another order can flip a rounding (tests/test_torch_gpu.py holds the
    # bf16 train step's loss to 2e-2 for that reason).
    if d_loss > 2e-2 or d_gnorm > 2e-2:
        raise AssertionError("the recipe's bf16 train step differs from the plain path beyond "
                             "loss / grad_norm 2e-2 relative")
    return counts


def free_port() -> int:
    """A free TCP port on this host, for a process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def graph_step_ms(trainer: Trainer, batch, reps: int = 6) -> tuple[list[float], float]:
    """Host-clock ms of ``reps`` graph-replayed train steps from a fresh
    state (the capture first, outside the time) and the peak device MiB
    (the graph's pool included); the graph is freed after."""
    state = trainer.init_state(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.capture_train_step(state, batch)
    times = host_ms(lambda: trainer.train_step(state, batch), reps)
    peak = torch.cuda.max_memory_allocated() / 2**20
    state.graphs.clear()
    return times, peak


def running_stats(state) -> list[torch.Tensor]:
    """Copies of the batch norm's running statistics."""
    return [v.detach().clone() for k, v in state.params.items() if "running" in k]


GLOO_STEPS = 2  # eager train steps of the two gloo ranks on the card
GLOO_LR_STEPS = 4  # parameters held to this many learning rates (the CPU tests' limit)


def _gloo_rank(rank: int, port: int, cfg: Config, out: str) -> None:
    """One of two ranks of a gloo group on the one card: ``GLOO_STEPS``
    eager train steps at B = 16 over the mesh (each rank its 8 rows), the
    counters from 0 over them; saves losses, grad_norms, ms, the final
    parameters and the counters to ``out``."""
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        trainer = Trainer(cfg, device, mesh=make_mesh(2, device))
        batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                                device=device)
        state = trainer.init_state(seed=0)
        kernels.reset_launch_counts()
        steps = []
        with kernels.eager():
            for _ in range(GLOO_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, loss, _, gnorm = trainer.train_step(state, batch)
                torch.cuda.synchronize()
                steps.append((loss.item(), gnorm.item(), 1e3 * (time.perf_counter() - t0)))
        torch.save({"steps": steps, "counts": kernels.launch_counts(),
                    "params": {k: v.detach().cpu() for k, v in state.params.items()}},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_mesh(device, cfg: Config) -> dict[str, dict]:
    """The mesh phase. (a) A NCCL group of one: the train step at B = 16,
    its gradient all-reduce and batch reductions captured in its CUDA
    graph, 3 replays (counters from 0) bitwise equal to the step without a
    mesh; both timed, graph path, in turns. The eval step at B = 32 and
    ``localize_sequence(mesh=)`` on 8 polar frames with the policy's mask,
    bitwise equal to the calls without a mesh. (b) Two processes on the one
    card over gloo, eager (gloo cannot be captured), B = 16 as 8 rows each:
    ``GLOO_STEPS`` steps against one process's eager steps: losses within
    the CPU tests' 1e-5 relative and parameters within their 4 learning
    rates; grad_norms within 1e-3 relative. On the card the two runs'
    forwards differ in the last bits (a batch of 8 against 16 through the
    same kernels), and this gradient moves by 1e-3 of its max under a 1-ulp
    nudge of its input (the train phase's ``check_unet_gradient``); on the
    CPU, where the forwards agree bit for bit, two ranks give the one
    process's grad_norm within 1e-7. K2, K3 and K4 launched on each rank.
    No run on two
    cards takes place: the machine holds one. Returns {"mesh": (a)'s
    counters, "mesh_gloo": (b)'s, summed over the ranks}."""
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    batch32 = synthetic_batch(1, BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP), device=device)
    plain = Trainer(cfg, device)  # before the group: the trivial mesh
    want = train_chain(plain, batch, plain.init_state(seed=0))
    params = plain.init_state(seed=0).params
    spec = SyntheticSpec(network_input_type="polar", n_scan=N_SCAN, n_map=N_MAP)
    frames_b = synthetic_batch(3, 8, spec, device=device)
    frames = {"fft": frames_b["loc_data"]["fft_data"],
              "azimuths": frames_b["loc_data"]["azimuths"],
              "az_times": frames_b["loc_data"]["az_times"]}
    map_pc, T0 = frames_b["map_data"]["pc"][0], frames_b["transforms"]["T_ml_init"]
    loc_cfg = LocalizationConfig(beta=0.0)
    loc_want = localization_pipeline.localize_sequence(
        frames, map_pc, loc_cfg, T_inits=T0, batch_size=8, weight_policy=plain.policy,
        policy_variables=params)
    err_want, stats_want, _ = plain.eval_step(params, batch32)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, device_id=device)
    try:
        mesh = make_mesh(1, device)
        trainer = Trainer(cfg, device, mesh=mesh)
        state = trainer.init_state(seed=0)
        trainer.capture_train_step(state, batch)
        (graph,) = state.graphs.values()
        log("mesh", f"NCCL group of 1 ({mesh.backend}): captured the train step in "
            f"{time.perf_counter() - t0:.2f} s, group set-up included; "
            f"{sum(graph.step.launches.values())} kernel launches a replay")
        kernels.reset_launch_counts()
        got = train_chain(trainer, batch, state)
        counts = kernels.launch_counts()
        state.graphs.clear()
        diff = bitwise(got, want)
        log("mesh", f"{TRAIN_STEPS} graph steps over the mesh vs without it: bitwise equal "
            f"{not diff} ({len(got)} tensors); launches {counts}")
        if diff:
            raise AssertionError(f"the NCCL world-1 train step differs from the step without "
                                 f"a mesh at {diff}")
        turns = {"no mesh": [], "mesh": []}
        for _ in range(2):
            for name, tr in (("no mesh", plain), ("mesh", trainer)):
                turns[name] += graph_step_ms(tr, batch, reps=3)[0]
        log("mesh", "graph train step B=16, host clock: " + "; ".join(
            f"{name} {spread(t)}" for name, t in turns.items()))
        err, stats, _ = trainer.eval_step(params, batch32)
        same = torch.equal(err, err_want) and all(
            torch.equal(a, b) for a, b in zip(stats, stats_want))
        log("mesh", f"eval step B=32 over the mesh vs without it: errors and weight statistics "
            f"bitwise equal {same} ({err.tolist()})")
        loc = localization_pipeline.localize_sequence(
            frames, map_pc, loc_cfg, T_inits=T0, batch_size=8, mesh=mesh,
            weight_policy=trainer.policy, policy_variables=params)
        loc_same = all(torch.equal(loc[k], loc_want[k]) for k in loc_want)
        log("mesh", f"localize_sequence(mesh=) on 8 polar frames with the mask vs without a "
            f"mesh: bitwise equal {loc_same}")
        if not (same and loc_same):
            raise AssertionError("the eval step or localize_sequence differs over the mesh")
    finally:
        dist.destroy_process_group()
    del trainer, state, got, want

    # (b) two gloo ranks on the one card, eager, against one process's eager steps.
    with kernels.eager():
        ref_state = plain.init_state(seed=0)
        ref = [plain.train_step(ref_state, batch) for _ in range(GLOO_STEPS)]
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(_gloo_rank, args=(free_port(), cfg, tmp), nprocs=2, join=True,
                           start_method="spawn")
        seconds = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
    lr = cfg.train.learning_rate
    worst = {"loss": 0.0, "grad_norm": 0.0, "param": 0.0}
    for rank in ranks:
        for (loss, gnorm, _), (_, loss_1, _, gnorm_1) in zip(rank["steps"], ref):
            worst["loss"] = max(worst["loss"], abs(loss - loss_1.item()) / abs(loss_1.item()))
            worst["grad_norm"] = max(worst["grad_norm"],
                                     abs(gnorm - gnorm_1.item()) / gnorm_1.item())
        worst["param"] = max(worst["param"], max(
            (rank["params"][k] - v.detach().cpu()).abs().max().item()
            for k, v in ref_state.params.items()))
    same_ranks = all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
                     for k in ranks[0]["params"])
    log("mesh_gloo", f"2 gloo ranks on one card, {GLOO_STEPS} eager steps of 8 rows each, "
        f"{seconds:.1f} s with the processes' start: ms a step rank 0 "
        f"{[round(t, 1) for *_, t in ranks[0]['steps']]}, rank 1 "
        f"{[round(t, 1) for *_, t in ranks[1]['steps']]}; vs one process: loss rel "
        f"{worst['loss']:.3e}, grad_norm rel {worst['grad_norm']:.3e}, parameters max |d| "
        f"{worst['param']:.3e} (limit {GLOO_LR_STEPS} x lr = {GLOO_LR_STEPS * lr:.1e}); ranks' "
        f"parameters bitwise equal {same_ranks}")
    for r, rank in enumerate(ranks):
        idle = [k for k in ("conv3x3", "conv3x3_dk", "nn_stripe") if rank["counts"][k] < 1]
        log("mesh_gloo", f"rank {r} launches {rank['counts']}")
        if idle:
            raise AssertionError(f"gloo rank {r}: kernels that did not launch: {idle}")
    if (worst["loss"] > 1e-5 or worst["grad_norm"] > 1e-3
            or worst["param"] > GLOO_LR_STEPS * lr or not same_ranks):
        raise AssertionError("two gloo ranks differ from one process beyond loss 1e-5, "
                             "grad_norm 1e-3 relative, parameters 4 learning rates")
    gloo = {k: ranks[0]["counts"][k] + ranks[1]["counts"][k] for k in counts}
    return {"mesh": counts, "mesh_gloo": gloo}


def run_bn(device, cfg: Config) -> dict[str, dict]:
    """The bn phase: ``model.batch_norm=True`` at full width, B = 16, in
    float32 and bfloat16: the train step captured (the running statistics
    updated in place inside the graph), 3 replays with the counters from 0,
    each against an eager kernel-path step from its state (the train
    phase's limits); two graph chains of 3 steps bitwise equal, running
    statistics included, and the eager chain's statistics logged against
    them; the graph step's ms and peak MiB beside the same step without
    batch norm. Returns {label: the replays' counters}."""
    batch = synthetic_batch(2, TRAIN_BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    out = {}
    for label, dtype in (("bn", "float32"), ("bn_bf16", "bfloat16")):
        base = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
        trainer = Trainer(dataclasses.replace(base, model=dataclasses.replace(
            base.model, batch_norm=True)), device)
        stats0 = running_stats(trainer.init_state(seed=0))
        state, _, steps, snaps, counts = captured_steps(trainer, batch, label)
        stats = running_stats(state)
        moved = min((a - b).abs().max().item() for a, b in zip(stats, stats0))
        if not (moved > 0 and all(torch.isfinite(t).all() for t in stats)):
            raise AssertionError(f"{label}: running statistics not updated in the graph")
        state.graphs.clear()
        check_replays(trainer, batch, steps, snaps, label)
        chains = []
        for path in ("graph", "graph", "eager"):
            with PATHS[path]():
                st = trainer.init_state(seed=0)
                chains.append(train_chain(trainer, batch, st) + running_stats(st))
                st.graphs.clear()
        diff = bitwise(chains[0], chains[1])
        n = len(stats)
        d_stats = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                      for a, b in zip(chains[0][-n:], chains[2][-n:]))
        log(label, f"two graph chains of {TRAIN_STEPS} steps bitwise equal {not diff} "
            f"({len(chains[0])} tensors, {n} running statistics); eager chain's running "
            f"statistics vs the graph's: max rel {d_stats:.3e}")
        if diff:
            raise AssertionError(f"{label}: graph chains differ at {diff}")
        t_bn, peak_bn = graph_step_ms(trainer, batch)
        t_0, peak_0 = graph_step_ms(Trainer(base, device), batch)
        log(label, f"graph train step B=16 {dtype}, host clock: batch norm {spread(t_bn)}, "
            f"peak {peak_bn:.0f} MiB; without {spread(t_0)}, peak {peak_0:.0f} MiB")
        out[label] = counts
        del trainer, state, steps, snaps, chains
        gc.collect()
    return out


_DEPLOY_RUN = r"""
import json, statistics, sys, time
import numpy as np, torch
from mm_masking_tpu_torch.deploy import load_localizer, load_mask_policy
from mm_masking_tpu_torch.ops import kernels

tmp = sys.argv[1]
mask_call, mask_hdr = load_mask_policy(tmp + "/policy.mmx")
loc_call, loc_hdr = load_localizer(tmp + "/localizer.mmx")
fft, az = (torch.from_numpy(np.load(f"{tmp}/{k}.npy")).cuda() for k in ("fft", "az"))
loc = [torch.from_numpy(np.load(f"{tmp}/{k}.npy")).cuda() for k in ("pc", "map", "T0", "w")]


def ms(fn, frames):
    fn()
    out = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / frames)
    return statistics.median(out)


kernels.reset_launch_counts()
masks = [mask_call(fft[:1], az[:1]), mask_call(fft, az)]
T, ratio, ok = loc_call(*loc)
torch.cuda.synchronize()
counts = kernels.launch_counts()
np.save(tmp + "/mask1.npy", masks[0].cpu().numpy())
np.save(tmp + "/mask8.npy", masks[1].cpu().numpy())
np.save(tmp + "/T.npy", T.cpu().numpy())
np.save(tmp + "/ratio.npy", ratio.cpu().numpy())
np.save(tmp + "/ok.npy", ok.cpu().numpy())
print(json.dumps({"counts": counts,
                  "custom_ops": [mask_hdr["custom_ops"], loc_hdr["custom_ops"]],
                  "mask_ms": ms(lambda: mask_call(fft, az), 8),
                  "loc_ms": ms(lambda: loc_call(*loc), 8)}))
"""


# The exported localizer's refined iterations: torch.export traces each one
# (about 4 s an iteration on the H100 machine's host, with a symbolic batch),
# so the phase exports 10 of the default 50.
DEPLOY_REFINED_ITERS = 10


def run_deploy(device, run_dir: str, smi: str) -> dict:
    """The deploy phase: the e2e phase's run (bf16, 400 x 3360 polar scans
    → 640^2 mask) exported on the card, and the localizer at N = 4096, M =
    16384 with a symbolic batch (``DEPLOY_REFINED_ITERS`` refined
    iterations); both loaded in a fresh process, which
    runs the mask at B = 1 and B = 8 of polar frames and the localizer at
    B = 8 with the counters from 0: each bitwise equal to the direct call
    in this process (``mask_for_scan``, ``localize_clouds``), K2 (bf16) and
    K1 launched. The export seconds and ms a frame, artifact against
    direct, logged. Returns the loaded artifacts' counters."""
    spec = SyntheticSpec(network_input_type="polar", n_scan=N_SCAN, n_map=N_MAP)
    b = synthetic_batch(4, 8, spec, device=device)
    fft, az = b["loc_data"]["fft_data"], b["loc_data"]["azimuths"]
    pc = b["loc_data"]["filtered_pc"][..., :3].contiguous()
    w = (~((pc[..., 0] == 0.0) & (pc[..., 1] == 0.0))).float()
    loc = (pc, b["map_data"]["pc"], b["transforms"]["T_ml_init"], w)
    loc_cfg = LocalizationConfig(beta=0.0, refined_max_iter=DEPLOY_REFINED_ITERS)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        payload, header = export_from_run_dir(run_dir, platforms=["cuda"])
        mask_s = time.perf_counter() - t0
        write_artifact(os.path.join(tmp, "policy.mmx"), payload, header)
        t0 = time.perf_counter()
        lpayload, lheader = export_localizer(loc_cfg, n_points=N_SCAN, n_map=N_MAP,
                                             platforms=["cuda"])
        loc_s = time.perf_counter() - t0
        write_artifact(os.path.join(tmp, "localizer.mmx"), lpayload, lheader)
        log("deploy", f"exported the e2e run's mask policy ({header['custom_ops']}, "
            f"{len(payload) / 1e6:.2f} MB) in {mask_s:.1f} s and the localizer "
            f"({lheader['custom_ops']}, {len(lpayload) / 1e6:.2f} MB) in {loc_s:.1f} s")
        for name, t in (("fft", fft), ("az", az), ("pc", loc[0]), ("map", loc[1]),
                        ("T0", loc[2]), ("w", loc[3])):
            np.save(os.path.join(tmp, f"{name}.npy"), t.cpu().numpy())
        run = subprocess.run([sys.executable, "-c", _DEPLOY_RUN, tmp], capture_output=True,
                             text=True, timeout=600)
        if run.returncode != 0:
            raise AssertionError(f"the artifacts' process failed:\n{run.stderr[-4000:]}")
        res = json.loads(run.stdout.strip().splitlines()[-1])
        got = {k: np.load(os.path.join(tmp, f"{k}.npy"))
               for k in ("mask1", "mask8", "T", "ratio", "ok")}
    cfg = Config.from_dict(json.load(open(os.path.join(run_dir, "config.json"))))
    policy = LearnICPWeightPolicy(cfg, device)
    params = load_policy_variables(run_dir, "best_policy", map_location=device)
    with torch.no_grad():
        want = {"mask1": policy.mask_for_scan(params, fft[:1], az[:1]),
                "mask8": policy.mask_for_scan(params, fft, az)}
    ref = localization_pipeline.localize_clouds(*loc[:3], loc_cfg, weights=loc[3])
    want.update(T=ref["T"], ratio=ref["matched_ratio"], ok=ref["ok"])
    equal = {k: bool(np.array_equal(got[k], want[k].cpu().numpy())) for k in want}
    direct_mask = statistics.median(host_ms(lambda: policy.mask_for_scan(params, fft, az))) / 8
    direct_loc = statistics.median(host_ms(
        lambda: localization_pipeline.localize_clouds(*loc[:3], loc_cfg, weights=loc[3]))) / 8
    counts = res["counts"]
    log("deploy", f"loaded in a fresh process: bitwise equal to the direct calls {equal}; "
        f"launches {counts}; ms a frame at B=8, artifact vs direct: mask "
        f"{res['mask_ms']:.3f} vs {direct_mask:.3f}, localizer {res['loc_ms']:.3f} vs "
        f"{direct_loc:.3f} (host clock, median of 3) on {smi}")
    if not all(equal.values()):
        raise AssertionError(f"the loaded artifacts differ from the direct calls: {equal}")
    if counts["conv3x3"] < 1 or counts["nn_argmin"] < 1:
        raise AssertionError("the loaded artifacts did not launch K2 and K1")
    return counts


def run_probes(device) -> tuple[dict, dict]:
    """Phase 12, the conv-probe path: the checks, then the timing with the
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
    if sys.argv[1:] == ["--time-mask"]:
        time_mask(device, info.log)
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
    del bf16_trainer, bf16_params
    refresh_counts = run_refresh(device, cfg, batch)
    del batch
    train_counts, train = run_train(device, cfg)
    bf16_counts, train_bf16 = run_train_bf16(device, cfg)
    run_determinism(device, cfg)
    t0 = time.perf_counter()
    mesh_counts = run_mesh(device, cfg)
    log("mesh", f"phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bn_counts = run_bn(device, cfg)
    log("bn", f"phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    implicit_counts = run_implicit(device, cfg)
    log("implicit", f"phase: {time.perf_counter() - t0:.1f} s")
    data_counts = run_data(device, cfg)
    t0 = time.perf_counter()
    loc_counts, loc_bf16_counts = run_localize_batch(device, cfg)
    cli_counts = run_localize_cli(device, cfg, smi)
    loc_counts = {k: loc_counts[k] + cli_counts[k] for k in loc_counts}
    log("localize", f"phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    keep = tempfile.mkdtemp()
    try:
        e2e_counts = run_e2e(device, smi, keep)
        log("e2e", f"phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        deploy_counts = run_deploy(device, keep, smi)
        log("deploy", f"phase: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    polar_counts, polar = run_polar(device, cfg)
    t0 = time.perf_counter()
    ct_counts, ct = run_ct_ransac(device, cfg, smi)
    log("ct", f"phases ct and ransac: {time.perf_counter() - t0:.1f} s")
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
              **refresh_counts, "train": train_counts, "train_bf16": bf16_counts,
              **implicit_counts, "data": data_counts, "localize": loc_counts,
              "localize_bf16": loc_bf16_counts, "e2e": e2e_counts, **polar_counts,
              **ct_counts, "probes": probe_counts, **mesh_counts, **bn_counts,
              "deploy": deploy_counts}
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
        " / ".join(f"{med(t):.1f}" for t, _ in train_bf16["times"].values()) + "; polar "
        "train_step f32 " + " / ".join(f"{med(t):.1f}" for t, _ in polar["polar"]["times"].values())
        + ", bf16 " + " / ".join(f"{med(t):.1f}" for t, _ in
                                 polar["polar_bf16"]["times"].values())
        + ", polar eval_step " + " / ".join(f"{med(t):.1f}" for t in polar["eval_times"].values())
        + f"; teach ms a frame: rigid {ct['rigid_ms']:.2f}, continuous-time {ct['ct_ms']:.2f}, "
        f"MC-RANSAC {ct['ransac_ms']:.2f} on {smi}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
