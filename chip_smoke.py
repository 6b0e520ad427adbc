#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's inference path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:

1. env     torch/CUDA versions and the card's name and power limit; fails
           without a CUDA device.
2. build   compiles ``mm_masking_tpu_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernels each CUDA kernel against its plain PyTorch version at the
           slice's shapes: the 3x3 conv at every UNet stage (f32 and bf16),
           the dense NN at (4, 4096, 16384) and the stripe NN on a sorted
           synthetic map with mixed block counts, zeros included; then the
           median time of each next to its plain version at B = 32.
4. slice   ``Trainer.eval_step`` at the default ``Config()`` (full-width UNet,
           640x640, f32, pt2pt, 50-iteration stripe ICP) on a 32-item
           synthetic batch of 4096 scan and 16384 map points, with seeded
           random weights. The launch counters must show the kernels ran;
           the poses must match the same step run with the plain versions.

The last two lines are a JSON object with the kernels' launches, errors and
times, and the contract line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.geom import transform_points
from mm_masking_tpu_torch.ops import kernels
from mm_masking_tpu_torch.ops.kernels import nn_assoc
from mm_masking_tpu_torch.ops.kernels.conv2d import conv3x3, conv3x3_plain
from mm_masking_tpu_torch.train import Trainer

BATCH, N_SCAN, N_MAP = 32, 4096, 16384
CHECK_BATCH = 4  # smaller batch for the kernel-vs-plain value checks
TRIM, TILE = 5.0, 256  # ICPConfig defaults: trim_dist, nn_stripe_tile

# The two CUDA kernels: name → (source, the Pallas call it replaces, the
# wrappers that launch it). The NN kernel has two launch modes: the sorted
# stripe (K4, nn_assoc.py:358), which the slice runs every ICP iteration, and
# dense (K1, nn_assoc.py:170), the stripe dispatcher's fallback.
KERNELS = {
    "conv3x3": ("mm_masking_tpu_torch/csrc/conv3x3.cu",
                "mm_masking_tpu/ops/pallas/conv2d.py:152", ("conv3x3",)),
    "nn_argmin": ("mm_masking_tpu_torch/csrc/nn_assoc.cu",
                  "mm_masking_tpu/ops/pallas/nn_assoc.py:358", ("nn_stripe", "nn_argmin")),
}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() in ms, by CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(plain, kernel, timer) -> tuple[float, float]:
    """(kernel, plain) times measured plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = timer(plain), timer(kernel), timer(kernel), timer(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def unet_conv_shapes(enc=(8, 16, 32, 64, 128, 256), width=640, cin=1):
    """(Ci, Co, H) of the 32 3x3 convs of one UNet forward, in order."""
    shapes, skips, h = [], [], width
    for i, ch in enumerate(enc):
        skips.append((cin, h))
        shapes += [(cin, ch, h), (ch, ch, h)]
        cin = ch
        if i > 0:
            h //= 2
    for i in range(len(enc) - 1):
        feat = enc[-2 - i]
        h = skips[-1 - i][1]
        for _ in range(2):  # each decoder block is applied twice
            shapes += [(cin, feat, h), (feat, feat, h)]
            cin = 2 * feat
        cin = feat
    return shapes


def check_conv(device, shapes) -> tuple[float, float, float]:
    """Conv kernel vs plain at every UNet stage shape; returns (max f32 abs
    error, kernel ms, plain ms) with the times summed over one forward's
    convs at B = 32."""
    g = torch.Generator().manual_seed(0)
    err32 = 0.0
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
    return err32, ms, plain_ms


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
    log("kernels", f"nn_argmin B={p.shape[0]} N={p.shape[1]} M={q.shape[1]}: "
        f"kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms")
    return err, k_ms, p_ms


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
    log("kernels", f"nn_stripe: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
    return err, k_ms, p_ms


def yaw_deg(R: torch.Tensor) -> torch.Tensor:
    return torch.rad2deg(torch.atan2(R[..., 1, 0], R[..., 0, 0]))


def run_slice(device, batch, cfg: Config) -> tuple[dict, float, float]:
    trainer = Trainer(cfg, device)
    params = trainer.init_state(seed=0)
    trainer.eval_step(params, batch)  # warm-up: allocator, cuDNN plans
    torch.cuda.synchronize()

    # The main path, through the user's entry point, with counters from 0.
    kernels.reset_launch_counts()
    err, stats, mask = trainer.eval_step(params, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log("slice", f"launches {counts}")
    log("slice", f"err (norm, rot, trans) {err.tolist()} mean_num_non0 "
        f"{float(stats.mean_num_non0)} mean_w {float(stats.mean_w):.4f}")
    n_conv = len(unet_conv_shapes(cfg.model.enc_channels, cfg.model.cart_pixel_width))
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
        with kernels.plain_versions():
            ref = trainer.policy.apply(params, loc, mp, T0)
    iters = out.icp_info["iterations"]
    log("slice", f"ICP iterations {iters} (plain path {ref.icp_info['iterations']}), "
        f"NN launches {nn_launches}")
    if nn_launches < iters:
        raise AssertionError(f"{nn_launches} NN launches for {iters} ICP iterations")
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

    def step_ms(plain: bool, reps: int = 3) -> float:
        """Median host-clock ms of `reps` steps, each ending in a synchronise."""
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if plain:
                with kernels.plain_versions():
                    trainer.eval_step(params, batch)
            else:
                trainer.eval_step(params, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    k_ms, p_ms = in_turns(lambda: step_ms(True), lambda: step_ms(False), lambda f: f())
    log("slice", f"eval_step B={len(conv)} {width}^2 N={loc['raw_pc'].shape[1]} "
        f"M={mp['pc'].shape[1]}, median of 3 in turns: kernel path "
        f"{k_ms:.1f} ms, plain path {p_ms:.1f} ms")
    return counts, k_ms, p_ms


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

    cfg = Config()  # full width: enc 8…256 at 640², f32, pt2pt, refresh 0
    batch = synthetic_batch(1, BATCH, SyntheticSpec(n_scan=N_SCAN, n_map=N_MAP),
                            device=device)
    conv_err, conv_ms, conv_plain = check_conv(
        device, unet_conv_shapes(cfg.model.enc_channels, cfg.model.cart_pixel_width))
    dense = check_dense(batch)
    stripe = check_stripe(batch)
    counts, step_ms, step_plain = run_slice(device, batch, cfg)

    # The NN kernel's numbers are those of its stripe mode, the one the
    # slice launches; its dense mode was checked and timed above.
    measured = {"conv3x3": (conv_err, conv_ms, conv_plain),
                "nn_argmin": (max(stripe[0], dense[0]), stripe[1], stripe[2])}
    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(counts[w] for w in wrappers), "max_abs_err": measured[name][0],
         "ms": measured[name][1], "plain_ms": measured[name][2]}
        for name, (src, rep, wrappers) in KERNELS.items()
    ]
    idle = [r["name"] for r in rows if r["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    log("done", f"eval_step {step_ms:.1f} ms (plain {step_plain:.1f} ms) on {smi}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
