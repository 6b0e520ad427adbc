"""The conv-probe path: ``python -m mm_masking_tpu_torch.benchmarks.probe_conv
--probe {1,2,3,4,all}``.

Counterpart of the ``main`` / ``check_correctness`` / ``time_chip`` of
``benchmarks/probe_pallas_conv.py`` … ``probe_pallas_conv4.py``: four ways
to lay out a 3×3 SAME conv, P1–P4 (``ops/kernels/conv_probes.py``). On the
card (the default; it raises without one) it

1. checks each probe kernel, and each of P2's variants, against its plain
   version and the conv against ``F.conv2d`` in float32 (TF32 off): at the
   probe's own check shapes in float32, then at the canonical low-channel
   stage (B = 16, 640², 16 → 16) in float32 and in bfloat16. Limits: 1e-4 of
   max |y| in float32 (the same sums in another order), 1e-2 in bfloat16
   (one rounding of the output to 8 bits); P2's ``asm-only`` is a copy and
   must match bit for bit; ``dot-only``'s value is undefined, so only its
   shape and type are checked;
2. times each at the probe's own timing shapes (B = 16, bfloat16) in turns
   plain, kernel, kernel, plain, beside ``F.conv2d`` on the same data in
   NCHW bfloat16 (cuDNN: the library call, the counterpart of the probes'
   "xla" column) and K2 (``conv3x3_forward`` with a zero bias), with the
   rate 2·9·Ci·Co·B·H·W / time (0 for ``asm-only``, which contracts
   nothing) and the share of the bound (``timing.bound_ms``). Each timed
   kernel output is held against the timed plain output with the limits
   of 1., since the tile the host picks depends on the shape.

``--device cpu`` runs the checks with the plain versions only (against
``F.conv2d``) and prints "not measured" where a time would go.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess

import torch
import torch.nn.functional as F

from mm_masking_tpu_torch.benchmarks.timing import bound_ms, cuda_ms, in_turns
from mm_masking_tpu_torch.device import resolve_device
from mm_masking_tpu_torch.ops.kernels import conv_probes as cp
from mm_masking_tpu_torch.ops.kernels.conv2d import conv3x3_forward

PROBES = ("P1", "P2", "P3", "P4")
TIME_BATCH = 16


@dataclasses.dataclass(frozen=True)
class Case:
    """One probe call: B, H, W, Ci, Co, the row tile and the probe's options."""
    probe: str
    B: int
    H: int
    W: int
    Ci: int
    Co: int
    TH: int
    variant: str = "full"  # P2
    ndot: int = 1  # P4
    relu: bool = False  # P1, P3, P4

    @property
    def label(self) -> str:
        opt = {"P2": f" {self.variant}", "P4": f" ndot{self.ndot}"}.get(self.probe, "")
        return (f"{self.probe} B{self.B} {self.H}x{self.W} {self.Ci}->{self.Co} "
                f"TH{self.TH}{opt}{' relu' if self.relu else ''}")

    @property
    def flops(self) -> int:
        """2·9·Ci·Co per output pixel; asm-only contracts nothing."""
        return 0 if self.variant == "asm-only" else 18 * self.Ci * self.Co * self.B * self.H * self.W


def _p2(shapes):
    return [Case("P2", B, H, W, Ci, Co, TH, variant=v) for B, H, W, Ci, Co, TH in shapes
            for v in cp.VARIANTS]


# The probes' own check shapes (f32): probe_pallas_conv.py:134-135 (TH 8) and
# one ReLU case, P2 at two shapes of its one stage, probe_pallas_conv3.py:105-107,
# probe_pallas_conv4.py:131-134.
CHECKS = {
    "P1": [Case("P1", 2, 32, 256, 8, 8, 8), Case("P1", 1, 16, 128, 16, 8, 8),
           Case("P1", 2, 24, 128, 8, 16, 8), Case("P1", 1, 8, 256, 3, 8, 8),
           Case("P1", 2, 32, 256, 8, 8, 8, relu=True)],
    "P2": _p2([(1, 16, 128, 8, 8, 8), (1, 32, 128, 16, 16, 16)]),
    "P3": [Case("P3", 2, 32, 256, 8, 8, 8), Case("P3", 1, 32, 128, 16, 16, 16),
           Case("P3", 2, 24, 128, 1, 8, 8)],
    "P4": [Case("P4", 2, 32, 256, 8, 8, 8), Case("P4", 1, 32, 128, 16, 16, 16),
           Case("P4", 1, 32, 128, 16, 16, 16, ndot=3), Case("P4", 2, 24, 128, 1, 8, 8)],
}
# The canonical low-channel stage, checked at full size in f32 and bf16 on
# the card, at each probe's first timing tile.
FULL = {
    "P1": [Case("P1", TIME_BATCH, 640, 640, 16, 16, 8)],
    "P2": _p2([(TIME_BATCH, 640, 640, 16, 16, 8)]),
    "P3": [Case("P3", TIME_BATCH, 640, 640, 16, 16, 16)],
    "P4": [Case("P4", TIME_BATCH, 640, 640, 16, 16, 16)],
}
# The probes' own timing shapes (B = 16, bf16): probe_pallas_conv.py:154-157,
# probe_pallas_conv2.py:126-131, probe_pallas_conv3.py:121-124,
# probe_pallas_conv4.py:151-154.
TIMES = {
    "P1": [Case("P1", TIME_BATCH, hw, hw, ci, co, th) for hw, ci, co, th in (
        (640, 8, 8, 8), (640, 8, 16, 8), (640, 16, 16, 8), (640, 16, 16, 16),
        (640, 16, 8, 8), (320, 16, 32, 8), (320, 32, 32, 8), (640, 1, 8, 8))],
    "P2": _p2([(TIME_BATCH, 640, 640, 16, 16, th) for th in (8, 16)]),
    "P3": [Case("P3", TIME_BATCH, 640, 640, ci, co, th) for ci, co, th in (
        (16, 16, 8), (16, 16, 16), (16, 16, 32), (8, 8, 16), (8, 16, 16), (16, 8, 16),
        (1, 8, 16))],
    "P4": [Case("P4", TIME_BATCH, 640, 640, ci, co, th, ndot=nd) for ci, co, th, nd in (
        (16, 16, 16, 1), (16, 16, 16, 3), (16, 16, 32, 1), (16, 16, 64, 1), (8, 8, 16, 1),
        (8, 16, 16, 1), (1, 8, 16, 1), (16, 8, 16, 1))],
}


def inputs(case: Case, dtype: torch.dtype, device: torch.device, seed: int = 0):
    """x (B, Ci, H, W) and k HWIO (3, 3, Ci, Co), standard normal and
    0.1·standard normal as the probes draw them, made on the device."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(case.B, case.Ci, case.H, case.W, generator=g, device=device)
    k = torch.randn(3, 3, case.Ci, case.Co, generator=g, device=device) * 0.1
    return x.to(dtype), k.to(dtype)


def calls(case: Case, x: torch.Tensor, k: torch.Tensor):
    """(kernel call, plain call, output → NCHW) on x NCHW and k HWIO; the
    probe's own layout is made here, outside the calls."""
    if case.probe == "P4":
        return (lambda: cp.conv3x3_flat(x, k, case.TH, case.ndot, case.relu),
                lambda: cp.conv3x3_flat_plain(x, k, case.ndot, case.relu), lambda y: y)
    xn = x.transpose(1, 2).contiguous()  # NHCW
    if case.probe == "P2":
        xp, km = F.pad(xn, (0, 0, 0, 0, 1, 1)), cp.kmat_from_hwio(k)
        return (lambda: cp.conv3x3_nhcw_run(case.variant, xp, km, case.TH),
                lambda: cp.conv3x3_nhcw_run_plain(case.variant, xp, km),
                lambda y: y.transpose(1, 2))
    fn = cp.conv3x3_nhcw if case.probe == "P1" else cp.conv3x3_nhcw_v2
    return (lambda: fn(xn, k, case.TH, case.relu),
            lambda: cp.conv3x3_nhcw_plain(xn, k, case.relu), lambda y: y.transpose(1, 2))


def io_bytes(case: Case, dtype: torch.dtype) -> int:
    """Bytes the call must move: its input read once (P2's is padded), the
    weight, the output written once."""
    rows = case.H + 2 if case.probe == "P2" else case.H
    elem = torch.empty((), dtype=dtype).element_size()
    return elem * (case.B * case.W * (rows * case.Ci + case.H * case.Co) + 9 * case.Ci * case.Co)


def held(case: Case, x: torch.Tensor, k: torch.Tensor, got: torch.Tensor,
         want: torch.Tensor, to_nchw) -> dict:
    """The kernel's output ``got`` against the plain version's ``want`` on x,
    k, and the conv against ``F.conv2d`` in float32; raises beyond the
    limit."""
    dtype = x.dtype
    if got.shape != want.shape or got.dtype != dtype:
        raise AssertionError(f"{case.label}: {tuple(got.shape)} {got.dtype}, want "
                             f"{tuple(want.shape)} {dtype}")
    rec = {"label": case.label, "dtype": str(dtype)[6:], "abs": None, "rel": None,
           "rel_conv": None}
    if case.variant == "dot-only":  # scratch that was never written: undefined
        return rec
    if case.variant == "asm-only":  # a copy: bit for bit
        if not torch.equal(got, want):
            raise AssertionError(f"{case.label}: asm-only differs from its plain version")
        return {**rec, "abs": 0.0, "rel": 0.0}
    ref = F.conv2d(x.float(), k.permute(3, 2, 0, 1).float(), padding=1)
    ref = torch.relu(ref) if case.relu else ref
    diff = (got.float() - want.float()).abs().max().item()
    rel = diff / want.float().abs().max().item()
    rel_conv = ((to_nchw(got).float() - ref).abs().max() / ref.abs().max()).item()
    limit = 1e-4 if dtype == torch.float32 else 1e-2
    if not rel <= limit or not rel_conv <= limit:
        raise AssertionError(f"{case.label} {dtype}: {rel:.3e} of max|y| from the plain "
                             f"version, {rel_conv:.3e} from F.conv2d (limit {limit})")
    return {**rec, "abs": diff, "rel": rel, "rel_conv": rel_conv}


def check(case: Case, dtype: torch.dtype, device: torch.device) -> dict:
    """The kernel (on the CPU: the plain version) held against the plain
    version and ``F.conv2d`` (:func:`held`)."""
    x, k = inputs(case, dtype, device)
    run, plain, to_nchw = calls(case, x, k)
    return held(case, x, k, run(), plain(), to_nchw)


def time_case(case: Case, device: torch.device) -> dict:
    """Kernel and plain version in turns, their last outputs held against
    each other and ``F.conv2d`` (:func:`held`), cuDNN's conv and K2 on the
    same bf16 data in NCHW, and the bound, all in ms."""
    dtype = torch.bfloat16
    x, k = inputs(case, dtype, device, seed=1)
    run, plain, to_nchw = calls(case, x, k)
    out = {}

    def keep(key, fn):
        return lambda: out.__setitem__(key, fn())

    ms, plain_ms = in_turns(keep("plain", plain), keep("run", run), cuda_ms)
    err = held(case, x, k, out.pop("run"), out.pop("plain"), to_nchw)
    w = k.permute(3, 2, 0, 1).contiguous()
    bias = torch.zeros(case.Co, dtype=dtype, device=device)
    bound, bound_by = bound_ms(case.flops, io_bytes(case, dtype), dtype, matmul=True)
    return {"label": case.label, "ms": ms, "plain_ms": plain_ms,
            "library_ms": cuda_ms(lambda: F.conv2d(x, w, padding=1)),
            "k2_ms": cuda_ms(lambda: conv3x3_forward(x, w, bias)),
            "bound_ms": bound, "bound_by": bound_by,
            "tflops": case.flops / ms / 1e9, "rel": err["rel"], "rel_conv": err["rel_conv"]}


def check_all(probes, device: torch.device) -> list[dict]:
    """Every check of ``probes``: their check shapes in f32 and, on the card,
    the full-size stage in f32 and bf16."""
    recs = []
    for p in probes:
        jobs = [(c, torch.float32) for c in CHECKS[p]]
        if device.type == "cuda":
            jobs += [(c, dt) for c in FULL[p] for dt in (torch.float32, torch.bfloat16)]
        for case, dtype in jobs:
            rec = check(case, dtype, device)
            if rec["rel"] is None:
                what = "shape and type only (undefined value)"
            elif rec["rel_conv"] is None:
                what = "equal bit for bit to the plain version"
            else:
                what = (f"max|d| {rec['abs']:.3e}, {rec['rel']:.3e} of max|y| from the plain "
                        f"version, {rec['rel_conv']:.3e} from F.conv2d")
            print(f"check {rec['label']} {rec['dtype']}: {what}", flush=True)
            recs.append(rec)
    return recs


def time_all(probes, device: torch.device) -> list[dict]:
    """Every timing shape of ``probes`` on the card; on the CPU, nothing."""
    recs = []
    for p in probes:
        for case in TIMES[p]:
            if device.type != "cuda":
                print(f"time {case.label}: not measured (no CUDA device)", flush=True)
                continue
            r = time_case(case, device)
            agree = ("shape and type" if r["rel"] is None else
                     f"{r['rel']:.3e} of max|y| from the plain version"
                     + ("" if r["rel_conv"] is None else f", {r['rel_conv']:.3e} from F.conv2d"))
            print(f"time {r['label']} bf16: kernel {r['ms']:.3f} ms ({r['tflops']:.1f} "
                  f"TFLOP/s, {100 * r['bound_ms'] / r['ms']:.1f}% of the {r['bound_by']} "
                  f"bound {r['bound_ms']:.4f} ms) | plain {r['plain_ms']:.3f} | cuDNN "
                  f"{r['library_ms']:.3f} | K2 {r['k2_ms']:.3f} | held: {agree}", flush=True)
            recs.append(r)
    return recs


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--probe", default="all", choices=["1", "2", "3", "4", "all"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    probes = PROBES if args.probe == "all" else (f"P{args.probe}",)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)
    return {"checks": check_all(probes, device), "times": time_all(probes, device)}


if __name__ == "__main__":
    main()
