"""Build the CUDA kernels with ``nvcc`` into one shared library and bind it.

The sources under ``mm_masking_tpu_torch/csrc/`` have a plain C interface
(pointers, ints and the stream), so they compile in seconds without
PyTorch's headers and load through ``ctypes``. The library is built at
first use into ``build/kernels/`` at the root of the checkout, under a name
that hashes the sources, their headers (``*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one loads the existing
file. Each source compiles in its own ``nvcc`` process, all started
together, and one more call links them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SMEM_LIMIT = 232_448  # shared bytes a block may opt into on the H100

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # x, w, bias, y, B, Ci, Co, H, W, relu, stream (f32: conv3x3_tc.cu,
    # bf16: conv3x3_bf16_tc.cu)
    "mm_conv3x3_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mm_conv3x3_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, dy, partial, dk, B, Ci, Co, H, W, n_chunks, stream (f32:
    # conv3x3_dk_tf32_tc.cu, bf16: conv3x3_dk_tc.cu)
    "mm_conv3x3_dk_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mm_conv3x3_dk_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # p, q4, start_blk, nblk, B, N, M, rows, tm, span, idx, d2, scratch, stream
    "mm_nn_argmin": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # xp, kmat, y, B, H, Ci, Co, W, TH, Wt, variant, relu, vec, stream
    "mm_probe_nhcw_f32": [_P, _P, _P] + [_I] * 10 + [_P],
    # x, packed bf16 weights, y, B, H, Ci, Co, W, TH, Wt, variant, padded,
    # relu, vec, stream (P1's body and P2's variants in bf16 on the tensor
    # cores)
    "mm_probe_nhcw_mma_bf16": [_P, _P, _P] + [_I] * 11 + [_P],
    # x, kmat, y, B, H, Ci, Co, W, TH, Wt, G, relu, vec, stream (f32); x,
    # packed bf16 weights, y, …, vec, ring, stream (bf16)
    "mm_probe_halo_f32": [_P, _P, _P] + [_I] * 10 + [_P],
    "mm_probe_halo_bf16": [_P, _P, _P] + [_I] * 11 + [_P],
    # x, kmat, y, B, Ci, Co, H, W, TH, Lc, ndot, relu, vec, stream (f32); x,
    # packed bf16 weights, y, B, Ci, Co, H, W, sub-tile rows, Wt, G, ndot,
    # relu, vec, stream (bf16)
    "mm_probe_flat_f32": [_P, _P, _P] + [_I] * 10 + [_P],
    "mm_probe_flat_mma_bf16": [_P, _P, _P] + [_I] * 11 + [_P],
    # y, dy, dy_m, partial, db, B, C, H·W, dy's batch stride, n_slabs, relu,
    # stream (relu_bias_bwd.cu)
    "mm_relu_bias_bwd_f32": [_P] * 5 + [_I] * 3 + [_L, _I, _I, _P],
    "mm_relu_bias_bwd_bf16": [_P] * 5 + [_I] * 3 + [_L, _I, _I, _P],
    # dy, w0, w1, off, dx, outer, n_in, n_out, inner, stream (resize_bwd.cu)
    "mm_resize_bwd_f32": [_P] * 5 + [_I] * 4 + [_P],
    "mm_resize_bwd_bf16": [_P] * 5 + [_I] * 4 + [_P],
    # dout, coords, dimage, lists, starts, N, P, H, W, align_corners, stream
    # (bilinear_points_bwd.cu)
    "mm_bilinear_points_bwd_f32": [_P] * 5 + [_I] * 5 + [_P],
    "mm_bilinear_points_bwd_bf16": [_P] * 5 + [_I] * 5 + [_P],
}
# Host-side functions of the sources: name → (argument types, result type).
_HOST = {
    "mm_error_string": ([_I], ctypes.c_char_p),
    # B, Ci, Co, H, W → K3's spatial chunks (f32, bf16)
    "mm_conv3x3_dk_chunks": ([_I] * 5, _I),
    "mm_conv3x3_dk_bf16_chunks": ([_I] * 5, _I),
    # Ci, Co → shared bytes of one block of K3's kernel (f32, bf16)
    "mm_conv3x3_dk_f32_smem_bytes": ([_I] * 2, ctypes.c_size_t),
    "mm_conv3x3_dk_bf16_smem_bytes": ([_I] * 2, ctypes.c_size_t),
    # B, C, H·W → slabs a channel of the conv backward's mask and bias sum
    "mm_relu_bias_bwd_slabs": ([_I] * 3, _I),
    # Co, W → shared bytes of one block of the f32 conv (K2)
    "mm_conv3x3_f32_smem_bytes": ([_I] * 2, ctypes.c_size_t),
    # Ci, Co → shared bytes of one block of the bf16 conv (K2)
    "mm_conv3x3_bf16_smem_bytes": ([_I] * 2, ctypes.c_size_t),
    # Shared bytes of one probe block: (variant, Ci, Co, TH, Wt, elem),
    # (Ci, Co, TH, Wt, elem) and (Ci, Co, W, rows, tile, elem).
    "mm_probe_nhcw_smem_bytes": ([_I] * 6, ctypes.c_size_t),
    "mm_probe_halo_smem_bytes": ([_I] * 5, ctypes.c_size_t),
    "mm_probe_flat_smem_bytes": ([_I] * 6, ctypes.c_size_t),
    # int[3] ← the lookup backward's bin rows, bin columns and points a chunk
    "mm_bilinear_points_layout": ([ctypes.POINTER(ctypes.c_int)], None),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an existing build was loaded
    log: str  # nvcc's output (ptxas register and spill report)


_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def build() -> BuildInfo:
    """Compile the kernels if this version of the sources is not built yet."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cu*")):  # the sources and their shared headers
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libmm_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.with_name(f"{out.stem}_{src.stem}.{os.getpid()}.o") for src in sources]
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    failed = [src.name for src, proc in zip(sources, procs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, out)
    return BuildInfo(out, time.perf_counter() - t0, log)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        entries = {**{n: (a, _I) for n, a in _SIGNATURES.items()}, **_HOST}
        for name, (argtypes, restype) in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


# Set only inside ``plain_versions()`` and ``eager()`` (comparison runs on
# the card).
PLAIN_ON_CUDA = False
EAGER_ON_CUDA = False


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs (launch the kernel), False for CPU inputs (run the
    plain version); raises for mixed or other devices, and for CUDA inputs
    on more than one card."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        cards = {t.device for t in tensors}
        if len(cards) > 1:
            raise ValueError(
                f"inputs must all be on one CUDA device, got {sorted(map(str, cards))}")
        return not PLAIN_ON_CUDA
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"inputs must all be on one CPU or CUDA device, got {kinds}")


def use_graphs(device: torch.device) -> bool:
    """True where a step is captured as a CUDA graph and replayed: on a CUDA
    device, outside ``plain_versions()`` and ``eager()``."""
    return device.type == "cuda" and not (PLAIN_ON_CUDA or EAGER_ON_CUDA)


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel entry ``name`` on ``device`` (the inputs' card, made
    current for the call) and that card's current stream; raise on a CUDA
    error."""
    lib = library()
    with torch.cuda.device(device):
        status = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        msg = lib.mm_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")
