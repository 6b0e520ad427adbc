"""Build the CUDA kernels with ``nvcc`` into one shared library and bind it.

The sources under ``mm_masking_tpu_torch/csrc/`` have a plain C interface
(pointers, ints and the stream), so they compile in seconds without
PyTorch's headers and load through ``ctypes``. The library is built at
first use into ``build/kernels/`` at the root of the checkout, under a name
that hashes the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file. Each source compiles in its own
``nvcc`` process, all started together, and one more call links them.
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

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, bias, y, B, Ci, Co, H, W, relu, stream
    "mm_conv3x3_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mm_conv3x3_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, dy, partial, dk, B, Ci, Co, H, W, n_chunks, stream
    "mm_conv3x3_dk_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mm_conv3x3_dk_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # p, q4, start_blk, nblk, B, N, M, rows, tm, idx, d2, stream
    "mm_nn_argmin": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
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
    for src in sources:
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
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mm_error_string.argtypes = [ctypes.c_int]
        lib.mm_error_string.restype = ctypes.c_char_p
        lib.mm_conv3x3_dk_chunks.argtypes = [_I] * 5
        lib.mm_conv3x3_dk_chunks.restype = ctypes.c_int
        _lib = lib
    return _lib


# Set only inside ``plain_versions()`` (comparison runs on the card).
PLAIN_ON_CUDA = False


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs (launch the kernel), False for CPU inputs (run the
    plain version); raises for mixed or other devices."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return not PLAIN_ON_CUDA
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"inputs must all be on one CPU or CUDA device, got {kinds}")


def launch(name: str, *args) -> None:
    """Call kernel entry ``name`` on the current stream; raise on a CUDA error."""
    lib = library()
    status = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        msg = lib.mm_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")
