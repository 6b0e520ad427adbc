"""Build the CUDA kernels with ``nvcc`` into one shared library and bind it.

The sources under ``mm_masking_tpu_torch/csrc/`` have a plain C interface
(pointers, ints and the stream), so they compile in seconds without
PyTorch's headers and load through ``ctypes``. The library is built at
first use into ``build/kernels/`` at the root of the checkout, under a name
that hashes the sources and flags, so an edited source rebuilds and an
unchanged one loads the existing file.
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, w, bias, y, B, Ci, Co, H, W, relu, stream
    "mm_conv3x3_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mm_conv3x3_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
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
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return BuildInfo(out, time.perf_counter() - t0, proc.stdout + proc.stderr)


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
