"""ctypes bindings for the native fastload library (see native/fastload.cpp).

A copy of ``mm_masking_tpu.data.native`` (numpy and the standard library
only), so that the port imports nothing of the JAX package.

Host-side decode path in C++ with a thread pool: PNG (Boreas radar scans),
Navtech frame unpack, and cloud padding. Falls back to pure numpy when the
shared object hasn't been built (``make -C native``); the numpy and native
paths are verified equal in tests.
"""
from __future__ import annotations

import ctypes
import os.path as osp

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    path = osp.join(root, "native", "libfastload.so")
    if not osp.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:  # built for another machine: the numpy decode serves
        return None
    lib.png_decode_gray8.restype = ctypes.c_int
    lib.png_decode_gray8.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.navtech_decode.restype = None
    lib.navtech_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.pad_cloud.restype = None
    lib.pad_cloud.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_float, ctypes.c_void_p,
    ]
    lib.batch_navtech_decode.restype = None
    lib.batch_navtech_decode.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def png_decode_gray8(data: bytes) -> np.ndarray:
    """8-bit grayscale PNG bytes → (H, W) uint8 array (native zlib path)."""
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("libfastload.so not built (make -C native)")
    h = ctypes.c_int32(0)
    w = ctypes.c_int32(0)
    # First call with a generous buffer; retry if undersized.
    cap = max(len(data) * 4, 1 << 22)
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        rc = lib.png_decode_gray8(
            data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap,
            ctypes.byref(h), ctypes.byref(w),
        )
        if rc == -2:
            cap = int(h.value) * int(w.value)
            continue
        if rc != 0:
            raise ValueError(f"png_decode_gray8 failed: rc={rc}")
        return out[: h.value * w.value].reshape(h.value, w.value).copy()
    raise ValueError("png_decode_gray8: buffer sizing failed")


def navtech_decode(raw: np.ndarray):
    """(H, W) uint8 raw Navtech image → (fft f32, azimuths f64, ts int64)."""
    lib = _find_lib()
    if lib is None:
        from mm_masking_tpu_torch.ops.radar import load_radar

        return load_radar(raw)
    raw = np.ascontiguousarray(raw, np.uint8)
    H, W = raw.shape
    fft = np.empty((H, W - 11), np.float32)
    az = np.empty(H, np.float64)
    ts = np.empty(H, np.int64)
    lib.navtech_decode(
        raw.ctypes.data_as(ctypes.c_void_p), H, W,
        fft.ctypes.data_as(ctypes.c_void_p),
        az.ctypes.data_as(ctypes.c_void_p),
        ts.ctypes.data_as(ctypes.c_void_p),
    )
    return fft, az, ts


def batch_navtech_decode(raws: list[np.ndarray], n_threads: int = 4):
    """Thread-pooled decode of a batch of raw scans → stacked arrays."""
    lib = _find_lib()
    if lib is None:
        outs = [navtech_decode(r) for r in raws]
        return (np.stack([o[0] for o in outs]),
                np.stack([o[1] for o in outs]),
                np.stack([o[2] for o in outs]))
    raws = [np.ascontiguousarray(r, np.uint8) for r in raws]
    B = len(raws)
    H, W = raws[0].shape
    fft = np.empty((B, H, W - 11), np.float32)
    az = np.empty((B, H), np.float64)
    ts = np.empty((B, H), np.int64)
    ptrs = (ctypes.c_void_p * B)(
        *[r.ctypes.data_as(ctypes.c_void_p).value for r in raws]
    )
    lib.batch_navtech_decode(
        ptrs, B, H, W,
        fft.ctypes.data_as(ctypes.c_void_p),
        az.ctypes.data_as(ctypes.c_void_p),
        ts.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    return fft, az, ts


def pad_cloud(src: np.ndarray, max_n: int, pad_val: float = 0.0) -> np.ndarray:
    """(n, d) → (max_n, d) padded with pad_val (native memcpy path)."""
    lib = _find_lib()
    src = np.ascontiguousarray(src, np.float32)
    n, d = src.shape
    if lib is None:
        out = np.full((max_n, d), pad_val, np.float32)
        out[: min(n, max_n)] = src[:max_n]
        return out
    out = np.empty((max_n, d), np.float32)
    lib.pad_cloud(
        src.ctypes.data_as(ctypes.c_void_p), n, max_n, d,
        ctypes.c_float(pad_val), out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
