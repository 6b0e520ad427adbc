"""Run artifacts as PNG images (counterpart of ``mm_masking_tpu.utils.visualize``).

The same artifact set as the JAX package, under its file names and with its
arguments: learned masks and the raw BEV / CFAR / FFT-threshold / map-BEV
masks (``save_mask_image``), the scan over the map (``save_pointclouds``),
the weighted scan (``save_weighted_scan``) and the localization error over a
trajectory with its CSV table (``save_loc_error_plots``). Each function
returns what the JAX one returns.

The JAX package draws with matplotlib, which the machines that train the
port need not have. This module writes the PNGs itself (``zlib`` and
``struct``, 8-bit grayscale or RGB) and rasterises points and polylines with
numpy on a fixed canvas, so the pixels are not matplotlib's: no axes, ticks,
legends, titles or colour bars. A mask image is the mask itself, one pixel a
cell, each image's min–max mapped to 0–255.
"""
from __future__ import annotations

import os
import os.path as osp
import struct
import zlib

import numpy as np

CANVAS = 640  # the point plots' square canvas, pixels
WHITE, BLACK, GRAY = (255, 255, 255), (0, 0, 0), (128, 128, 128)
RED, BLUE = (220, 30, 30), (30, 60, 220)


def write_png(path: str, img: np.ndarray) -> str:
    """Write an 8-bit image, (H, W) grayscale or (H, W, 3) RGB, as a PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"an image is (H, W) or (H, W, 3), not {img.shape}")
    h, w = img.shape[:2]
    color_type = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
    return path


def to_u8(x: np.ndarray) -> np.ndarray:
    """Min–max of the finite values to 0–255; non-finite values and a
    constant image map to 0."""
    x = np.asarray(x, dtype=np.float64)
    ok = np.isfinite(x)
    if not ok.any():
        return np.zeros(x.shape, np.uint8)
    lo, hi = x[ok].min(), x[ok].max()
    scaled = (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x)
    return np.where(ok, np.round(255.0 * scaled), 0.0).astype(np.uint8)


def save_mask_image(mask: np.ndarray, out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return write_png(osp.join(out_dir, f"{name}.png"), to_u8(mask))


def _canvas(color, h: int = CANVAS, w: int = CANVAS) -> np.ndarray:
    img = np.empty((h, w, 3), np.uint8)
    img[:] = color
    return img


def _pixels(xy: np.ndarray, lo: np.ndarray, span: float, size: int = CANVAS):
    """Pixel (row, col) of points on a square canvas over [lo, lo + span]²,
    x to the right and y up."""
    uv = (xy - lo) / span * (size - 1)
    col = np.clip(np.round(uv[:, 0]).astype(int), 0, size - 1)
    row = np.clip(np.round(size - 1 - uv[:, 1]).astype(int), 0, size - 1)
    return row, col


def _extent(*clouds: np.ndarray) -> tuple[np.ndarray, float]:
    """Lower corner and side of a square around the clouds, 2% margin."""
    xy = np.concatenate([c[:, :2] for c in clouds if len(c)] or [np.zeros((1, 2))])
    lo, hi = xy.min(0), xy.max(0)
    span = max(float((hi - lo).max()), 1e-6) * 1.04
    return (lo + hi) / 2 - span / 2, span


def _dot(img: np.ndarray, row, col, color, r: int = 0) -> None:
    for dr in range(-r, r + 1):
        for dc in range(-r, r + 1):
            img[np.clip(row + dr, 0, img.shape[0] - 1),
                np.clip(col + dc, 0, img.shape[1] - 1)] = color


def save_pointclouds(scan_pc: np.ndarray, map_pc: np.ndarray, out_dir: str,
                     name: str, pad_val: float = 1000.0) -> str:
    """Scan (blue) over map (red) on white, pads stripped: the reference's
    "extracted_pc" artifact."""
    os.makedirs(out_dir, exist_ok=True)
    map_pc, scan_pc = np.asarray(map_pc), np.asarray(scan_pc)
    m = map_pc[(np.abs(map_pc[:, 0]) < pad_val) & (np.abs(map_pc[:, 1]) < pad_val)]
    s = scan_pc[np.abs(scan_pc[:, 0]) > 0.05]
    lo, span = _extent(m, s)
    img = _canvas(WHITE)
    _dot(img, *_pixels(m[:, :2], lo, span), RED, r=1)
    _dot(img, *_pixels(s[:, :2], lo, span), BLUE)
    return write_png(osp.join(out_dir, f"{name}.png"), img)


def save_weighted_scan(scan_pc: np.ndarray, weights: np.ndarray, out_dir: str,
                       name: str) -> str:
    """Weighted scan on black: the used points (weight over 0.01 of the
    largest) coloured by weight from magenta (0) to yellow (1), matplotlib's
    "spring", the others gray: the reference's "weighted_pc" artifact."""
    os.makedirs(out_dir, exist_ok=True)
    scan_pc, weights = np.asarray(scan_pc), np.asarray(weights, dtype=np.float64)
    keep = np.abs(scan_pc[:, 0]) > 0.05
    pc, w = scan_pc[keep], weights[keep]
    if np.isnan(w.sum()):
        w = np.zeros_like(w)
    if len(w) and w.max() > 0:
        w = w / w.max()
    used = w > 0.01
    lo, span = _extent(pc)
    img = _canvas(BLACK)
    _dot(img, *_pixels(pc[~used, :2], lo, span), GRAY)
    row, col = _pixels(pc[used, :2], lo, span)
    t = np.clip(w[used], 0.0, 1.0)
    img[row, col] = np.stack([np.full_like(t, 255.0), 255.0 * t, 255.0 * (1.0 - t)],
                             -1).round().astype(np.uint8)
    return write_png(osp.join(out_dir, f"{name}.png"), img)


def _polyline(img: np.ndarray, x: np.ndarray, y: np.ndarray, color) -> None:
    """Segments between consecutive (x, y) pixel positions (floats)."""
    if len(x) == 1:
        _dot(img, np.round(y).astype(int), np.round(x).astype(int), color)
        return
    for x0, y0, x1, y1 in zip(x[:-1], y[:-1], x[1:], y[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 2
        t = np.linspace(0.0, 1.0, n)
        _dot(img, np.round(y0 + t * (y1 - y0)).astype(int),
             np.round(x0 + t * (x1 - x0)).astype(int), color)


def save_loc_error_plots(times_us: np.ndarray, rot_signed: np.ndarray,
                         lon: np.ndarray, lat: np.ndarray,
                         out_dir: str, seq_name: str) -> dict:
    """The signed longitudinal (m), lateral (m) and heading (deg) errors of
    each frame over the run, three stacked panels (900 × 220 pixels each,
    time to the right, a gray zero line, each panel scaled to its own
    largest |error|), and the same numbers as a CSV table.

    Returns {'png': path, 'csv': path}."""
    os.makedirs(out_dir, exist_ok=True)
    times_us = np.asarray(times_us, np.int64)
    t = (times_us - int(times_us[0])) / 1e6
    width, height, pad = 900, 220, 10
    mid = (height - 1) / 2
    x = pad + t / max(float(t[-1]), 1e-9) * (width - 1 - 2 * pad)
    panels = []
    for series in (np.asarray(lon), np.asarray(lat), np.degrees(np.asarray(rot_signed))):
        img = _canvas(WHITE, height, width)
        img[int(round(mid)), :] = (200, 200, 200)
        y = mid - series / max(float(np.abs(series).max()), 1e-9) * (mid - pad)
        _polyline(img, x, y, BLUE)
        panels.append(img)
        panels.append(_canvas(BLACK, 2, width))
    png = osp.join(out_dir, f"{seq_name}_loc_errors.png")
    write_png(png, np.concatenate(panels[:-1], axis=0))

    csv_path = osp.join(out_dir, f"{seq_name}_loc_errors.csv")
    with open(csv_path, "w") as f:
        f.write("time_us,longitudinal_m,lateral_m,heading_rad\n")
        for tu, lo, la, rr in zip(times_us, lon, lat, rot_signed):
            f.write(f"{int(tu)},{lo:.6f},{la:.6f},{rr:.6f}\n")
    return {"png": png, "csv": csv_path}
