"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, for the
harness's tests: the same files, with the widths, points and batches made
small, in float32 unless asked otherwise. In float32 the reference follows
the program to round-off, so every compared number of a tiny run gets the
limit :data:`ROUND_OFF` (the cells' own limits are set at their size on the
card), and a fault shows against it."""
from __future__ import annotations

import copy

from perfbench import cells

TINY_MODEL = {"enc_channels": [4, 8], "cart_pixel_width": 64, "cart_resolution": 2.2,
              "polar_shape": [32, 128], "res": 0.6, "max_iter": 3, "inference_max_iter": 8}
ROUND_OFF = 1e-4
_load = cells.load  # the tests put cell() in its place


def cell(name: str, dtype: str = "float32") -> cells.Cell:
    c = _load(name)
    c.config = copy.deepcopy(c.config)
    cfg = c.config["config"]
    cfg["model"].update(TINY_MODEL, dtype=dtype)
    cfg["data"].update(max_loc_pts=128, max_map_pts=512)
    cfg["train"].update(batch_size_train=2, batch_size_test=2)
    c.traffic = dict(c.traffic, batches=3, traced_steps=1, check_batches=2)
    c.limits = {k: ROUND_OFF for k in c.limits}
    return c
