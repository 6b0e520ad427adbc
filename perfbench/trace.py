"""Reading the profiler's Chrome trace of the traced steps.

The events are the trace's complete events (``ph`` "X"), as dicts with
``name``, ``cat``, ``ts`` and ``dur`` (microseconds). Device operations are
the categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; the host's are
``cpu_op``, ``cuda_runtime`` and ``user_annotation``. The traced steps are
each inside a ``user_annotation`` named :data:`STEP`.
"""
from __future__ import annotations

import bisect
import json
from pathlib import Path

STEP = "perfbench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
# The port's hand-written kernels, by a fragment of their names (the
# program's kernel groups: K2 forward and dx in float32 and bfloat16, K3,
# K4 / K1, the upsample's and the lookup's backwards).
PORT_KERNELS = ("conv3x3_tf32x3", "conv3x3_mma_bf16", "conv3x3_dk", "nn_argmin",
                "resize_bwd", "bilinear_points_bwd")


def load(path: str | Path) -> list[dict]:
    with open(path) as fh:
        data = json.load(fh)
    raw = data["traceEvents"] if isinstance(data, dict) else data
    return [{"name": e.get("name", ""), "cat": e.get("cat", ""), "ts": float(e["ts"]),
             "dur": float(e.get("dur", 0.0))}
            for e in raw if e.get("ph") == "X" and "ts" in e]


def device_ops(events: list[dict]) -> list[dict]:
    return [e for e in events if e["cat"] in DEVICE_CATS]


def kernels(events: list[dict]) -> list[dict]:
    return [e for e in events if e["cat"] == "kernel"]


def matching(events: list[dict], patterns) -> list[dict]:
    """Kernels whose lower-cased name holds one of ``patterns``."""
    return [e for e in kernels(events) if any(p in e["name"].lower() for p in patterns)]


def steps(events: list[dict]) -> list[dict]:
    return sorted((e for e in events if e["cat"] == "user_annotation" and e["name"] == STEP),
                  key=lambda e: e["ts"])


def busy_intervals(events: list[dict]) -> list[tuple[float, float]]:
    """The union of the device operations' spans, as sorted (start, end)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_ops(events))
    merged: list[list[float]] = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_s(events: list[dict]) -> float:
    return sum(b - a for a, b in busy_intervals(events)) / 1e6


def window_s(events: list[dict]) -> float | None:
    """From the first traced step's start to the end of the last step or of
    the last device operation, whichever is later."""
    st = steps(events)
    if not st:
        return None
    ends = [e["ts"] + e["dur"] for e in st] + [e["ts"] + e["dur"] for e in device_ops(events)]
    return (max(ends) - st[0]["ts"]) / 1e6


def host_launches(events: list[dict]) -> int:
    """The host's launch calls, kernels and graphs."""
    return sum(1 for e in events if e["cat"] == "cuda_runtime"
               and e["name"].startswith("cu") and "launch" in e["name"].lower())


def kernel_seconds(events: list[dict]) -> float:
    return sum(e["dur"] for e in events) / 1e6


def breakdown(events: list[dict], top: int = 10) -> dict:
    """The device operations that took most time, by name, and the longest
    idle gaps between the traced window's device operations, by the host
    operation that overlapped each gap most ("host (no traced op)" where
    none did), as [name, seconds]."""
    by_name: dict[str, float] = {}
    for e in device_ops(events):
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_intervals(events)
    st = steps(events)
    start = st[0]["ts"] if st else (busy[0][0] if busy else 0.0)
    gaps = []
    prev_end = start
    for a, b in busy:
        if a > prev_end:
            gaps.append((prev_end, a))
        prev_end = max(prev_end, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:200]
    host = sorted((e for e in events if e["cat"] in HOST_CATS), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    idle: dict[str, float] = {}
    for a, b in gaps:
        best, overlap = "host (no traced op)", 0.0
        j = bisect.bisect_left(starts, b)
        for e in host[max(0, j - 2000):j]:  # the host ops begun shortly before the gap's end
            o = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
            if o > overlap:
                best, overlap = e["name"], o
        idle[best] = idle.get(best, 0.0) + (b - a) / 1e6
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps_out]}
