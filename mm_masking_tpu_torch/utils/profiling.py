"""Profiling helpers (counterpart of ``mm_masking_tpu.utils.profiling``):
wall-clock span timing, and ``trace`` on ``torch.profiler``, which writes a
Chrome trace (``chrome://tracing``, Perfetto) of the enclosed region: the
host's ops and, on a card, its kernels."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(trace_dir: str) -> Iterator[None]:
    """Trace the enclosed region into ``<trace_dir>/trace_<ns>.json``."""
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{time.time_ns()}.json"))


class SpanTimer:
    """Named wall-clock spans with running means (per-sample metrics)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str, n_samples: int = 1) -> Iterator[None]:
        tic = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - tic
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + n_samples

    def per_sample(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def summary(self) -> dict[str, float]:
        return ({f"{k}_total_s": v for k, v in self.totals.items()}
                | {f"{k}_per_sample_s": self.per_sample(k) for k in self.totals})
