"""Device timing for the port's measurement scripts, by CUDA events.

Counterpart of ``benchmarks/timing.py``. PyTorch returns before the card
finishes, so a time is taken between two events recorded on the stream and
read after the end event has completed. There is no CPU timing here: a
measurement without a card raises.
"""
from __future__ import annotations

import statistics

import torch


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() in ms, by CUDA events, after one warm-up."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times on a CUDA device, and none is available")
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


# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W): HBM
# bytes per second, and operations per second for each input type: float32
# on the CUDA cores, bfloat16 (with float32 sums) on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}


def bound_ms(ops: float, nbytes: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least time the card could take for work of ``ops`` operations on
    ``dtype`` inputs that must move ``nbytes`` (each input read once, each
    output written once): (ms, "bytes" or "operations", whichever binds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
