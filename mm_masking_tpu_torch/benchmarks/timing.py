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


def graph_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() in ms, replayed from a CUDA graph: the time
    the card spends on the kernels fn launches, as a captured step runs
    them, without the host's time to launch them (which ``cuda_ms`` counts
    where the card waits for it). fn runs once on a side stream first, then
    once under capture."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_ms times on a CUDA device, and none is available")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def in_turns(plain, kernel, timer) -> tuple[float, float]:
    """(kernel, plain) times measured plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = timer(plain), timer(kernel), timer(kernel), timer(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


# The H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W): HBM
# bytes per second, and operations per second for each input type: float32
# on the CUDA cores; for matrix products (a conv is one), float32 on the
# tensor cores through 3xTF32 (three TF32 products for each float32 one, so
# 495 / 3 TFLOP/s) and bfloat16 (with float32 sums) on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12}
PEAK_MATMUL_OPS_PER_S = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}


def bound_ms(ops: float, nbytes: float, dtype: torch.dtype,
             matmul: bool = False) -> tuple[float, str]:
    """The least time the card could take for work of ``ops`` operations on
    ``dtype`` inputs that must move ``nbytes`` (each input read once, each
    output written once): (ms, "bytes" or "operations", whichever binds).
    ``matmul``: the work is a matrix product, which the tensor cores can
    take at float32 accuracy."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (PEAK_MATMUL_OPS_PER_S if matmul else PEAK_OPS_PER_S)[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
