"""The host's launch calls (kernel and CUDA graph launches) a traced eval
step: the eager UNet and lookup, the sort and the solve's chunk replays."""
from perfbench import trace


def read(run):
    if run.mode != "eval" or not run.events or not run.traced_steps:
        return None
    n = trace.host_launches(run.events)
    return n / run.traced_steps if n else None
