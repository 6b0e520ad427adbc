"""The device's idle share of the traced train steps: 1 − the union of the
device operations' spans over the steps' span, both from the same trace."""
from perfbench import trace


def read(run):
    if run.mode != "train" or not run.events:
        return None
    span = trace.window_s(run.events)
    if not span or not trace.device_ops(run.events):
        return None
    return 100.0 * (1.0 - trace.busy_s(run.events) / span)
