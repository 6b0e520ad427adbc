"""Device time a traced eval step of the nearest-neighbour kernels (K4
stripe and K1 dense, ``ops/kernels/nn_assoc.py``), by the fragment of
their name."""
from perfbench import trace

PATTERNS = ("nn_argmin",)


def read(run):
    if run.mode != "eval" or not run.events or not run.traced_steps:
        return None
    ks = trace.matching(run.events, PATTERNS)
    if not ks:
        return None
    return 1e3 * trace.kernel_seconds(ks) / run.traced_steps
