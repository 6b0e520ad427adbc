"""Device time a traced train step of the kernels that are none of the
port's hand-written ones (``trace.PORT_KERNELS``): PyTorch's elementwise
ops, reductions, GEMM/GEMV, max-pool and the rest of the glue in the
models, the weight lookup, the ICP, the loss and the optimizer. None where
the port's kernels match nothing, so that a renamed kernel does not hide
in the glue."""
from perfbench import trace


def read(run):
    if run.mode != "train" or not run.events or not run.traced_steps:
        return None
    if not trace.matching(run.events, trace.PORT_KERNELS):
        return None
    glue = [e for e in trace.kernels(run.events)
            if not any(p in e["name"].lower() for p in trace.PORT_KERNELS)]
    if not glue:
        return None
    return 1e3 * trace.kernel_seconds(glue) / run.traced_steps
