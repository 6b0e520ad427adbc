"""K2 (the forward and dx of every 3x3 conv) and K3 (its dk) against their
roofline in the traced train steps: the sum over the steps of each conv
launch's bound (``work.conv_bound_s``: the larger of its operations at the
tensor cores' peak and its bytes at HBM's rate, each input read once and
each output written once) over the device time of the kernels whose names
hold these fragments (the program's kernel groups for K2 and K3)."""
from perfbench import trace, work

PATTERNS = ("conv3x3_tf32x3", "conv3x3_mma_bf16", "conv3x3_dk")


def read(run):
    if run.mode != "train" or not run.events:
        return None
    ks = trace.matching(run.events, PATTERNS)
    if not ks:
        return None
    per_step = work.conv_bound_s(run.model["enc_channels"], work.input_size(run.model), run.batch,
                                 run.model["dtype"])
    bound = run.traced_steps * per_step
    return 100.0 * bound / trace.kernel_seconds(ks)
