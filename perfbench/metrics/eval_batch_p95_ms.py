"""The 95th percentile of every eval step's latency in the window, from the
call of ``Trainer.eval_step`` until its error triple is on the host (one
batch at a time), by linear interpolation between order statistics."""
import numpy as np


def read(run):
    if run.mode != "eval" or not run.step_s:
        return None
    return float(np.percentile(np.asarray(run.step_s) * 1e3, 95))
