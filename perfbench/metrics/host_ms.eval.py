"""Host ms a step of the window (unprofiled) that ``Trainer.eval_step``
spends other than blocked in its own device reads: each step record's host
time less its blocked time, the mean over the window. Well below the step's
latency where the host is not what holds the loop back."""
from perfbench import program


def read(run):
    if run.mode != "eval":
        return None
    recs = program.window_steps(run, "eval")
    if not recs:
        return None
    return sum(r.host_ns - r.blocked_ns for r in recs) / len(recs) / 1e6
