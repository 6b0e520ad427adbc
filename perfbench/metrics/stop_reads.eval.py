"""Stop-test reads a step of the window (unprofiled): the host counter
``icp.stop_reads`` in the program's step records of ``Trainer.eval_step``,
each read a wait of the host for the solve's chunks so far. None where the
records hold no solve's chunks."""
from perfbench import program


def read(run):
    if run.mode != "eval":
        return None
    recs = program.window_steps(run, "eval")
    if not recs or not all("icp.chunks" in r.counts for r in recs):
        return None
    return sum(r.counts.get("icp.stop_reads", 0) for r in recs) / len(recs)
