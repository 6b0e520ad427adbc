"""Host ms a step of the window (unprofiled) blocked in the stop-test reads
(``mm.icp.stop_read``: the host counter ``icp.stop_wait_ns`` in the
program's step records of ``Trainer.eval_step``). None where the records
hold no solve's chunks."""
from perfbench import program


def read(run):
    if run.mode != "eval":
        return None
    recs = program.window_steps(run, "eval")
    if not recs or not all("icp.chunks" in r.counts for r in recs):
        return None
    return sum(r.counts.get("icp.stop_wait_ns", 0) for r in recs) / len(recs) / 1e6
