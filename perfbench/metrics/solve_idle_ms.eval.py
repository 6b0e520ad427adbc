"""Device idle ms a traced step inside the program's ``mm.icp.solve``
annotations: each annotation's span less the union of the device operations
within it (clipped to it), summed over the traced steps' solves. None where
the trace holds no such annotation or no device operation."""
from perfbench import trace

SOLVE = "mm.icp.solve"


def read(run):
    if run.mode != "eval" or not run.events or not run.traced_steps:
        return None
    solves = [e for e in run.events if e["cat"] == "user_annotation" and e["name"] == SOLVE]
    busy = trace.busy_intervals(run.events)
    if not solves or not busy:
        return None
    idle = 0.0
    for s in solves:
        a, b = s["ts"], s["ts"] + s["dur"]
        idle += (b - a) - sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
    return idle / 1e3 / run.traced_steps
