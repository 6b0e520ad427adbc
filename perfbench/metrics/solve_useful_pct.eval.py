"""The share of the eval solve's computed item iterations in which the item
still ran: 100 × the device counters ``icp.item_iters`` ÷ ``icp.item_slots``
(batch items × iterations computed, the iterations of a chunk after every
item stopped included), over the run. None where no slot was counted."""
from perfbench import program


def read(run):
    if run.mode != "eval":
        return None
    r = program.ratio("icp.item_iters", "icp.item_slots")
    return None if r is None else 100.0 * r
