"""Device ms of the unrolled ICP in the train step's last replay: its
forward and its backward, between the phase marks captured in the step's
graph (``icp.fwd``: the weights' mark to the pose's; ``icp.bwd``: the
gradient reaching the pose to its reaching the weights). None without the
card's marks."""
from perfbench import program


def read(run):
    if run.mode != "train":
        return None
    return program.phases_sum(("icp.fwd", "icp.bwd"))
