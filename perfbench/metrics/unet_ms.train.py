"""Device ms of the UNet in the train step's last replay: its forward (the
step's start, the input's normalisation included, to the mask's mark) and
its backward (the gradient reaching the mask to the backward's end),
between the phase marks captured in the step's graph. None without the
card's marks."""
from perfbench import program


def read(run):
    if run.mode != "train":
        return None
    return program.phases_sum(("unet.fwd", "unet.bwd"))
