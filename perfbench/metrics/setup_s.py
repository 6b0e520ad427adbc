"""Set-up: from the start of ``run.py`` to the first timed step (loading the
program, building or loading its kernels, the weights, the traffic pool on
the device, the warm-up steps and their graph captures)."""


def read(run):
    return run.setup_s
