"""Scan–map pairs trained in the window over its host-clock seconds; the
window ends with a synchronise."""


def read(run):
    if run.mode != "train" or run.window_s <= 0:
        return None
    return run.pairs / run.window_s
