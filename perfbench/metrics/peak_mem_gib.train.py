"""The process's peak of ``torch.cuda.max_memory_allocated()`` at the end
of a train cell's window, in GiB: the set-up's warm-up step and the graph's
capture hold the step's whole working set (the window's replays reuse the
graph's pool and allocate nothing new), with the state and the traffic pool
on the device."""


def read(run):
    if run.mode != "train" or run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**30
