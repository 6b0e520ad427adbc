"""Steps captured as CUDA graphs and replayed.

The reference compiles each step into one XLA program. On the card the
port does the same with a ``torch.cuda.CUDAGraph``: the step is warmed up
once, captured once, and then replayed, so one step costs one launch from
the host and never waits on it. The train step (``Trainer.train_step``) and
the eval solve's chunk of GN iterations (``dicp.icp``) use this. A captured
step reads and writes tensors that stay where they are between calls (its
static tensors); the caller copies new inputs into them before a replay and
copies outputs it keeps out after it.

A capture that fails raises: no step falls back to running eagerly.
``ops.kernels.eager()`` and ``ops.kernels.plain_versions()`` run the steps
eagerly, for comparison runs only; on the CPU the steps always run eagerly.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from mm_masking_tpu_torch.ops.kernels import add_launch_counts, launch_counts


class CapturedStep:
    """One call of ``fn`` (no arguments, returns its outputs) captured as a
    CUDA graph on ``device``.

    First ``fn`` runs once on a side stream, the one the capture then uses,
    so that the kernel library is loaded, each kernel's attributes are set
    and the allocator holds the step's memory; then ``undo`` (optional) puts
    back whatever that run changed. The capture records the kernels' launch counts, and every
    :meth:`replay` adds them, as the launches happen then. ``generators``
    are registered with the graph, so that each replay draws the next
    numbers from them, as an eager call would. ``pool`` shares a memory pool
    with other graphs that are never replayed at the same time.
    """

    def __init__(self, fn: Callable[[], object], device: torch.device, *,
                 undo: Callable[[], None] | None = None,
                 generators: Iterable[torch.Generator] = (), pool=None):
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)  # the warm-up's and the capture's
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        if undo is not None:
            undo()
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = launch_counts()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=side):
                self.outputs = fn()
        finally:  # the capture launched nothing
            recorded = {k: n - before[k] for k, n in launch_counts().items()}
            add_launch_counts({k: -n for k, n in recorded.items()})
        self.launches = {k: n for k, n in recorded.items() if n}

    def replay(self):
        """Launch the graph on the current stream; returns ``fn``'s outputs,
        which the next replay overwrites."""
        self.graph.replay()
        add_launch_counts(self.launches)
        return self.outputs
