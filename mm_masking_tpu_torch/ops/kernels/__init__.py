"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper here dispatches on the device of its input: a CPU tensor runs
the plain PyTorch version in the same module, a CUDA tensor launches the
kernel or raises. There is no fallback. :func:`plain_versions` runs the plain
versions on CUDA tensors too, for comparison runs that hold a kernel against
its reference on the card; nothing on the main path enters it. On the card
the train step and the eval solve's iterations are captured as CUDA graphs
and replayed (``mm_masking_tpu_torch.graphs``); :func:`eager` runs them
eagerly on the kernels instead, again for comparison runs only, and
:func:`plain_versions` runs eagerly too.

Each wrapper counts its kernel launches in a plain integer attribute
(``conv3x3.launches`` …), read with :func:`launch_counts`. The conv's three
jobs count apart: ``conv3x3`` (K2, forward), ``conv3x3_dx`` (K2 as the
backward's dx) and ``conv3x3_dk`` (K3, the weight gradient); its backward's
ReLU mask and bias gradient count as ``relu_bias_bwd``. The conv-probe
kernels P1–P4 count as ``conv3x3_nhcw``, ``conv3x3_nhcw_run:<variant>`` (one
counter for each of P2's five variants), ``conv3x3_nhcw_v2`` and
``conv3x3_flat``. The gather-form backwards of the upsample and the point
lookup count as ``resize_bwd`` and ``bilinear_points_bwd``. A graph replay
counts the launches its capture recorded.
"""
from __future__ import annotations

import contextlib

from mm_masking_tpu_torch.ops.kernels import _build, conv2d, conv_probes, nn_assoc, resample
from mm_masking_tpu_torch.ops.kernels._build import build, use_graphs

_WRAPPERS = {
    "conv3x3": conv2d.conv3x3,
    "conv3x3_dx": conv2d.conv3x3_dx,
    "conv3x3_dk": conv2d.conv3x3_dk,
    "relu_bias_bwd": conv2d.relu_bias_bwd,
    "nn_stripe": nn_assoc.nn_stripe,
    "nn_argmin": nn_assoc.nn_argmin,
    "conv3x3_nhcw": conv_probes.conv3x3_nhcw,
    **{f"conv3x3_nhcw_run:{v}": c for v, c in conv_probes.RUN_COUNTERS.items()},
    "conv3x3_nhcw_v2": conv_probes.conv3x3_nhcw_v2,
    "conv3x3_flat": conv_probes.conv3x3_flat,
    "resize_bwd": resample.resize_bwd,
    "bilinear_points_bwd": resample.bilinear_points_bwd,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` ({wrapper: launches}, negative to take away) to the
    counters: a graph's replay adds the launches its capture recorded."""
    for name, n in counts.items():
        _WRAPPERS[name].launches += n


@contextlib.contextmanager
def eager():
    """Run the steps eagerly on the kernels inside the block: no CUDA graph
    is captured or replayed."""
    prev = _build.EAGER_ON_CUDA
    _build.EAGER_ON_CUDA = True
    try:
        yield
    finally:
        _build.EAGER_ON_CUDA = prev


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions on CUDA tensors inside the block."""
    prev = _build.PLAIN_ON_CUDA
    _build.PLAIN_ON_CUDA = True
    try:
        yield
    finally:
        _build.PLAIN_ON_CUDA = prev


__all__ = [
    "add_launch_counts",
    "build",
    "eager",
    "launch_counts",
    "plain_versions",
    "reset_launch_counts",
    "use_graphs",
]
