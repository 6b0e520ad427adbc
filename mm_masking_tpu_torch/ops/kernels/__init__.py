"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper here dispatches on the device of its input: a CPU tensor runs
the plain PyTorch version in the same module, a CUDA tensor launches the
kernel or raises. There is no fallback. :func:`plain_versions` runs the plain
versions on CUDA tensors too, for comparison runs that hold a kernel against
its reference on the card; nothing on the main path enters it.

Each wrapper counts its kernel launches in a plain integer attribute
(``conv3x3.launches`` …), read with :func:`launch_counts`. The conv's three
jobs count apart: ``conv3x3`` (K2, forward), ``conv3x3_dx`` (K2 as the
backward's dx) and ``conv3x3_dk`` (K3, the weight gradient).
"""
from __future__ import annotations

import contextlib

from mm_masking_tpu_torch.ops.kernels import _build, conv2d, nn_assoc
from mm_masking_tpu_torch.ops.kernels._build import build

_WRAPPERS = {
    "conv3x3": conv2d.conv3x3,
    "conv3x3_dx": conv2d.conv3x3_dx,
    "conv3x3_dk": conv2d.conv3x3_dk,
    "nn_stripe": nn_assoc.nn_stripe,
    "nn_argmin": nn_assoc.nn_argmin,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


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
    "build",
    "launch_counts",
    "plain_versions",
    "reset_launch_counts",
]
