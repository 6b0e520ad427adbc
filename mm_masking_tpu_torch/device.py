"""The device an entry point runs on."""
from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device without a card raises, naming
    ``--device cpu``: the entry points never fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available; pass "
                           f"--device cpu to run on the CPU")
    return device
