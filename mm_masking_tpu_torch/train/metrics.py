"""JSONL metrics log (counterpart of ``mm_masking_tpu.train.metrics``): one
JSON object per event in ``<dir>/<run_name>_metrics.jsonl``, echoed to
stdout. The file and its directory are created at the first record, so a
trainer that logs nothing leaves nothing behind."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

import torch


def _to_py(v: Any):
    if isinstance(v, torch.Tensor) and v.numel() == 1:
        return v.item()
    return v


class MetricsLogger:
    def __init__(self, directory: str, run_name: str = "run", verbose: bool = True):
        self.run_name = run_name
        self.path = os.path.join(directory, f"{run_name}_metrics.jsonl")
        self.verbose = verbose

    def log(self, event: str, payload: Mapping[str, Any]) -> None:
        rec = {"event": event, "time": time.time()}
        rec.update({k: _to_py(v) for k, v in payload.items()})
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        if self.verbose:
            short = {k: v for k, v in rec.items() if k != "time"}
            print(f"[{event}] " + json.dumps(short, default=str), flush=True)
