"""JSONL metrics log (counterpart of ``mm_masking_tpu.train.metrics``): one
JSON object per event in ``<dir>/<run_name>_metrics.jsonl``, echoed to
stdout, and each record streamed through the optional uploader
(:mod:`mm_masking_tpu_torch.utils.upload`, a no-op without
``MM_UPLOAD_URL``). The trainer writes its image artifacts to
``<dir>/<run_name>_artifacts``. The file and its directory are created at
the first record, so a trainer that logs nothing leaves nothing behind."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping

import torch

from mm_masking_tpu_torch.utils.upload import ExperimentUploader


def _to_py(v: Any):
    if isinstance(v, torch.Tensor) and v.numel() == 1:
        return v.item()
    return v


class MetricsLogger:
    def __init__(self, directory: str, run_name: str = "run", verbose: bool = True,
                 uploader: ExperimentUploader | None = None):
        self.run_name = run_name
        self.path = os.path.join(directory, f"{run_name}_metrics.jsonl")
        self.art_dir = os.path.join(directory, f"{run_name}_artifacts")
        self.verbose = verbose
        # The default uploader reads MM_UPLOAD_URL; with it unset, a no-op.
        self.uploader = uploader if uploader is not None else ExperimentUploader()

    def log(self, event: str, payload: Mapping[str, Any]) -> None:
        rec = {"event": event, "time": time.time()}
        rec.update({k: _to_py(v) for k, v in payload.items()})
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        if self.verbose:
            short = {k: v for k, v in rec.items() if k != "time"}
            print(f"[{event}] " + json.dumps(short, default=str), flush=True)
        self.uploader.log_event(self.run_name, rec)
