"""Optional remote experiment upload (counterpart of
``mm_masking_tpu.utils.upload``, the reference's Neptune seam).

Every metrics record, the run's parameters and chosen files go to a remote
HTTP collector as JSON, by plain POSTs through the standard library
(``urllib``), so any collector can receive them and no vendor SDK is needed:

* the endpoint comes from ``MM_UPLOAD_URL`` (or the constructor); without
  one every method is a no-op, so a run gains no network dependency;
* a failure never reaches the caller: a dead collector costs a one-line
  warning on stderr, and after ``max_failures`` failures the uploader stops
  trying. The local JSONL log stays the record of the run.
"""
from __future__ import annotations

import base64
import json
import os
import sys
import urllib.error
import urllib.request

ENV_URL = "MM_UPLOAD_URL"


class ExperimentUploader:
    """Ships metric records and files to a remote HTTP collector.

    Each call POSTs one JSON object: ``{"run": ..., "kind": "event" |
    "params" | "file", ...}``. ``enabled`` is False when no URL is
    configured; every method is then a no-op.
    """

    def __init__(self, url: str | None = None, timeout: float = 5.0,
                 max_failures: int = 3):
        self.url = url or os.environ.get(ENV_URL) or None
        self.timeout = timeout
        self.max_failures = max_failures
        self._failures = 0

    @property
    def enabled(self) -> bool:
        return self.url is not None and self._failures < self.max_failures

    def _post(self, payload: dict) -> bool:
        if not self.enabled:
            return False
        data = json.dumps(payload, default=str).encode()
        req = urllib.request.Request(self.url, data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                resp.read()
            return True
        except (urllib.error.URLError, OSError) as e:  # degrade, never raise
            self._failures += 1
            print(f"[upload] POST failed ({e}); "
                  f"{self.max_failures - self._failures} retries left", file=sys.stderr)
            return False

    def log_params(self, run: str, params: dict) -> bool:
        """The run's parameters, once at its start."""
        return self._post({"run": run, "kind": "params", "params": params})

    def log_event(self, run: str, record: dict) -> bool:
        """One metrics record (the JSONL row, already JSON-serialisable)."""
        return self._post({"run": run, "kind": "event", "record": record})

    def upload_file(self, run: str, path: str) -> bool:
        """One artifact file, base64-wrapped so that binary checkpoints and
        images survive JSON."""
        try:
            with open(path, "rb") as fh:
                blob = base64.b64encode(fh.read()).decode()
        except OSError as e:
            print(f"[upload] cannot read {path}: {e}", file=sys.stderr)
            return False
        return self._post({"run": run, "kind": "file", "name": os.path.basename(path),
                           "data": blob})

    def upload_dir(self, run: str, directory: str) -> int:
        """Every regular file directly under ``directory``, in name order;
        returns the number shipped."""
        if not self.enabled:
            return 0
        n = 0
        for name in sorted(os.listdir(directory)):
            p = os.path.join(directory, name)
            if os.path.isfile(p) and self.upload_file(run, p):
                n += 1
        return n
