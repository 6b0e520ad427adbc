"""Run one cell of the benchmark of ``mm_masking_tpu_torch`` once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number the check compared, with its limit. Those numbers
are also the last lines of standard error. Without a CUDA card, or with
fewer cards than the cell asks for, it exits with an error and prints no
result. Build and kernel caches stay in ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Caches at fixed places in the checkout, so that only a checkout's first run builds.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import cells, drive  # noqa: E402


def require_cards(n: int) -> torch.device:
    """The first CUDA card; raise where fewer than ``n`` are present."""
    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA device is available; the benchmark runs on "
                         "the card only")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"perfbench: the cell needs {n} CUDA devices, "
                         f"{torch.cuda.device_count()} are present")
    return torch.device("cuda", 0)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = cells.load(args.workload)
    import mm_masking_tpu_torch

    if Path(mm_masking_tpu_torch.__file__).resolve().parents[1] != ROOT:
        raise SystemExit(f"perfbench: the program is not in this checkout ({ROOT}); found "
                         f"{mm_masking_tpu_torch.__file__}")
    device = require_cards(cell.chips)
    torch.set_num_threads(4)
    card = power_limit()

    def log(msg: str) -> None:
        print(f"perfbench: {msg}", file=sys.stderr, flush=True)

    trace_path = ROOT / "build" / "perfbench" / f"trace-{cell.name}.json"
    result = drive.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START,
                            trace_path, log=log)
    del result["numbers"]
    if card is not None:
        result = {"card": card, **result}
    for name, c in result["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
