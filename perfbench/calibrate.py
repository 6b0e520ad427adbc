"""The readings that the check's limits are set from, in one process on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 101-112 \\
        [--control-seeds 201-203] [--faults half_batch,altered --fault-seeds 301-303] \\
        [--seconds S]

* sound runs: the program's run of the cell (``drive.run_cell``, with a
  window of ``--seconds``, 0 by default: one step after set-up; an eval cell
  wants enough for every batch the check samples) on each seed, its
  compared numbers;
* the control: the reference computed in the next lower precision in the
  program's place, against the reference, on the same inputs;
* faults (``faults.py``) planted in the program, each on every fault seed.

One JSON line for each reading, then their largest (sound runs) and least
(control, each fault) by number. The limits in ``limits/<cell>.json`` are
set from these between the two, as ``PERF.md`` records.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import cells, check, drive, faults, generator  # noqa: E402


def seeds(spec: str) -> list[int]:
    out = []
    for part in filter(None, spec.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def control(cell: cells.Cell, seed: int, device: torch.device) -> dict[str, float]:
    """The lower-precision reference against the reference, on a run's inputs."""
    cfg = cell.config["config"]
    model = cfg["model"]
    reference = cell.reference
    start = reference.start_params(model, seed, device)
    pool = generator.make_pool(seed, model, cfg["data"], cell.batch, cell.traffic, device)
    if cell.mode == "train":
        dropout_seed = generator.derive_seed(seed, drive.DROPOUT)
        batches = pool[:drive.CORRECT_STEPS]
        ref = reference.train_steps(cfg, start, batches, dropout_seed, device)
        low = reference.train_steps(cfg, start, batches, dropout_seed, device, lower=True)
        return check.train_numbers(low[0], ref[0], low[1], ref[1], start, low[2], ref[2])
    rng = np.random.default_rng(generator.derive_seed(seed, drive.SAMPLE))
    sample = sorted(rng.choice(len(pool), size=min(cell.traffic["check_batches"], len(pool)),
                               replace=False).tolist())
    return check.eval_numbers([reference.eval_step(cfg, start, pool[i], lower=True)
                               for i in sample],
                              [reference.eval_step(cfg, start, pool[i]) for i in sample])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: the readings are taken on the card, and none is present")
    device = torch.device("cuda", 0)
    cell = cells.load(args.workload)
    trace_path = ROOT / "build" / "perfbench" / "calibrate-trace.json"
    readings: dict[str, list[dict]] = {}

    def record(kind: str, seed: int, numbers: dict) -> None:
        readings.setdefault(kind, []).append(numbers)
        print(json.dumps({"kind": kind, "seed": seed, **numbers}), flush=True)

    def quiet(msg: str) -> None:
        pass

    def program(seed: int) -> dict:
        out = drive.run_cell(cell, seed, args.seconds, False, device, time.perf_counter(),
                             trace_path, log=quiet)
        return out["numbers"]

    real_gaps = check.leaf_gaps

    def worst_leaves(prog, ref, keys):
        """The leaf gaps, the three widest of them printed to standard error."""
        gaps = real_gaps(prog, ref, keys)
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
        print(json.dumps({"worst_leaves": [[k, g, prog[k], ref[k]] for k, g in top]}),
              file=sys.stderr, flush=True)
        return gaps

    check.leaf_gaps = worst_leaves
    for seed in seeds(args.seeds):
        record("sound", seed, program(seed))
    for seed in seeds(args.control_seeds):
        record("control", seed, control(cell, seed, device))
    for name in filter(None, args.faults.split(",")):
        for seed in seeds(args.fault_seeds):
            with faults.FAULTS[name]():
                record(name, seed, program(seed))
    summary = {}
    for kind, rows in readings.items():
        pick = max if kind == "sound" else min
        summary[kind] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"summary": summary, "seconds": time.perf_counter() - T_START}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
