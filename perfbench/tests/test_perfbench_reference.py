"""The reference against the program, the control and the planted faults.

On the CPU at a tiny size: one train run and one eval run of the harness
give the reference's numbers from the same inputs and parameters, tight in
float32; the control (the reference one precision lower) reads above the
program; and each fault the cells can have (a step that leaves its state
unchanged, half of each batch left out, an answer altered where it is
produced) makes ``correct`` come out false through the whole run but the
look for a card. On the card (``gpu``): the control at the cells' own size
fails the cells' limits on three seeds."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import cells, check, drive, faults
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_harness import _last_line, _tiny_run_on_cpu

TRACE = Path(__file__).resolve().parents[2] / "build" / "perfbench" / "test-trace.json"
SEED = 2**31 + 101


def _run_tiny(name: str, dtype: str = "float32", seed: int = SEED) -> dict:
    c = tiny.cell(name, dtype)
    out = drive.run_cell(c, seed, 0.2, False, torch.device("cpu"), time.perf_counter(), TRACE,
                         log=lambda msg: None)
    return {k: v["value"] for k, v in out["compared"].items()}


@pytest.mark.parametrize("name", ["cart640-bf16-pt2pl.train", "cart640-bf16-pt2pl.eval",
                                  "polar3360-f32-pt2pt.train", "polar3360-f32-pt2pt.eval"])
def test_reference_computes_what_the_program_computes_in_float32(name):
    """pt2pl with the mask BCE and the point-count hinge (cartesian), pt2pt
    with the mask's polar warp, and the tolerance-stopped solve on both
    inputs: in float32 the reference follows the program to round-off."""
    numbers = _run_tiny(name)
    assert all(v < tiny.ROUND_OFF for v in numbers.values()), numbers


def test_reference_follows_the_program_in_bfloat16():
    numbers = _run_tiny("cart640-bf16-pt2pl.train", "bfloat16")
    assert numbers["loss_gap"] < 2e-2, numbers


def test_control_reads_above_the_program_in_bfloat16():
    from perfbench import calibrate

    c = tiny.cell("cart640-bf16-pt2pl.train", "bfloat16")
    sound = _run_tiny("cart640-bf16-pt2pl.train", "bfloat16")
    control = calibrate.control(c, SEED, torch.device("cpu"))
    assert control["loss_gap"] > 3 * sound["loss_gap"], (control, sound)


@pytest.mark.parametrize("name, fault", [
    (name, fault)
    for name in ("cart640-bf16-pt2pl.train", "cart640-bf16-pt2pl.eval",
                 "polar3360-f32-pt2pt.train", "polar3360-f32-pt2pt.eval")
    for fault in sorted(faults.FAULTS)
    if not (fault == "unchanged" and name.endswith(".eval"))  # an eval step has no state
])
def test_each_fault_makes_the_run_incorrect(name, fault):
    with _tiny_run_on_cpu() as run, faults.FAULTS[fault]():
        result = _last_line(run, ["--workload", name, "--seed", str(SEED), "--seconds", "0.2",
                                  "--trace", "0"])
    assert result["correct"] is False, json.dumps(result["compared"])


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_the_limits_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from perfbench import calibrate

    cell = cells.load(name["name"])
    for seed in (9001, 9002, 9003):
        numbers = calibrate.control(cell, seed, torch.device("cuda", 0))
        ok, compared = check.judge(numbers, cell.limits)
        assert not ok, compared
