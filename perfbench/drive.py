"""One run of one cell: set-up, the measured window, the traced steps and the
check against the reference.

Set-up builds the program's trainer for the cell's configuration, loads
weights made from the seed into its state, builds the traffic pool on the
device and warms up only the cell's own shapes:

* ``train``: the first three calls of ``Trainer.train_step`` on the pool's
  first three batches (the first captures the step's CUDA graph); the
  reference follows these three steps. The window then drives the same
  state on the next batches, the pool's batches copied into the step's
  inputs as a loader's would be, at most two steps in flight.
* ``eval``: two calls of ``Trainer.eval_step`` (the solve's chunk graphs
  captured), then a closed loop: each step is timed from the call until its
  error triple is on the host. The results of the batches drawn from the
  seed (those the window reaches) are kept for the check.

With ``trace`` the same window runs, and then a few more steps run under
``torch.profiler``; their Chrome trace gives the trace's metrics. After
that the program's state is freed and the reference checks the results.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from perfbench import cells, check, generator, trace

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "mm_masking_tpu")
CORRECT_STEPS = 3  # train steps that the reference follows
DROPOUT, SAMPLE = 4, 5  # derive_seed purposes


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""

    mode: str
    model: dict  # the configuration's model block
    batch: int  # pairs a step
    setup_s: float
    window_s: float = 0.0
    steps: int = 0
    step_s: list = dataclasses.field(default_factory=list)  # eval: each step's latency
    window_peak_bytes: int | None = None
    events: list | None = None  # the traced steps' trace events (``trace.load``)
    traced_steps: int = 0

    @property
    def pairs(self) -> int:
        return self.steps * self.batch


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN_MODULES))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Paced:
    """Keeps at most ``depth`` steps in flight on the card."""

    def __init__(self, device: torch.device, depth: int = 2):
        self.device, self.depth, self.events = device, depth, deque()

    def __call__(self) -> None:
        if self.device.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if len(self.events) > self.depth:
            self.events.popleft().synchronize()


def _profile(step, n: int, device: torch.device, path: Path) -> list[dict]:
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        for _ in range(n):
            with record_function(trace.STEP):
                step()
        _sync(device)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return trace.load(path)


def _free_program() -> None:
    """Drop what the program keeps between calls (the eval solve's captured
    chunks), then the allocator's cache."""
    icp = sys.modules.get("mm_masking_tpu_torch.dicp.icp")
    if icp is not None and hasattr(icp, "_CHUNKS"):
        icp._CHUNKS.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, trace_path: Path, log=print) -> dict:
    """One run → the result's fields (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, optionally ``breakdown``, ``numbers``: all that
    the check computed, and ``compared``: those with a limit)."""
    from mm_masking_tpu_torch.config import Config
    from mm_masking_tpu_torch.train.trainer import Trainer

    cfg_dict = cell.config["config"]
    reference = cell.reference
    reference.check_config(cfg_dict)
    model, data = cfg_dict["model"], cfg_dict["data"]
    trainer = Trainer(Config.from_dict(cfg_dict), device)
    dropout_seed = generator.derive_seed(seed, DROPOUT)
    state = trainer.init_state(seed=dropout_seed)
    log(f"trainer at {time.perf_counter() - t_start:.1f} s")
    start = reference.start_params(model, seed, device)
    shapes = {k: tuple(v.shape) for k, v in start.items()}
    have = {k: tuple(v.shape) for k, v in state.params.items()}
    if have != shapes:
        raise RuntimeError(f"the program's parameters {have} are not the reference's {shapes}")
    with torch.no_grad():
        for k, v in start.items():
            state.params[k].copy_(v)
    pool = generator.make_pool(seed, model, data, cell.batch, cell.traffic, device)
    n_pool = len(pool)
    log(f"pool: {n_pool} batches of {cell.batch} at {time.perf_counter() - t_start:.1f} s")

    kept: dict = {}
    if cell.mode == "train":
        names = {id(t): k for k, t in state.params.items()}
        losses, first_moment = [], None
        for k in range(CORRECT_STEPS):
            state, loss, _, _ = trainer.train_step(state, pool[k])
            losses.append(loss)
            if k == 0:
                first_moment = {names[id(p)]: m.detach().clone()
                                for p, m in zip(state.opt.params, state.opt.moments[0])}
        kept = {"losses": [float(x) for x in losses],
                "first": check.first_gradient(first_moment),
                "after": {k: v.detach().clone() for k, v in state.params.items()}}
        at = [CORRECT_STEPS]
        paced = _Paced(device)

        def step():
            trainer.train_step(state, pool[at[0] % n_pool])
            at[0] += 1
            paced()
    else:
        params = {k: v.detach() for k, v in state.params.items()}
        for k in range(min(2, n_pool)):
            float(trainer.eval_step(params, pool[k])[0][0])
        sample = set(np.random.default_rng(generator.derive_seed(seed, SAMPLE)).choice(
            n_pool, size=min(cell.traffic["check_batches"], n_pool), replace=False).tolist())
        results: dict = {}
        at = [0]
        latencies: list[float] = []
        failed = [0]

        def step():
            i = at[0] % n_pool
            t0 = time.perf_counter()
            err, _, mask = trainer.eval_step(params, pool[i])
            err = err.cpu()
            latencies.append(time.perf_counter() - t0)
            failed[0] += not bool(torch.isfinite(err).all())
            if i in sample:
                results[i] = (err, mask)
            at[0] += 1

    _sync(device)
    run = Run(mode=cell.mode, model=model, batch=cell.batch,
              setup_s=time.perf_counter() - t_start)
    log(f"set-up {run.setup_s:.2f} s")

    notfinite0 = int(state.opt.total_notfinite) if cell.mode == "train" else 0
    t0 = time.perf_counter()
    while True:
        step()
        run.steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    run.window_s = time.perf_counter() - t0
    if cell.mode == "eval":
        run.step_s = list(latencies)
        n_failed = failed[0]
    else:
        n_failed = int(state.opt.total_notfinite) - notfinite0
    if device.type == "cuda":
        run.window_peak_bytes = torch.cuda.max_memory_allocated(device)
    log(f"window: {run.steps} steps in {run.window_s:.3f} s")

    out_device = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": cell.chips}
    breakdown = None
    if traced:
        n = int(cell.traffic["traced_steps"])
        run.events = _profile(step, n, device, trace_path)
        run.traced_steps = n
        out_device["busy_s"] = trace.busy_s(run.events)
        out_device["window_s"] = trace.window_s(run.events)
        breakdown = trace.breakdown(run.events)
    if device.type == "cuda":
        out_device["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    else:
        out_device["memory_peak_bytes"] = None

    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"the run loaded {bad}")

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = cells.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The program's state goes before the reference runs.
    batches = pool[:CORRECT_STEPS] if cell.mode == "train" else {i: pool[i] for i in results}
    del trainer, state, pool, step
    if cell.mode == "eval":
        del params
    _free_program()
    t_ref = time.perf_counter()
    if cell.mode == "train":
        ref_losses, ref_first, ref_after = reference.train_steps(
            cfg_dict, start, batches, dropout_seed, device)
        numbers = check.train_numbers(kept["losses"], ref_losses, kept["first"], ref_first,
                                      start, kept["after"], ref_after)
    else:
        order = sorted(results)  # the sampled batches that the window reached
        numbers = check.eval_numbers([results[i] for i in order],
                                     [reference.eval_step(cfg_dict, start, batches[i])
                                      for i in order])
    _sync(device)
    log(f"reference {time.perf_counter() - t_ref:.2f} s")
    correct, compared = check.judge(numbers, cell.limits)
    correct = correct and n_failed == 0 if cell.mode == "eval" else correct
    result = {"correct": correct, "attempted": run.steps, "failed": n_failed,
              "metrics": metrics, "device": out_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["numbers"] = numbers  # every number the check computed; run.py prints `compared`
    result["compared"] = compared
    return result
