"""CPU tests of the readers of what the program records about itself
(``perfbench/program.py`` and the metrics that use it), on synthetic runs,
step records, counters, phase marks and traces.

Run from the root of the checkout: ``python3 -m pytest perfbench/tests -q``."""
from __future__ import annotations

import types

import pytest

from perfbench import cells, drive, program
from mm_masking_tpu_torch.utils import profiling

EVAL_METRICS = ("stop_reads.eval", "stop_wait_ms.eval", "host_ms.eval", "solve_useful_pct.eval")
TRAIN_METRICS = ("icp_ms.train", "unet_ms.train")


def _run(mode, **kw):
    return drive.Run(mode=mode, model={"enc_channels": [8]}, batch=2, setup_s=1.0, **kw)


def _record(kind, id, host_ms, blocked_ms=0.0, counts=None, profiled=False):
    rec = profiling.StepRecord(kind, id, 0, profiled)
    rec.end = int(host_ms * 1e6)
    rec.blocked_ns = int(blocked_ms * 1e6)
    rec.counts = dict(counts or {})
    return rec


class _Marks:
    def __init__(self, ms, cuda=True):
        self._ms, self.cuda = ms, cuda

    def ms(self):
        return dict(self._ms)


def _program(records=(), counters=None, marks=None):
    """A stand-in for the program's tracing module."""
    tracer = types.SimpleNamespace(last=marks)
    return types.SimpleNamespace(
        steps=lambda kind=None: [r for r in records if kind is None or r.kind == kind],
        counters=lambda: dict(counters or {}), TRACER=tracer,
        phase_ms=lambda: marks.ms() if marks is not None else {})


@pytest.fixture
def fake(monkeypatch):
    def install(**kw):
        monkeypatch.setattr(program, "_profiling", lambda: _program(**kw))
    return install


def test_window_is_the_last_unprofiled_steps(fake):
    recs = ([_record("eval", i, 50.0) for i in range(2)]  # set-up
            + [_record("eval", 2 + i, 30.0, 10.0, {"icp.chunks": 3, "icp.stop_reads": 2,
                                                   "icp.stop_wait_ns": 10_000_000})
               for i in range(4)]  # the window
            + [_record("eval", 6 + i, 80.0, profiled=True) for i in range(2)])  # traced
    fake(records=recs)
    run = _run("eval", steps=4)
    assert [r.id for r in program.window_steps(run, "eval")] == [2, 3, 4, 5]
    assert cells.reader("stop_reads.eval")(run) == 2.0
    assert cells.reader("stop_wait_ms.eval")(run) == pytest.approx(10.0)
    assert cells.reader("host_ms.eval")(run) == pytest.approx(20.0)
    assert program.window_steps(_run("eval", steps=7), "eval") is None  # fewer kept
    for name in EVAL_METRICS[:3]:
        assert cells.reader(name)(_run("train", steps=4)) is None


def test_steps_without_a_solve_read_nothing(fake):
    fake(records=[_record("eval", i, 30.0) for i in range(4)])
    run = _run("eval", steps=4)
    assert cells.reader("stop_reads.eval")(run) is None
    assert cells.reader("stop_wait_ms.eval")(run) is None
    assert cells.reader("host_ms.eval")(run) == pytest.approx(30.0)


def test_ratios_read_the_counters(fake):
    fake(counters={"icp.item_iters": 300, "icp.item_slots": 400, "nn.stripe_searched": 50,
                   "nn.stripe_over": 45})
    ev, tr = _run("eval", steps=4), _run("train", steps=4)
    assert cells.reader("solve_useful_pct.eval")(ev) == pytest.approx(75.0)
    assert cells.reader("solve_useful_pct.eval")(tr) is None


@pytest.mark.parametrize("counters", [{}, {"icp.item_iters": 3, "nn.stripe_over": 2},
                                      {"icp.item_slots": 0, "nn.stripe_searched": 0},
                                      {"icp.item_steps": 9, "nn.stripe_calls": 9}])
def test_a_ratio_whose_denominator_is_zero_or_renamed_reads_none(fake, counters):
    fake(counters=counters)
    assert cells.reader("solve_useful_pct.eval")(_run("eval", steps=4)) is None


def test_train_phases_read_the_marks(fake):
    ms = {"unet.fwd": 5.0, "lookup.fwd": 1.0, "icp.fwd": 3.0, "loss.fwd": 0.5, "loss.bwd": 0.5,
          "icp.bwd": 4.0, "lookup.bwd": 1.0, "unet.bwd": 12.0, "optim": 2.0}
    fake(marks=_Marks(ms))
    tr = _run("train", steps=4)
    assert cells.reader("icp_ms.train")(tr) == pytest.approx(7.0)
    assert cells.reader("unet_ms.train")(tr) == pytest.approx(17.0)
    assert cells.reader("icp_ms.train")(_run("eval", steps=4)) is None
    fake(marks=_Marks(ms, cuda=False))  # the host clock of a CPU step
    assert cells.reader("icp_ms.train")(tr) is None
    fake(marks=_Marks({k: v for k, v in ms.items() if k != "icp.bwd"}))
    assert cells.reader("icp_ms.train")(tr) is None
    assert cells.reader("unet_ms.train")(tr) == pytest.approx(17.0)


def test_a_program_without_the_tracing_layer_reads_none(monkeypatch):
    """The parent's program: a profiling module with none of it."""
    monkeypatch.setattr(program, "_profiling", lambda: types.SimpleNamespace())
    ev, tr = _run("eval", steps=4), _run("train", steps=4)
    for name in EVAL_METRICS:
        assert cells.reader(name)(ev) is None, name
    for name in TRAIN_METRICS:
        assert cells.reader(name)(tr) is None, name
    monkeypatch.setattr(program, "_profiling", lambda: None)
    assert all(cells.reader(n)(ev) is None for n in EVAL_METRICS)


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur)}


def test_solve_idle_is_the_span_less_the_device_ops_inside_it():
    events = [
        _ev("perfbench.step", "user_annotation", 0, 1000),
        _ev("mm.eval.step", "user_annotation", 10, 900),
        _ev("mm.icp.solve", "user_annotation", 100, 400),  # 100..500
        _ev("k1", "kernel", 50, 100),  # 50..150: 50 inside
        _ev("k2", "kernel", 120, 60),  # overlaps k1: the union counts once
        _ev("k3", "kernel", 300, 50),  # 300..350: inside
        _ev("k4", "kernel", 480, 100),  # 480..580: 20 inside
        _ev("mm.icp.solve", "user_annotation", 600, 100),  # 600..700: idle throughout
        _ev("mm.icp.solve", "gpu_user_annotation", 600, 100),  # the device's copy: not read
    ]
    run = _run("eval", steps=4, events=events, traced_steps=2)
    busy_inside = (180 - 100) + 50 + 20
    want_us = (400 - busy_inside) + 100
    assert cells.reader("solve_idle_ms.eval")(run) == pytest.approx(want_us / 1e3 / 2)
    assert cells.reader("solve_idle_ms.eval")(_run("train", events=events, traced_steps=2)) \
        is None
    no_solve = [e for e in events if e["name"] != "mm.icp.solve"]
    assert cells.reader("solve_idle_ms.eval")(_run("eval", events=no_solve,
                                                   traced_steps=2)) is None
    host_only = [e for e in events if e["cat"] != "kernel"]
    assert cells.reader("solve_idle_ms.eval")(_run("eval", events=host_only,
                                                   traced_steps=2)) is None


def test_the_program_records_what_the_readers_read():
    """The real tracing module: step records and counters in the names the
    readers use."""
    profiling.TRACER.reset()
    with profiling.step("eval"):
        profiling.count("icp.chunks", 2)
        profiling.count("icp.stop_reads")
        with profiling.blocked("mm.icp.stop_read", "icp.stop_wait_ns"):
            pass
    run = _run("eval", steps=1)
    (rec,) = program.window_steps(run, "eval")
    assert rec.counts["icp.stop_reads"] == 1 and "icp.stop_wait_ns" in rec.counts
    assert cells.reader("stop_reads.eval")(run) == 1.0
    assert cells.reader("host_ms.eval")(run) >= 0.0
    assert set(program.counters()) >= {"icp.chunks", "icp.stop_reads"}
    profiling.TRACER.reset()
