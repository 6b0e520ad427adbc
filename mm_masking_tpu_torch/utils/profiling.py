"""The port's tracing layer: host spans, counters, step records and phase
marks, and ``trace`` on ``torch.profiler``.

- **Host spans** (:func:`span`): nested, named ``mm.<layer>.<what>``, each
  with its parent, the step it belongs to and its start and end on
  ``time.perf_counter_ns()``, kept in a bounded buffer and written out by
  :func:`dump`. They are off by default, where a span site costs one test
  and returns a shared null context; they are on after :func:`enable` and
  while a ``torch.profiler`` records. Under a profiler each span is also a
  ``user_annotation`` of the profiler's Chrome trace, on the kernels' clock,
  and :func:`dump` writes its spans on that clock, so the two files merge.
- **Counters**, always on (:func:`counters`): host counters (Python ints and
  nanosecond sums, :func:`count`), the kernels' launch counts
  (``ops.kernels.launch_counts``), and device counters: ``int64`` tensors
  on the card (:func:`device_counter`) that code inside captured graphs
  increments, so every replay counts with no switch. Only reading them
  synchronises.
- **Step records**, always on (:func:`steps`): one per ``Trainer.train_step``
  and ``eval_step`` (:func:`step`) in a ring of :data:`STEP_RING`: its host
  start and end, the nanoseconds its host was blocked in the program's own
  device reads (:func:`blocked`), the host counts made inside it, and
  whether a profiler recorded it.
- **Phase marks** (:func:`mark`): inside :func:`phases`, a timing CUDA event
  recorded on the current stream (``external``, so that a mark recorded
  while a CUDA graph captures is part of every replay); :func:`phase_ms`
  reads the device milliseconds between consecutive marks of the last run
  of the marked step (:func:`replayed` names it for a graph). On the CPU a
  mark is the host clock, the CPU being synchronous.

Spans are host time: a span around an enqueue says how long the host took
to enqueue. The device's time comes from the marks or from the profiler.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Iterator

import torch
from torch._C._autograd import _profiler_enabled as profiler_recording
from torch._C._autograd import (
    _record_function_with_args_enter as _rf_enter,
    _record_function_with_args_exit as _rf_exit,
)

SPAN_CAP = 1 << 16  # spans kept in memory; the oldest go first
STEP_RING = 4096  # step records kept
DEVICE_SLOTS = 32  # device counters a card holds


class SpanRecord:
    __slots__ = ("name", "id", "parent", "step", "start", "end")

    def __init__(self, name: str, id: int, parent: int | None, step: int | None, start: int):
        self.name, self.id, self.parent, self.step, self.start = name, id, parent, step, start
        self.end = start


class StepRecord:
    """One step: ``kind`` ("train", "eval"), its id, host start and end (ns,
    ``perf_counter_ns``), ``blocked_ns`` in the program's own device reads,
    ``counts`` (host counts made during the step) and ``profiled``."""

    __slots__ = ("kind", "id", "start", "end", "blocked_ns", "counts", "profiled")

    def __init__(self, kind: str, id: int, start: int, profiled: bool):
        self.kind, self.id, self.start, self.profiled = kind, id, start, profiled
        self.end = start
        self.blocked_ns = 0
        self.counts: dict[str, int] = {}

    @property
    def host_ns(self) -> int:
        return self.end - self.start


class Phases:
    """The marks of one marked step (:func:`phases`): (name, timing event or
    host ns) in the order they were made. A step captured as a CUDA graph
    keeps its marks' events, which each replay records again."""

    def __init__(self, device: torch.device | str):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list[tuple[str, object]] = []
        self._events: list[torch.cuda.Event] = []

    def _mark(self, name: str) -> None:
        if self.cuda:
            i = len(self.marks)
            if i == len(self._events):  # made outside the capture: a warm-up runs first
                self._events.append(torch.cuda.Event(enable_timing=True, external=True))
            ev = self._events[i]
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter_ns()))

    def ms(self) -> dict[str, float]:
        """{phase: ms} from each mark to the next, named by the later mark;
        waits for the last mark on the card."""
        if len(self.marks) < 2:
            return {}
        out: dict[str, float] = {}
        last = self.marks[-1][1]
        if isinstance(last, torch.cuda.Event):
            last.synchronize()
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            dt = a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) / 1e6
            out[name] = out.get(name, 0.0) + dt
        return out


class Tracer:
    """The tracing state of a process (:data:`TRACER`; the module's functions
    act on it)."""

    def __init__(self):
        self.on = False
        self.spans: collections.deque[SpanRecord] = collections.deque(maxlen=SPAN_CAP)
        self.records: collections.deque[StepRecord] = collections.deque(maxlen=STEP_RING)
        self.host: dict[str, int] = {}
        self.current: StepRecord | None = None
        self.building: Phases | None = None  # the marked step being run
        self.last: Phases | None = None  # the marked step last run or replayed
        self.base_ns = 0  # the profiler's trace base (``baseTimeNanoseconds``), once seen
        self._ids = 0
        self._steps = 0
        self._local = threading.local()
        self._device: dict[torch.device, torch.Tensor] = {}
        self._slots: dict[str, int] = {}

    # ---------------------------------------------------------------- spans
    def stack(self) -> list[SpanRecord]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def reset(self) -> None:
        """Drop the spans, step records, host counts and marks; zero the
        device counters."""
        self.spans.clear()
        self.records.clear()
        self.host.clear()
        self.last = None
        with torch.no_grad():
            for t in self._device.values():
                t.zero_()


TRACER = Tracer()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "rec", "handle", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        tr = TRACER
        t0 = time.perf_counter_ns()
        # The profiler stamps the annotation's start inside the call: the
        # call's midpoint is the span's start on either clock.
        self.handle = _rf_enter(self.name) if profiler_recording() else None
        t1 = time.perf_counter_ns()
        self.stack = tr.stack()
        tr._ids += 1
        cur = tr.current
        self.rec = SpanRecord(self.name, tr._ids, self.stack[-1].id if self.stack else None,
                              cur.id if cur is not None else None, (t0 + t1) // 2)
        self.stack.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        if self.handle is not None:
            _rf_exit(self.handle)
        self.rec.end = time.perf_counter_ns()
        self.stack.pop()
        TRACER.spans.append(self.rec)
        return False


def enable(on: bool = True) -> None:
    """Turn the spans on (or off with ``on=False``); counters, step records
    and marks are always on."""
    TRACER.on = on


def span(name: str):
    """A host span named ``name`` (``mm.<layer>.<what>``): a context manager
    that records it when spans are on, else the shared null context."""
    if not (TRACER.on or profiler_recording()):
        return NULL_SPAN
    return _Span(name)


def spans() -> list[SpanRecord]:
    return list(TRACER.spans)


# ------------------------------------------------------------- step records
class _Step:
    __slots__ = ("kind", "rec", "prev", "inner")

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        tr = TRACER
        tr._steps += 1
        profiled = profiler_recording()
        self.rec = StepRecord(self.kind, tr._steps, time.perf_counter_ns(), profiled)
        self.prev = tr.current
        tr.current = self.rec
        self.inner = _Span(f"mm.{self.kind}.step") if (tr.on or profiled) else NULL_SPAN
        self.inner.__enter__()
        return self.rec

    def __exit__(self, *exc):
        self.inner.__exit__(*exc)
        tr = TRACER
        self.rec.end = time.perf_counter_ns()
        tr.current = self.prev
        tr.records.append(self.rec)
        return False


def step(kind: str) -> _Step:
    """The record of one ``kind`` step (always kept) and, when spans are on,
    its span ``mm.<kind>.step``; spans inside it carry its id."""
    return _Step(kind)


def steps(kind: str | None = None) -> list[StepRecord]:
    """The ring's step records, oldest first (of ``kind`` only, if given)."""
    return [r for r in TRACER.records if kind is None or r.kind == kind]


# ----------------------------------------------------------------- counters
def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` and to the open step's counts."""
    tr = TRACER
    tr.host[name] = tr.host.get(name, 0) + n
    if tr.current is not None:
        tr.current.counts[name] = tr.current.counts.get(name, 0) + n


def host_count(name: str) -> int:
    """The host counter ``name`` (0 before its first count); reads nothing
    from the device."""
    return TRACER.host.get(name, 0)


class _Blocked:
    __slots__ = ("counter", "inner", "t0")

    def __init__(self, name: str, counter: str):
        self.counter = counter
        self.inner = span(name)

    def __enter__(self):
        self.inner.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        self.inner.__exit__(*exc)
        count(self.counter, dt)
        if TRACER.current is not None:
            TRACER.current.blocked_ns += dt
        return False


def blocked(name: str, counter: str) -> _Blocked:
    """Around a wait of the host (a read of the device, a queue): its span
    ``name``, and its nanoseconds (always) added to the host counter
    ``counter`` and to the open step's ``blocked_ns``."""
    return _Blocked(name, counter)


def device_counter(name: str, device: torch.device) -> torch.Tensor:
    """The 0-dim ``int64`` device counter ``name`` on ``device``: increment it
    in place (it may be captured in a graph). The card's counters are made
    at the first call on it, which must not be inside a capture."""
    tr = TRACER
    slot = tr._slots.get(name)
    if slot is None:
        if len(tr._slots) == DEVICE_SLOTS:
            raise RuntimeError(f"more than {DEVICE_SLOTS} device counters")
        slot = tr._slots[name] = len(tr._slots)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = tr._device.get(device)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("device counters are made outside a CUDA graph's capture: "
                               "run the step once before capturing it")
        with torch.inference_mode(False):
            t = tr._device[device] = torch.zeros(DEVICE_SLOTS, dtype=torch.int64, device=device)
    return t[slot]


def counters() -> dict[str, int]:
    """Every counter: the host's, the kernels' launch counts and the device
    counters summed over the cards (read from the cards: synchronises)."""
    from mm_masking_tpu_torch.ops.kernels import launch_counts

    tr = TRACER
    out = dict(tr.host)
    out.update(launch_counts())
    for t in tr._device.values():
        values = t.tolist()
        for name, slot in tr._slots.items():
            out[name] = out.get(name, 0) + values[slot]
    for name in tr._slots:
        out.setdefault(name, 0)
    return out


# ------------------------------------------------------------- phase marks
@contextlib.contextmanager
def phases(marks: Phases) -> Iterator[Phases]:
    """Run a marked step: :func:`mark` inside the block records into
    ``marks`` (from its first mark again), which :func:`phase_ms` then
    reads."""
    tr = TRACER
    prev = tr.building
    marks.marks = []
    tr.building = marks
    try:
        yield marks
    finally:
        tr.building = prev
        tr.last = marks


def replayed(marks: Phases) -> None:
    """A graph that holds ``marks`` was replayed: :func:`phase_ms` reads it."""
    TRACER.last = marks


def mark(name: str) -> None:
    """A phase boundary of the marked step being run: the phase from the
    previous mark to here is ``name``. Outside :func:`phases` a no-op."""
    if TRACER.building is not None:
        TRACER.building._mark(name)


def grad_mark(t: torch.Tensor, name: str) -> None:
    """Mark ``name`` when the backward's gradient reaches ``t`` (a tensor
    hook; nothing where ``t`` takes no gradient or no step is marked)."""
    if TRACER.building is not None and t.requires_grad:
        building = TRACER.building

        def hook(_):
            building._mark(name)

        t.register_hook(hook)


def phase_ms() -> dict[str, float]:
    """{phase: device ms} of the marked step last run or replayed, in
    order (host ms on the CPU); {} where no step was marked."""
    return TRACER.last.ms() if TRACER.last is not None else {}


# ------------------------------------------------------------------ output
def dump(path: str) -> str:
    """Write the kept spans to ``path`` as a Chrome trace whose timestamps
    are the profiler's (epoch µs less the ``baseTimeNanoseconds`` of the
    trace :func:`trace` last wrote, which the file repeats), so that its
    events merge with the profiler's file."""
    base = TRACER.base_ns
    offset = time.time_ns() - time.perf_counter_ns() - base
    pid = os.getpid()
    events = [{"ph": "X", "cat": "mm_span", "name": s.name, "pid": pid, "tid": pid,
               "ts": (s.start + offset) / 1e3, "dur": (s.end - s.start) / 1e3,
               "args": {"id": s.id, "parent": s.parent, "step": s.step}}
              for s in TRACER.spans]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base,
                   "displayTimeUnit": "ms"}, fh)
    return path


@contextlib.contextmanager
def trace(trace_dir: str) -> Iterator[None]:
    """Trace the enclosed region into ``<trace_dir>/trace_<ns>.json`` (the
    spans are on inside it, being under a profiler)."""
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        TRACER.base_ns = int(json.load(fh).get("baseTimeNanoseconds", 0))
