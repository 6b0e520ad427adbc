"""Reading what the program records about itself in a run
(``mm_masking_tpu_torch.utils.profiling``: step records, counters and the
train step's phase marks), while the program is still loaded.

Each reader returns None where the program records none of it (a program
from before its tracing layer), and does not raise for that.
"""
from __future__ import annotations


def _profiling():
    try:
        from mm_masking_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def window_steps(run, kind: str) -> list | None:
    """The step records of the timed window: the last ``run.steps`` records
    of ``kind`` ("train", "eval") that no profiler recorded; None where the
    program keeps fewer."""
    steps = getattr(_profiling(), "steps", None)
    if steps is None or run.steps <= 0:
        return None
    recs = [r for r in steps(kind) if not r.profiled]
    return recs[-run.steps:] if len(recs) >= run.steps else None


def counters() -> dict | None:
    """Every counter of the program (reading its device counters
    synchronises)."""
    read = getattr(_profiling(), "counters", None)
    return read() if read is not None else None


def ratio(num: str, den: str) -> float | None:
    """counters[num] / counters[den]; None where the denominator is 0 or
    absent, so that a renamed counter reads as nothing."""
    c = counters()
    if not c or not c.get(den):
        return None
    return c.get(num, 0) / c[den]


def phase_ms() -> dict | None:
    """{phase: device ms} of the train step's last replay, from the phase
    marks captured in its graph; None where the marks are not the card's."""
    prof = _profiling()
    last = getattr(getattr(prof, "TRACER", None), "last", None)
    if last is None or not getattr(last, "cuda", False):
        return None
    return prof.phase_ms()


def phases_sum(names) -> float | None:
    """The sum of the named phases' ms; None unless every one was marked."""
    ms = phase_ms()
    if not ms or any(n not in ms for n in names):
        return None
    return sum(ms[n] for n in names)
