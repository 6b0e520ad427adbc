"""CPU tests of the readers of the stripe association's scanned share,
``nn_scan_pct.train`` and ``nn_scan_pct.eval``, on synthetic counters.

Run from the root of the checkout: ``python3 -m pytest perfbench/tests -q``."""
from __future__ import annotations

import types

import pytest

from perfbench import cells, drive, program


def _run(mode):
    return drive.Run(mode=mode, model={"enc_channels": [8]}, batch=2, setup_s=1.0, steps=4)


def _install(monkeypatch, counters):
    monkeypatch.setattr(program, "_profiling",
                        lambda: types.SimpleNamespace(counters=lambda: dict(counters)))


def test_scan_share_reads_the_block_counters(monkeypatch):
    _install(monkeypatch, {"nn.blocks_scanned": 240, "nn.blocks_dense": 1000,
                           "nn.stripe_searched": 50, "nn.stripe_over": 45})
    ev, tr = _run("eval"), _run("train")
    assert cells.reader("nn_scan_pct.eval")(ev) == pytest.approx(24.0)
    assert cells.reader("nn_scan_pct.train")(tr) == pytest.approx(24.0)
    assert cells.reader("nn_scan_pct.eval")(tr) is None
    assert cells.reader("nn_scan_pct.train")(ev) is None


@pytest.mark.parametrize("counters", [{}, {"nn.stripe_searched": 5, "nn.stripe_over": 5},
                                      {"nn.blocks_scanned": 3, "nn.blocks_dense": 0}])
def test_a_program_without_block_counts_reads_none(monkeypatch, counters):
    """The parent program counts no blocks: the metric is left out."""
    _install(monkeypatch, counters)
    assert cells.reader("nn_scan_pct.eval")(_run("eval")) is None
    assert cells.reader("nn_scan_pct.train")(_run("train")) is None


def test_program_without_a_tracing_layer_reads_none(monkeypatch):
    monkeypatch.setattr(program, "_profiling", lambda: None)
    assert cells.reader("nn_scan_pct.eval")(_run("eval")) is None
