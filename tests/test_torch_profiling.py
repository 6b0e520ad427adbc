"""The port's tracing layer (``mm_masking_tpu_torch.utils.profiling``) and
the spans and counters the program records through it.

On the CPU: spans nest with their parents and steps, cost nothing when off,
land in the profiler's Chrome trace as user annotations and in ``dump()`` on
the profiler's clock; the step ring is bounded; the solve's counters equal a
hand count from a loop that tests after every iteration; the stripe's
counters see a call over its budget; the loader's wait grows when its
prefetch starves. Tests marked ``gpu`` hold the phase marks captured in the
train step's graph against the replay's device time, and the steps with
their counters and marks against themselves. The file imports no JAX::

    python -m pytest --noconftest -m gpu tests/test_torch_profiling.py
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mm_masking_tpu_torch.config import Config, ModelConfig
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.data.loader import epoch_batches
from mm_masking_tpu_torch.dicp.icp import (
    STOP_TEST_EVERY,
    ICPConfig,
    _iterate,
    _new_state,
    _prepare,
    icp,
)
from mm_masking_tpu_torch.ops.kernels import eager
from mm_masking_tpu_torch.ops.kernels.nn_assoc import (
    nn_argmin_stripe_presorted,
    stripe_sort_target,
)
from mm_masking_tpu_torch.train import Trainer
from mm_masking_tpu_torch.utils import profiling


@pytest.fixture
def tracer():
    """A clean tracer with spans on; off again afterwards."""
    profiling.TRACER.reset()
    profiling.enable()
    yield profiling.TRACER
    profiling.enable(False)
    profiling.TRACER.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def delta(before: dict, names) -> dict:
    after = profiling.counters()
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


# ------------------------------------------------------------------- spans
def test_spans_nest_with_parents_and_step_ids(tracer):
    with profiling.step("eval") as rec:
        with profiling.span("mm.test.outer") as outer:
            with profiling.span("mm.test.inner") as inner:
                pass
        with profiling.span("mm.test.next") as nxt:
            pass
    with profiling.span("mm.test.after") as after:
        pass
    by_name = {s.name: s for s in profiling.spans()}
    step = by_name["mm.eval.step"]
    assert inner.parent == outer.id and outer.parent == step.id and nxt.parent == step.id
    assert step.parent is None and after.parent is None
    assert {s.step for s in (step, outer, inner, nxt)} == {rec.id} and after.step is None
    assert step.start <= outer.start <= inner.start <= inner.end <= outer.end <= nxt.start
    assert nxt.end <= step.end
    # Kept as they end: the inner span first.
    assert [s.name for s in profiling.spans()] == [
        "mm.test.inner", "mm.test.outer", "mm.test.next", "mm.eval.step", "mm.test.after"]


def test_spans_off_leave_no_record_and_share_the_null_context():
    profiling.TRACER.reset()
    assert not profiling.TRACER.on
    assert profiling.span("mm.test.a") is profiling.span("mm.test.b") is profiling.NULL_SPAN
    with profiling.step("train"):
        with profiling.span("mm.test.a") as got:
            assert got is None
    assert profiling.spans() == []
    (rec,) = profiling.steps()  # the step record is always kept
    assert rec.kind == "train" and rec.end >= rec.start and not rec.profiled


def test_spans_under_the_profiler_are_user_annotations(tmp_path):
    profiling.TRACER.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.step("eval"):
            with profiling.span("mm.test.outer"):
                torch.ones(4).add_(1.0)
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"mm.eval.step", "mm.test.outer"} <= names
    assert profiling.steps()[-1].profiled
    assert not profiling.TRACER.on  # on only while the profiler records


def test_dump_lands_on_the_profilers_clock(tracer, tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        for i in range(4):
            with profiling.span(f"mm.test.s{i}"):
                torch.ones(64).mul_(2.0)
                time.sleep(0.002)
    (name,) = list((tmp_path / "prof").iterdir())
    prof = json.loads(name.read_text())
    theirs = {e["name"]: e for e in prof["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"].startswith("mm.test")}
    ours = json.loads(open(profiling.dump(str(tmp_path / "spans.json"))).read())
    assert ours["baseTimeNanoseconds"] == prof["baseTimeNanoseconds"]
    mine = {e["name"]: e for e in ours["traceEvents"]}
    assert set(theirs) == set(mine) == {f"mm.test.s{i}" for i in range(4)}
    for n, e in theirs.items():
        assert abs(mine[n]["ts"] - e["ts"]) <= 50.0, n
        assert abs(mine[n]["ts"] + mine[n]["dur"] - e["ts"] - e["dur"]) <= 50.0, n


def test_step_ring_is_bounded():
    profiling.TRACER.reset()
    for _ in range(profiling.STEP_RING + 5):
        with profiling.step("eval"):
            pass
    recs = profiling.steps("eval")
    assert len(recs) == profiling.STEP_RING
    assert [r.id for r in recs] == list(range(recs[0].id, recs[0].id + profiling.STEP_RING))
    assert recs[-1].id == profiling.TRACER._steps


def test_blocked_time_goes_to_the_step_and_its_counter():
    profiling.TRACER.reset()
    with profiling.step("eval") as rec:
        with profiling.blocked("mm.test.wait", "test.wait_ns"):
            time.sleep(0.003)
    assert rec.blocked_ns >= 3_000_000 and rec.blocked_ns <= rec.host_ns
    assert rec.counts == {"test.wait_ns": rec.blocked_ns}
    assert profiling.host_count("test.wait_ns") == rec.blocked_ns


def test_phase_marks_on_the_cpu_are_the_host_clock():
    marks = profiling.Phases("cpu")
    profiling.mark("ignored")  # outside a marked step: nothing
    with profiling.phases(marks):
        profiling.mark("start")
        time.sleep(0.002)
        profiling.mark("a")
        profiling.mark("b")
    ms = profiling.phase_ms()
    assert list(ms) == ["a", "b"] and ms["a"] >= 2.0 and ms["b"] >= 0.0


# --------------------------------------------------- the solve's counters
def solve_inputs(B=4, N=512, M=2048, seed=0):
    """A planar map of M points and B scans of its first N points moved by
    offsets of growing size, so that the items converge after different
    numbers of iterations."""
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand((B, M, 2), generator=g) * 60.0 - 30.0
    target = torch.cat([xy, torch.zeros(B, M, 1)], -1)
    nrm = torch.nn.functional.normalize(torch.randn((B, M, 3), generator=g) * torch.tensor(
        [1.0, 1.0, 0.0]), dim=-1)
    target6 = torch.cat([target, nrm], -1)
    source = target[:, :N].clone()
    T_init = torch.eye(4).repeat(B, 1, 1)
    for b in range(B):
        th = 0.01 * (b + 1)
        T_init[b, :2, :2] = torch.tensor([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        T_init[b, :2, 3] = torch.tensor([0.05, -0.03]) * (b + 1)
    return source, target6, T_init


def hand_count(source, target, T_init, cfg: ICPConfig):
    """The solve run one iteration at a time with the stop test after each:
    (each item's iterations, the iterations in which the solve ran, whether
    some item still runs after each iteration)."""
    inp, stripe = _prepare(source, target, T_init, None, cfg)
    st = _new_state(T_init, inp["source"].shape[1])
    ran = torch.zeros(T_init.shape[0], dtype=torch.int64)
    running_after = []
    for _ in range(cfg.max_iterations):
        it0, runs = int(st["iterations"]), (st["dn"] >= cfg.tolerance).long()
        _iterate(st, inp, cfg, stripe, 1)
        # The gated solve steps every item while it runs.
        ran += int(st["iterations"]) - it0 if cfg.nn_refresh_dist > 0.0 else runs
        running_after.append(bool((st["dn"] >= cfg.tolerance).any()))
    return ran, int(st["iterations"]), running_after


@pytest.mark.parametrize("gated", [False, True], ids=["per-item", "gated"])
@pytest.mark.parametrize("stripe", [False, True], ids=["dense", "stripe"])
def test_solve_counters_equal_a_hand_count(gated, stripe):
    cfg = ICPConfig(icp_type="pt2pl", max_iterations=30, tolerance=1e-5, differentiable=False,
                    nn_stripe=stripe, nn_refresh_dist=0.05 if gated else 0.0, dim=2)
    source, target, T_init = solve_inputs()
    ran, iterations, running_after = hand_count(source, target, T_init, cfg)
    k = STOP_TEST_EVERY
    n_chunks = -(-cfg.max_iterations // k)
    # A read that finds no item running ends the solve; the last chunk has none.
    stop = next((c for c in range(1, n_chunks) if not running_after[c * k - 1]), None)
    reads, chunks = (stop, stop) if stop is not None else (n_chunks - 1, n_chunks)
    names = ("icp.item_iters", "icp.item_slots", "icp.stop_reads", "icp.chunks")
    before = profiling.counters()
    out = icp(source, target, T_init, cfg=cfg)
    got = delta(before, names)
    assert out["stop_tests"] == reads and int(out["iterations"]) == iterations
    assert 0 < iterations < cfg.max_iterations  # the stop test ends it early
    B = T_init.shape[0]
    assert got == {"icp.item_iters": int(ran.sum()), "icp.item_slots": B * chunks * k,
                   "icp.stop_reads": reads, "icp.chunks": chunks}
    if not gated:  # the items stop after different numbers of iterations
        assert len(set(ran.tolist())) > 1 and int(ran.max()) == iterations
    else:
        assert ran.tolist() == [iterations] * B


def test_stop_reads_go_to_the_step_record():
    profiling.TRACER.reset()
    cfg = ICPConfig(icp_type="pt2pl", max_iterations=30, differentiable=False, dim=2)
    source, target, T_init = solve_inputs()
    with profiling.step("eval") as rec:
        out = icp(source, target, T_init, cfg=cfg)
    assert rec.counts["icp.stop_reads"] == out["stop_tests"] > 0
    assert rec.counts["icp.chunks"] == out["stop_tests"]  # a read ended the solve
    assert 0 < rec.blocked_ns == rec.counts["icp.stop_wait_ns"] <= rec.host_ns


def test_stripe_counters_see_a_call_over_the_budget():
    g = torch.Generator().manual_seed(3)
    B, M = 2, 4096
    x = torch.rand((B, M), generator=g) * 400.0
    q = torch.stack([x, torch.rand((B, M), generator=g) * 10.0, torch.zeros(B, M)], -1)
    q_sorted, key, use_x = stripe_sort_target(q)
    assert bool(use_x.all())
    names = ("nn.stripe_searched", "nn.stripe_over")

    def call(p, refresh=None):
        before = profiling.counters()
        nn_argmin_stripe_presorted(p, q_sorted, key, use_x, trim_dist=0.5, tn=128,
                                   refresh=refresh)
        return delta(before, names)

    within = q_sorted[:, ::4].contiguous()  # grouped by key: each tile needs 1-2 blocks
    scattered = q[:, :1024].contiguous()  # every tile spans the whole map
    assert call(within) == {"nn.stripe_searched": 1, "nn.stripe_over": 0}
    assert call(scattered) == {"nn.stripe_searched": 1, "nn.stripe_over": 1}
    none = torch.zeros(B, dtype=torch.bool)
    assert call(scattered, refresh=none) == {"nn.stripe_searched": 0, "nn.stripe_over": 0}
    one = torch.tensor([False, True])
    assert call(scattered, refresh=one) == {"nn.stripe_searched": 1, "nn.stripe_over": 1}


@pytest.mark.parametrize("refresh", [None, [False, True]])
def test_stripe_block_counters_match_a_hand_count(refresh):
    """``nn.blocks_scanned`` adds the map blocks of each searching tile's run
    and ``nn.blocks_dense`` the searching tiles × M / tm, counted here tile
    by tile in numpy: half the scan grouped by key (short runs), half
    scattered (runs of the whole map); a skipped item adds to neither."""
    g = torch.Generator().manual_seed(5)
    B, M, N, tn, tm, trim = 2, 4096, 1024, 128, 512, 0.5
    x = torch.rand((B, M), generator=g) * 400.0
    q = torch.stack([x, torch.rand((B, M), generator=g) * 10.0, torch.zeros(B, M)], -1)
    q_sorted, key, use_x = stripe_sort_target(q)
    p = torch.cat([q_sorted[:, ::8], q[:, :N // 2]], 1).contiguous()
    gate = None if refresh is None else torch.tensor(refresh)
    names = ("nn.blocks_scanned", "nn.blocks_dense")
    before = profiling.counters()
    nn_argmin_stripe_presorted(p, q_sorted, key, use_x, trim_dist=trim, window=tm, tn=tn,
                               refresh=gate)
    got = delta(before, names)
    keys, pk = key.numpy(), p[..., 0].numpy()
    scanned = dense = 0
    for b in range(B):
        if refresh is not None and not refresh[b]:
            continue
        for t in range(N // tn):
            k = pk[b, t * tn:(t + 1) * tn]
            first = np.searchsorted(keys[b], k.min() - np.float32(trim), "left")
            end = np.searchsorted(keys[b], k.max() + np.float32(trim), "left")
            start = min(first // tm, M // tm - 1)
            scanned += max(-(-end // tm) - start, 1)
            dense += M // tm
    assert got == {"nn.blocks_scanned": scanned, "nn.blocks_dense": dense}
    assert 0 < scanned < dense


# ------------------------------------------------------------------ loader
class SlowItems:
    """Polar items whose loading takes ``delay`` seconds each."""

    def __init__(self, n: int, delay: float):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        z = np.zeros((4, 8), np.float32)
        return {"loc_data": {"fft_data": z, "fft_cfar": z, "azimuths": np.zeros(4, np.float32)}}


def test_loader_wait_grows_when_the_prefetch_starves():
    cfg = Config(model=ModelConfig(network_input_type="polar"))

    def waited(delay):
        w0 = profiling.host_count("loader.wait_ns")
        batches = list(epoch_batches(SlowItems(8, delay), 2, cfg, shuffle=False, prefetch=1,
                                     device="cpu"))
        assert len(batches) == 4
        return (profiling.host_count("loader.wait_ns") - w0) / 1e9

    assert waited(0.02) >= 4 * 2 * 0.02 * 0.5  # the consumer waits on every batch
    assert waited(0.0) < waited(0.02)


# ------------------------------------------------------------- on the card
def small_trainer(device, **model):
    spec = SyntheticSpec(n_scan=1024, n_map=4096, polar_shape=(128, 512),
                         cart_pixel_width=128, res=0.25, cart_resolution=0.5,
                         max_range=30.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
    cfg = Config(model=ModelConfig(enc_channels=(4, 8, 16), cart_pixel_width=128,
                                   cart_resolution=0.5, res=0.25, polar_shape=(128, 512),
                                   **model))
    return Trainer(cfg, device), spec


def test_train_step_phases_on_the_cpu_cover_the_step():
    """The eager train step's marks on the host clock: every phase in order,
    summing to the step's host time at most."""
    trainer, spec = small_trainer("cpu", max_iter=2)
    batch = synthetic_batch(1, 2, dataclasses.replace(spec, n_scan=128, n_map=512), device="cpu")
    state = trainer.init_state(0)
    profiling.TRACER.reset()
    trainer.train_step(state, batch)
    ms = profiling.phase_ms()
    assert list(ms) == ["unet.fwd", "lookup.fwd", "icp.fwd", "loss.fwd", "loss.bwd", "icp.bwd",
                        "lookup.bwd", "unet.bwd", "optim"]
    (rec,) = profiling.steps("train")
    assert sum(ms.values()) <= rec.host_ns / 1e6
    assert profiling.counters()["nn.stripe_searched"] == 0  # 512 map points: no stripe


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_graph_phase_marks_cover_the_replay(cuda, dtype):
    """The phase marks captured in the train step's graph: all nine, and
    their sum within 2% of the replay's device time (CUDA events around
    the replay)."""
    trainer, spec = small_trainer(cuda, max_iter=3, dropout=0.05, dtype=dtype)
    batch = synthetic_batch(9, 4, spec, device=cuda)
    state = trainer.init_state(6)
    trainer.train_step(state, batch)  # capture
    (graph,) = state.graphs.values()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        a.record()
        graph.step.replay()
        b.record()
    profiling.replayed(graph.marks)
    ms = profiling.phase_ms()
    replay = a.elapsed_time(b)
    assert len(ms) == 9 and all(v >= 0.0 for v in ms.values())
    assert abs(sum(ms.values()) - replay) <= 0.02 * replay, (ms, replay)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_with_counters_and_marks_is_bitwise_repeatable(cuda, dtype):
    """Two chains of 3 replayed steps from one seed end in the same bits,
    and every replay counts its stripe calls on the device."""
    trainer, spec = small_trainer(cuda, max_iter=3, dropout=0.05, dtype=dtype)
    batch = synthetic_batch(9, 4, spec, device=cuda)

    def chain():
        state = trainer.init_state(6)
        out = []
        for _ in range(3):
            _, loss, _, gnorm = trainer.train_step(state, batch)
            out += [loss, gnorm]
        return [t.detach().clone() for t in state.opt.tensors()] + out

    before = profiling.counters()
    a, b = chain(), chain()
    got = delta(before, ("nn.stripe_searched",))
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i
    # 3 stripe calls a step: 2 warm-ups (one per capture) and 6 replays.
    assert got["nn.stripe_searched"] == 3 * (2 + 6)


@pytest.mark.gpu
def test_eval_step_results_hold_with_the_counters(cuda):
    """The replayed eval step twice and eagerly: the same poses and error,
    its stop reads those of the solve, and items' iterations within the
    slots computed."""
    trainer, spec = small_trainer(cuda)
    params = trainer.init_state(4).params
    batch = synthetic_batch(7, 8, spec, device=cuda)
    trainer.eval_step(params, batch)  # captures the chunk
    profiling.TRACER.reset()
    err_a, _, mask_a = trainer.eval_step(params, batch)
    err_b, _, mask_b = trainer.eval_step(params, batch)
    with eager():
        err_e, _, _ = trainer.eval_step(params, batch)
    assert torch.equal(err_a, err_b) and torch.equal(mask_a, mask_b)
    torch.testing.assert_close(err_a, err_e, rtol=1e-5, atol=1e-6)
    c = profiling.counters()
    recs = profiling.steps("eval")
    assert c["icp.stop_reads"] == sum(r.counts["icp.stop_reads"] for r in recs)
    assert 0 < c["icp.item_iters"] <= c["icp.item_slots"]
    assert c["nn.stripe_searched"] > 0
