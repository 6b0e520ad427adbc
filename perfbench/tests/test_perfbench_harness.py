"""CPU tests of the benchmark's harness: its files, traffic, work counts,
metric readers, result line, the refusal without a card, and its imports.

Run from the root of the checkout: ``python3 -m pytest perfbench/tests -q``.
Tests marked ``gpu`` run only on the card."""
from __future__ import annotations

import ast
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

from perfbench import cells, drive, generator, trace, work
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
ENC = (8, 16, 32, 64, 128, 256)


def test_benchmark_names_a_file_for_every_config_traffic_metric_and_limit():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(cells.reader(m["name"]))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_loads_into_the_programs_config(config):
    from mm_masking_tpu_torch.config import Config

    data = json.loads((ROOT / "perfbench" / "configs" / f"{config}.json").read_text())
    cfg = Config.from_dict(data["config"])
    for block in ("model", "data", "train", "loss"):
        for key, value in data["config"][block].items():
            got = getattr(getattr(cfg, block), key)
            assert (list(got) if isinstance(got, tuple) else got) == value, (block, key)
    cells.reference(config).check_config(data["config"])


def test_a_config_with_a_reference_of_its_own_is_checked_against_it(tmp_path, monkeypatch):
    ref = tmp_path / "reference"
    ref.mkdir()
    for stem in ("policy", "gated"):
        (ref / f"{stem}.py").write_text(
            "def check_config(cfg):\n"
            f"    raise NotImplementedError('checked by {stem}.py')\n")
    monkeypatch.setattr(cells, "HERE", tmp_path)
    with pytest.raises(NotImplementedError, match="checked by gated.py"):
        cells.reference("gated").check_config({})
    with pytest.raises(NotImplementedError, match="checked by policy.py"):
        cells.reference("plain").check_config({})


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_takes_its_configs_reference_and_starts_from_the_seed(name):
    cell = cells.load(name)
    config = next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    own = ROOT / "perfbench" / "reference" / f"{config}.py"
    assert Path(cell.reference.__file__) == (own if own.is_file() else own.with_name("policy.py"))
    model = tiny.cell(name).config["config"]["model"]
    big = 2**31 + 7
    a, b, other = (cell.reference.start_params(model, s, "cpu") for s in (big, big, big + 1))
    assert list(a) == list(b) == list(other)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], other[k]) for k in a)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer(name):
    cell = cells.load(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("name", ["cart640-bf16-pt2pl.train", "polar3360-f32-pt2pt.train"])
def test_traffic_pool_is_the_same_for_a_seed_and_differs_for_another(name):
    c = tiny.cell(name)
    cfg = c.config["config"]

    def pool(seed):
        return generator.make_pool(seed, cfg["model"], cfg["data"], c.batch, c.traffic, "cpu")

    def leaves(batch):
        return [t for d in batch.values() for t in d.values()]

    big = 2**31 + 12345
    a, b, other = pool(big), pool(big), pool(big + 1)
    for x, y in zip(a, b):
        assert all(torch.equal(s, t) for s, t in zip(leaves(x), leaves(y)))
    assert not torch.equal(a[0]["loc_data"]["fft_data"], other[0]["loc_data"]["fft_data"])
    assert not torch.equal(a[0]["map_data"]["pc"], other[0]["map_data"]["pc"])
    # Every batch of a pool is a different one.
    assert not torch.equal(a[0]["map_data"]["pc"], a[1]["map_data"]["pc"])


def test_unet_conv_work_matches_a_hand_count_of_its_32_stages():
    # (ci, co, side) of each 3x3 conv at 640x640: encoder blocks 0-5 (the
    # pool after every block but the first), then decoder blocks applied twice.
    hand = [(1, 8, 640), (8, 8, 640), (8, 16, 640), (16, 16, 640), (16, 32, 320),
            (32, 32, 320), (32, 64, 160), (64, 64, 160), (64, 128, 80), (128, 128, 80),
            (128, 256, 40), (256, 256, 40),
            (256, 128, 40), (128, 128, 40), (256, 128, 40), (128, 128, 40),
            (128, 64, 80), (64, 64, 80), (128, 64, 80), (64, 64, 80),
            (64, 32, 160), (32, 32, 160), (64, 32, 160), (32, 32, 160),
            (32, 16, 320), (16, 16, 320), (32, 16, 320), (16, 16, 320),
            (16, 8, 640), (8, 8, 640), (16, 8, 640), (8, 8, 640)]
    assert work.conv3x3_shapes(ENC, 640) == [(ci, co, s, s) for ci, co, s in hand]
    cart = sum(18 * ci * co * s * s for ci, co, s in hand)
    assert round(cart / 1e9, 2) == 28.84
    scale = {640: (400, 3360), 320: (200, 1680), 160: (100, 840), 80: (50, 420), 40: (25, 210)}
    polar = sum(18 * ci * co * scale[s][0] * scale[s][1] for ci, co, s in hand)
    assert round(polar / 1e9, 2) == 94.64
    conv = sum(work.conv_flops(*s) for s in work.conv3x3_shapes(ENC, (400, 3360)))
    assert conv == polar
    assert work.forward_flops(ENC, 640) == cart + 2 * 8 * 640 * 640
    first = 18 * 1 * 8 * 640 * 640
    assert work.train_flops(ENC, 640) == 3 * work.forward_flops(ENC, 640) - first


def test_conv_bound_is_the_larger_of_operations_and_bytes_per_launch():
    # One 8→8 conv on 2 images of 4x4, float32: every launch is bound by bytes.
    ops = 2 * 18 * 8 * 8 * 16
    io = 4 * 2 * 16 * 16 + 4 * 9 * 64
    got = work.conv_bound_s((8,), 4, 2, "float32", in_channels=8, train=True)
    # The UNet of one block has two convs; the first has no dx.
    expect = 2 * (io + 32) / work.HBM_BYTES_PER_S + 3 * io / work.HBM_BYTES_PER_S
    assert ops / work.PEAK_MATMUL_FLOPS["float32"] < io / work.HBM_BYTES_PER_S
    assert got == pytest.approx(expect)


def _events():
    """Two traced steps of 10 ms: kernels (a K2, a K3, glue, an NN search),
    a copy, host launches and one idle gap of 2 ms under a host op."""
    ev = [
        {"name": trace.STEP, "cat": "user_annotation", "ts": 0.0, "dur": 10_000.0},
        {"name": trace.STEP, "cat": "user_annotation", "ts": 10_000.0, "dur": 10_000.0},
        {"name": "void conv3x3_mma_bf16<8>(...)", "cat": "kernel", "ts": 100.0, "dur": 3000.0},
        {"name": "conv3x3_dk_mma_bf16_kernel", "cat": "kernel", "ts": 3100.0, "dur": 2000.0},
        {"name": "void at::native::vectorized_elementwise_kernel<4>", "cat": "kernel",
         "ts": 5100.0, "dur": 2900.0},
        {"name": "nn_argmin_stripe", "cat": "kernel", "ts": 10_000.0, "dur": 1000.0},
        {"name": "Memcpy DtoD (Device -> Device)", "cat": "gpu_memcpy", "ts": 11_000.0,
         "dur": 7000.0},
        {"name": "cudaGraphLaunch", "cat": "cuda_runtime", "ts": 50.0, "dur": 20.0},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 10_000.0, "dur": 5.0},
        {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 10_001.0, "dur": 5.0},
        {"name": "aten::item", "cat": "cpu_op", "ts": 8000.0, "dur": 2000.0},
    ]
    return ev


def _run(mode, **kw):
    model = {"enc_channels": [8], "cart_pixel_width": 4, "network_input_type": "cartesian",
             "dtype": "bfloat16", "polar_shape": [4, 4]}
    return drive.Run(mode=mode, model=model, batch=2, setup_s=3.5, **kw)


def test_trace_reduction_on_canned_events():
    ev = _events()
    # Busy: 100-8000 and 10000-18000 µs.
    assert trace.busy_s(ev) == pytest.approx((7900 + 8000) / 1e6)
    assert trace.window_s(ev) == pytest.approx(0.020)
    assert trace.host_launches(ev) == 2
    b = trace.breakdown(ev)
    assert b["device_ops"][0] == ["Memcpy DtoD (Device -> Device)", pytest.approx(0.007)]
    # The 8000-10000 µs gap lies under aten::item; 0-100 under cudaGraphLaunch's 20 µs.
    assert b["idle_gaps"][0] == ["aten::item", pytest.approx(0.002)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_metric_readers_on_canned_events():
    ev = _events()
    run = _run("train", window_s=2.0, steps=10, events=ev, traced_steps=2,
               window_peak_bytes=3 * 2**30)
    assert cells.reader("idle_pct.train")(run) == pytest.approx(100 * (1 - 0.0159 / 0.020))
    assert cells.reader("idle_pct.eval")(run) is None
    assert cells.reader("glue_ms.train")(run) == pytest.approx(2.9 / 2)
    assert cells.reader("peak_mem_gib.train")(run) == pytest.approx(3.0)
    bound = 2 * work.conv_bound_s([8], 4, 2, "bfloat16")
    assert cells.reader("conv3x3_roofline")(run) == pytest.approx(100 * bound / 0.005)
    assert cells.reader("train_pairs_per_s")(run) == pytest.approx(10.0)
    assert cells.reader("setup_s")(run) == 3.5
    flops = work.train_flops([8], 4) * 20 / 2.0
    assert cells.reader("mfu.train")(run) == pytest.approx(100 * flops / 989e12)
    ev_run = _run("eval", window_s=2.0, steps=4, step_s=[0.1, 0.2, 0.3, 0.4], events=ev,
                  traced_steps=2)
    assert cells.reader("nn_ms.eval")(ev_run) == pytest.approx(0.5)
    assert cells.reader("host_launches.eval")(ev_run) == 1.0
    assert cells.reader("eval_batch_p95_ms")(ev_run) == pytest.approx(385.0)
    assert cells.reader("eval_pairs_per_s")(ev_run) == pytest.approx(4.0)


def test_a_pattern_that_matches_nothing_reads_none():
    renamed = [dict(e, name=e["name"].replace("conv3x3", "convX").replace("nn_argmin", "nnX"))
               for e in _events()]
    run = _run("train", window_s=2.0, steps=10, events=renamed, traced_steps=2)
    assert cells.reader("conv3x3_roofline")(run) is None
    assert cells.reader("glue_ms.train")(run) is None  # the port's kernels match nothing
    assert cells.reader("nn_ms.eval")(_run("eval", events=renamed, traced_steps=2)) is None
    no_trace = _run("train", window_s=2.0, steps=10)
    for name in ("idle_pct.train", "conv3x3_roofline", "glue_ms.train"):
        assert cells.reader(name)(no_trace) is None


@contextlib.contextmanager
def _tiny_run_on_cpu():
    from perfbench import run

    with mock.patch.object(run, "require_cards", lambda n: torch.device("cpu")), \
            mock.patch.object(run.cells, "load", tiny.cell), \
            mock.patch.object(run, "power_limit", lambda: None):
        yield run


def _last_line(run, argv) -> dict:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert run.main(argv) == 0
    lines = err.getvalue().strip().splitlines()
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    # The compared numbers are the last lines of standard error, in order.
    n = len(result["compared"])
    assert [ln.split()[2] for ln in lines[-n:]] == list(result["compared"])
    return result


@pytest.mark.parametrize("name", CELLS)
def test_last_line_has_the_result_keys(name):
    with _tiny_run_on_cpu() as run:
        for traced in (0, 1):
            result = _last_line(run, ["--workload", name, "--seed", str(2**31 + 5),
                                      "--seconds", "0.3", "--trace", str(traced)])
            keys = list(result)
            assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
            assert keys[-1] == "compared"
            assert result["correct"] is True, result["compared"]
            assert result["attempted"] >= 1 and result["failed"] == 0
            dev = result["device"]
            assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
            cell = cells.load(name)
            wanted = cell.per_layer if traced else cell.end_to_end
            assert set(result["metrics"]) <= {m["name"] for m in wanted}
            if traced:
                assert {"busy_s", "window_s"} <= set(dev)
                assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
            else:
                assert set(result["metrics"]) == {m["name"] for m in wanted}
            for m in result["metrics"].values():
                assert set(m) == {"value", "unit"}


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout.strip()


def test_harness_loads_no_jax_module():
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import perfbench.run, perfbench.calibrate, perfbench.faults;"
        "from perfbench import cells, drive;"
        "[cells.reader(m['name']) for m in cells._read(cells.ROOT / 'BENCHMARK.json')"
        "['end_to_end'] + cells._read(cells.ROOT / 'BENCHMARK.json')['per_layer']];"
        "import mm_masking_tpu_torch.train.trainer, mm_masking_tpu_torch.config;"
        "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    top = set(json.loads(proc.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "mm_masking_tpu_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "optax", "orbax", "mm_masking_tpu"}


def test_forbidden_modules_compares_whole_top_level_names():
    with mock.patch.dict(sys.modules, {"mm_masking_tpu_torch_x": object()}):
        assert drive.forbidden_modules() == []
    with mock.patch.dict(sys.modules, {"mm_masking_tpu.ops": object()}):
        assert drive.forbidden_modules() == ["mm_masking_tpu"]


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "perfbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in {"mm_masking_tpu_torch", "mm_masking_tpu", "jax",
                                               "jaxlib", "flax"}, (path.name, n)
