"""Run artifacts, the uploader and the Chrome trace of the port
(``mm_masking_tpu_torch.utils``) against the JAX package's on the CPU.

A tiny ``fit`` in each package, each streaming to a stub HTTP collector on
127.0.0.1: the same artifact file names, every PNG of the port's decodable
(matplotlib reads them here), and the same records uploaded in the same
order. The uploader's payloads equal JAX's call for call; with no URL it
sends nothing, and a dead collector never raises. ``trace`` writes a Chrome
trace, and the plotting functions take JAX's arguments and return JAX's
paths.
"""
from __future__ import annotations

import contextlib
import http.server
import json
import os
import threading

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from mm_masking_tpu.config import Config as JConfig, ModelConfig as JModelConfig
from mm_masking_tpu.config import TrainConfig as JTrainConfig
from mm_masking_tpu.data.synthetic import SyntheticSpec as JSpec, synthetic_batch as jbatch
from mm_masking_tpu.parallel import make_mesh
from mm_masking_tpu.train.metrics import MetricsLogger as JMetricsLogger
from mm_masking_tpu.train.trainer import Trainer as JTrainer
from mm_masking_tpu.utils import visualize as jvis
from mm_masking_tpu.utils.upload import ExperimentUploader as JUploader
from mm_masking_tpu_torch.config import Config, ModelConfig, TrainConfig
from mm_masking_tpu_torch.data import SyntheticSpec, synthetic_batch
from mm_masking_tpu_torch.train import Trainer
from mm_masking_tpu_torch.train.metrics import MetricsLogger
from mm_masking_tpu_torch.utils import visualize
from mm_masking_tpu_torch.utils.profiling import trace
from mm_masking_tpu_torch.utils.upload import ENV_URL, ExperimentUploader
from test_torch_e2e_product import one_thread  # noqa: F401

MODEL = dict(enc_channels=(4, 8), dropout=0.0, cart_pixel_width=64, cart_resolution=0.5,
             res=0.25, polar_shape=(64, 256), max_iter=3, inference_max_iter=8)
SPEC = dict(n_scan=128, n_map=512, polar_shape=(64, 256), cart_pixel_width=64, res=0.25,
            cart_resolution=0.5, max_range=15.0, min_range=2.0, pos_std=0.4, rot_std=0.15)
ARTIFACTS = {"learned_mask_epre.png", "learned_mask_e0.png", "raw_scan.png", "cfar_mask.png",
             "fft_mask.png", "map_mask.png"}


@contextlib.contextmanager
def collector():
    """A stub HTTP collector on 127.0.0.1: yields (its URL, the JSON bodies
    it received, in order)."""
    bodies = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            bodies.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/", bodies
    finally:
        server.shutdown()
        server.server_close()


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """One epoch of ``fit`` in each package on one train and one validation
    batch, each logger's uploader posting to its own stub collector:
    {"jax" | "port": (the run directory, the bodies received)}."""
    out = {}
    train = jbatch(0, 4, JSpec(**SPEC))
    val = jbatch(100, 4, JSpec(**SPEC))
    d = tmp_path_factory.mktemp("jax_fit")
    with collector() as (url, bodies):
        cfg = JConfig(model=JModelConfig(**MODEL),
                      train=JTrainConfig(batch_size_train=4, batch_size_test=4, num_epochs=1,
                                         checkpoint_dir=str(d)))
        jtr = JTrainer(cfg, mesh=make_mesh(1),
                       logger=JMetricsLogger(str(d), verbose=False, uploader=JUploader(url)))
        jtr.fit(lambda epoch: [train], lambda: [val])
        out["jax"] = (d, list(bodies))
    d = tmp_path_factory.mktemp("port_fit")
    with collector() as (url, bodies):
        cfg = Config(model=ModelConfig(**MODEL),
                     train=TrainConfig(batch_size_train=4, batch_size_test=4, num_epochs=1,
                                       checkpoint_dir=str(d)))
        trainer = Trainer(cfg, "cpu", MetricsLogger(str(d), verbose=False,
                                                    uploader=ExperimentUploader(url)))
        tbatch = [synthetic_batch(0, 4, SyntheticSpec(**SPEC))]
        vbatch = [synthetic_batch(100, 4, SyntheticSpec(**SPEC))]
        trainer.fit(lambda epoch: tbatch, lambda: vbatch)
        out["port"] = (d, list(bodies))
    return out


def test_fit_writes_the_jax_artifact_names(fits):
    names = {k: set(os.listdir(d / "run_artifacts")) for k, (d, _) in fits.items()}
    assert names["jax"] == names["port"] == ARTIFACTS
    art = fits["port"][0] / "run_artifacts"
    for name in ARTIFACTS:
        img = plt.imread(art / name)
        assert img.shape == (64, 64), name
    # A learned mask spans its 8 bits; the binary masks take two levels.
    assert plt.imread(art / "learned_mask_e0.png").max() == 1.0
    assert set(np.unique(plt.imread(art / "fft_mask.png"))) <= {0.0, 1.0}


def test_fit_uploads_the_jax_records(fits):
    """The run's parameters first, then every record in order, then the best
    checkpoint: JAX's orbax directory's files, the port's ``best_policy.pt``."""
    (_, jbodies), (_, bodies) = fits["jax"], fits["port"]
    kinds = [b["kind"] for b in bodies]
    jkinds = [b["kind"] for b in jbodies]
    assert kinds[0] == jkinds[0] == "params"
    n_events = kinds.count("event")
    assert n_events == jkinds.count("event") and kinds[1:1 + n_events] == ["event"] * n_events
    assert [b["record"]["event"] for b in bodies if b["kind"] == "event"] == [
        b["record"]["event"] for b in jbodies if b["kind"] == "event"]
    assert kinds[1 + n_events:] == ["file"] and bodies[-1]["name"] == "best_policy.pt"
    assert jkinds[1 + n_events:] and set(jkinds[1 + n_events:]) == {"file"}
    jparams = dict(jbodies[0]["params"], train=None)
    assert dict(bodies[0]["params"], train=None) == jparams  # the run directories differ
    assert set(bodies[1]["record"]) == set(jbodies[1]["record"])


def test_uploader_payloads_equal_jax(tmp_path):
    (tmp_path / "d").mkdir()
    for name, data in (("b.bin", b"\x00\x01\xff"), ("a.txt", b"x" * 5)):
        (tmp_path / "d" / name).write_bytes(data)
    record = {"event": "epoch", "loss": 0.5, "epoch": 3}

    def calls(uploader):
        return [uploader.log_params("r", {"model": {"enc": [4, 8]}}),
                uploader.log_event("r", record),
                uploader.upload_file("r", str(tmp_path / "d" / "b.bin")),
                uploader.upload_dir("r", str(tmp_path / "d"))]

    with collector() as (url, jbodies):
        jret = calls(JUploader(url))
    with collector() as (url, bodies):
        ret = calls(ExperimentUploader(url))
    assert ret == jret == [True, True, True, 2]
    assert bodies == jbodies and len(bodies) == 5


def test_uploader_without_url_does_nothing(monkeypatch, tmp_path):
    monkeypatch.delenv(ENV_URL, raising=False)
    (tmp_path / "f").write_bytes(b"1")
    up = ExperimentUploader()
    assert not up.enabled and up.url is None
    assert (up.log_params("r", {}), up.log_event("r", {}), up.upload_dir("r", str(tmp_path))) \
        == (False, False, 0)
    logger = MetricsLogger(str(tmp_path / "log"), verbose=False)
    assert not logger.uploader.enabled
    logger.log("x", {"v": 1.0})  # writes the JSONL and posts nothing
    assert os.path.isfile(logger.path)


def test_uploader_never_raises_into_the_run(capsys):
    """A collector that refuses connections: each call returns False, and
    after max_failures the uploader stops trying."""
    with collector() as (url, _):
        pass  # shut down: its port now refuses
    up = ExperimentUploader(url, timeout=1.0, max_failures=2)
    assert up.log_event("r", {"a": 1}) is False and up.log_event("r", {"a": 2}) is False
    assert not up.enabled and up.log_event("r", {"a": 3}) is False
    assert capsys.readouterr().err.count("[upload] POST failed") == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(8).add_(1.0)
    (name,) = os.listdir(tmp_path / "tr")
    events = json.loads((tmp_path / "tr" / name).read_text())["traceEvents"]
    assert any("add_" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("shape", [(5, 7), (6, 4, 3)])
def test_png_writer_round_trips(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = visualize.write_png(str(tmp_path / "x.png"), img)
    got = np.round(plt.imread(path) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, img)


def test_plots_take_the_jax_arguments_and_paths(tmp_path):
    rng = np.random.default_rng(1)
    scan = rng.normal(0, 5, (64, 3)).astype(np.float32)
    scan[:4] = 0.0
    mp = np.concatenate([rng.normal(0, 5, (100, 3)), np.full((8, 3), 1000.0)]).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    times = np.arange(6) * 100_000 + 7
    err = [rng.normal(0, 0.1, 6) for _ in range(3)]
    for mod, d in ((visualize, tmp_path / "t"), (jvis, tmp_path / "j")):
        got = [mod.save_mask_image(rng.random((16, 16)), str(d), "m"),
               mod.save_pointclouds(scan, mp, str(d), "pc"),
               mod.save_weighted_scan(scan, w, str(d), "w"),
               mod.save_loc_error_plots(times, *err, str(d), "seq")]
        assert got[:3] == [str(d / f"{n}.png") for n in ("m", "pc", "w")]
        assert got[3] == {"png": str(d / "seq_loc_errors.png"),
                          "csv": str(d / "seq_loc_errors.csv")}
    for name in ("pc.png", "w.png", "seq_loc_errors.png"):
        assert plt.imread(tmp_path / "t" / name).ndim == 3
    assert (tmp_path / "t" / "seq_loc_errors.csv").read_text() == (
        tmp_path / "j" / "seq_loc_errors.csv").read_text()
