"""The port's data path vs the JAX package's on the CPU: the fixture writer,
Boreas CSV and calibration access, the radar decode (numpy and the native
library), the rosbag2 converter and pose graph, ``ICPWeightDataset``
(items bit for bit, with and without augmentation, and its u8 CFAR cache),
``epoch_batches`` and ``preprocess_batch``.

``preprocess_batch`` divides u8 by 255 correctly rounded on both sides
here (XLA's CPU divide and torch's agree with numpy's bit for bit on these
inputs); the warp is held within 1e-6 of the image's max, the limit of
``tests/test_torch_ops.py``'s warp test.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import zlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm_masking_tpu.config import Config as JConfig, DataConfig as JDataConfig
from mm_masking_tpu.config import ModelConfig as JModelConfig
from mm_masking_tpu.data import boreas as jboreas, native as jnative
from mm_masking_tpu.data.convert import convert_graph as jconvert_graph
from mm_masking_tpu.data.dataset import ICPWeightDataset as JDataset
from mm_masking_tpu.data.loader import _collate as jcollate, preprocess_batch as jpreprocess
from mm_masking_tpu.data.pose_graph import PoseGraph as JPoseGraph
from mm_masking_tpu.data.testing import write_synthetic_dataset as jwrite
from mm_masking_tpu import ops as jops
from mm_masking_tpu.ops import load_radar as jload_radar
from mm_masking_tpu_torch.config import Config, DataConfig, ModelConfig
from mm_masking_tpu_torch.data import ICPWeightDataset, epoch_batches, preprocess_batch
from mm_masking_tpu_torch.data import boreas, dataset as dataset_module, loader, native
from mm_masking_tpu_torch.data.convert import convert_graph, se3_exp_np
from mm_masking_tpu_torch.data.pose_graph import INVALID_ID, PoseGraph
from mm_masking_tpu_torch.data.testing import write_synthetic_dataset
from mm_masking_tpu_torch.ops import load_radar
from test_convert import _build_two_run_graph, encode_vtr_pointcloud, make_bag

PAIRS = [("synth-map", "synth-loc")]
POLAR = (64, 256)
MODEL = dict(res=15.0 / POLAR[1], polar_shape=POLAR, cart_pixel_width=64, cart_resolution=0.5)
WRITE = dict(n_frames=6, n_scan=100, n_map=300, polar_shape=POLAR)


def configs(root_j, root_t, **data):
    """The same configuration in both packages, each on its own tree."""
    kw = dict(max_loc_pts=100, max_map_pts=300, **data)
    j = JConfig(model=JModelConfig(**MODEL), data=JDataConfig(data_dir=str(root_j), **kw),
                train_loc_pairs=PAIRS, val_loc_pairs=PAIRS)
    t = Config(model=ModelConfig(**MODEL), data=DataConfig(data_dir=str(root_t), **kw),
               train_loc_pairs=PAIRS, val_loc_pairs=PAIRS)
    return j, t


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tree written by each package's writer."""
    root_j, root_t = tmp_path_factory.mktemp("jax_tree"), tmp_path_factory.mktemp("torch_tree")
    info_j = jwrite(str(root_j), **WRITE)
    info_t = write_synthetic_dataset(str(root_t), **WRITE)
    return root_j, root_t, info_j, info_t


def files(root) -> dict[str, str]:
    return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
            for d, _, fs in os.walk(root) for f in fs}


def assert_items_equal(a: dict, b: dict, where: str = "") -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_items_equal(a[k], b[k], f"{where}/{k}")
        return
    u, v = np.asarray(a), np.asarray(b)
    assert u.dtype == v.dtype and u.shape == v.shape, (where, u.dtype, v.dtype)
    np.testing.assert_array_equal(v, u, err_msg=where)


def test_writers_produce_identical_trees(trees):
    root_j, root_t, info_j, info_t = trees
    assert info_j == info_t
    fj, ft = files(root_j), files(root_t)
    written = {k for k in fj if not k.startswith("cfar")}
    assert written == {k for k in ft if not k.startswith("cfar")} and len(written) > 10
    for rel in sorted(written):
        if rel.endswith(".npz"):
            with np.load(fj[rel]) as a, np.load(ft[rel]) as b:
                assert_items_equal(dict(a), dict(b), rel)
        else:
            with open(fj[rel], "rb") as a, open(ft[rel], "rb") as b:
                assert a.read() == b.read(), rel


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("kind", ["train", "test"])
def test_dataset_items_match_jax(trees, kind, augment):
    """Every item equal bit for bit: T_init drawn from the one
    default_rng(99) at init, the augmentation's rotations drawn from it per
    item, in the same order; the CFAR plane is each package's own cache."""
    root_j, root_t, _, _ = trees
    jc, tc = configs(root_j, root_t, augment=augment)
    want, got = JDataset(PAIRS, jc, kind), ICPWeightDataset(PAIRS, tc, kind)
    assert len(got) == len(want) == WRITE["n_frames"]
    np.testing.assert_array_equal(np.stack(got.T_loc_init), np.stack(want.T_loc_init))
    stamps = []
    for i in range(len(want)):
        item = want[i]
        assert_items_equal(item, got[i], f"{kind} item {i}")
        stamps.append(int(item["loc_data"]["timestamp"]))
    stamp = stamps[2]
    assert_items_equal(want.get_item_from_loc_timestamp(stamp),
                       got.get_item_from_loc_timestamp(stamp))


def test_cfar_cache_is_u8_and_matches_jax(tmp_path):
    """Each package computes its cache on a miss: uint8 {0, 1}, and equal
    (no threshold tie flips between XLA's and torch's float32 cumulative
    sums on these scans); a legacy float32 cache is re-quantised in place."""
    root_j, root_t = tmp_path / "j", tmp_path / "t"
    jwrite(str(root_j), **WRITE)
    write_synthetic_dataset(str(root_t), **WRITE)
    jc, tc = configs(root_j, root_t, augment=False)
    want, got = JDataset(PAIRS, jc, "train"), ICPWeightDataset(PAIRS, tc, "train")
    for i in range(len(want)):
        a, b = want[i]["loc_data"]["fft_cfar"], got[i]["loc_data"]["fft_cfar"]
        assert b.dtype == np.uint8 and set(np.unique(b)) <= {0, 1}
        np.testing.assert_array_equal(b, a)
        cache = np.load(got.entries[i][2])
        assert cache.dtype == np.uint8
        np.testing.assert_array_equal(cache, b)
    assert int(np.load(got.entries[0][2]).sum()) > 0
    path = got.entries[1][2]
    legacy = np.load(path).astype(np.float32)
    np.save(path, legacy)
    np.testing.assert_array_equal(got[1]["loc_data"]["fft_cfar"], legacy.astype(np.uint8))
    assert np.load(path).dtype == np.uint8


def test_png_scans_need_a_decoder(trees, tmp_path):
    """A .png radar scan decodes through the native library, else cv2 or
    PIL; with none the error is the JAX package's."""
    png = tmp_path / "scan.png"
    img = np.random.default_rng(3).integers(0, 256, (9, 20)).astype(np.uint8)
    png.write_bytes(png_bytes(img))
    if native.available():
        np.testing.assert_array_equal(dataset_module._imread_gray(str(png)), img)
    blocked = {"cv2": None, "PIL": None, "PIL.Image": None}
    with mock.patch.object(native, "available", return_value=False), \
            mock.patch.dict("sys.modules", blocked):
        with pytest.raises(RuntimeError, match="no PNG decoder available"):
            dataset_module._imread_gray(str(png))


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG (zlib, filter 0) of img."""
    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    h, w = img.shape
    lines = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(lines)) + chunk(b"IEND", b""))


def raw_scan(seed=0, A=16, W=64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (A, W)).astype(np.uint8)
    ts = np.arange(A, dtype=np.int64) * 250 + 1_600_000_000_000
    raw[:, :8] = np.frombuffer(ts.tobytes(), np.uint8).reshape(A, 8)
    enc = (np.arange(A) * 5600 // A).astype(np.uint16)
    raw[:, 8:10] = np.frombuffer(enc.tobytes(), np.uint8).reshape(A, 2)
    return raw


@pytest.mark.parametrize("normalize", [True, False])
def test_load_radar_matches_jax(normalize):
    raw = raw_scan()
    for a, b in zip(jload_radar(raw, normalize=normalize), load_radar(raw, normalize=normalize)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)


def test_native_matches_jax():
    """The ctypes bindings to the repo's native/libfastload.so (or, where it
    does not load, the numpy paths) against the JAX package's."""
    assert native.available() == jnative.available()
    raws = [raw_scan(s) for s in range(3)]
    for a, b in zip(jnative.navtech_decode(raws[0]), native.navtech_decode(raws[0])):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(jnative.batch_navtech_decode(raws, 2), native.batch_navtech_decode(raws, 2)):
        np.testing.assert_array_equal(b, a)
    # The native decode multiplies by 1/255: within 1e-7 of numpy's divide,
    # the JAX package's own limit (tests/test_native.py).
    fft_n, az_n, ts_n = native.navtech_decode(raws[1])
    fft_p, az_p, ts_p = load_radar(raws[1])
    np.testing.assert_allclose(fft_n, fft_p, rtol=0, atol=1e-7)
    np.testing.assert_allclose(az_n, az_p, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ts_n, ts_p)
    src = np.random.default_rng(4).normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.pad_cloud(src, 16, 7.5), jnative.pad_cloud(src, 16, 7.5))
    if native.available():
        img = np.random.default_rng(5).integers(0, 256, (37, 53)).astype(np.uint8)
        np.testing.assert_array_equal(native.png_decode_gray8(png_bytes(img)), img)


def test_boreas_matches_jax(trees, tmp_path):
    root_j, _, _, _ = trees
    seq = os.path.join(root_j, "vtr_data", "synth-loc")
    csv = os.path.join(seq, "applanix", "radar_poses.csv")
    for dim in (2, 3):
        (pj, tj) = jboreas.read_traj_file_gt2(csv, dim)
        (pt, tt) = boreas.read_traj_file_gt2(csv, dim)
        assert tt == tj
        np.testing.assert_array_equal(np.stack(pt), np.stack(pj))
    for sensor in ("lidar", "radar"):
        np.testing.assert_array_equal(boreas.load_calib(seq, sensor),
                                      jboreas.load_calib(seq, sensor))
    R = boreas.yawPitchRollToRot(0.3, -0.2, 0.1)
    np.testing.assert_array_equal(R, jboreas.yawPitchRollToRot(0.3, -0.2, 0.1))
    assert boreas.rotToYawPitchRoll(R) == jboreas.rotToYawPitchRoll(R)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, [1.0, -2.0, 0.5]
    np.testing.assert_array_equal(boreas.get_inverse_tf(T), jboreas.get_inverse_tf(T))
    assert boreas.get_closest_index(7.4, [1, 5, 8]) == jboreas.get_closest_index(7.4, [1, 5, 8])
    pc = np.random.default_rng(6).normal(size=(7, 3)).astype(np.float32)
    boreas.dump_pc_to_file(pc, str(tmp_path / "t.bin"))
    jboreas.dump_pc_to_file(pc, str(tmp_path / "j.bin"))
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    np.testing.assert_array_equal(boreas.load_pc_from_file(str(tmp_path / "t.bin")),
                                  jboreas.load_pc_from_file(str(tmp_path / "j.bin")))


def test_convert_graph_matches_jax(tmp_path):
    """The graph walk and the flat pairing on bags made with the JAX
    package's own encoders: the same index and shards; the pose graph's
    vertices, edges, walk and teach lookups equal."""
    graph = tmp_path / "graph"
    _build_two_run_graph(graph, np.random.default_rng(0), n_repeat=5, broken_vertex=2)
    want = jconvert_graph(str(graph), str(tmp_path / "j"))
    got = convert_graph(str(graph), str(tmp_path / "t"))
    assert got == want and len(got["frames"]) == 3  # the sentinel and the broken vertex skip
    for name in got["frames"]:
        with np.load(tmp_path / "j" / name) as a, np.load(tmp_path / "t" / name) as b:
            assert_items_equal(dict(a), dict(b), name)

    jg, g = JPoseGraph.from_dir(str(graph)), PoseGraph.from_dir(str(graph))
    assert g.runs() == jg.runs() and g.number_of_edges == jg.number_of_edges
    assert {k: (v.id, v.stamp) for k, v in g.vertices.items()} == {
        k: (v.id, v.stamp) for k, v in jg.vertices.items()}
    walk = [(v.id, e.from_id) for v, e in g.temporal_iterator(g.get_vertex((1, 0)))]
    assert walk == [(v.id, e.from_id) for v, e in jg.temporal_iterator(jg.get_vertex((1, 0)))]
    assert walk[0][1] == INVALID_ID
    for v, _ in g.temporal_iterator(g.get_vertex((1, 0))):
        if v.minor == 2:
            continue
        assert g.closest_teach_vertex(v).id == jg.closest_teach_vertex(jg.vertices[v.id]).id

    rng = np.random.default_rng(1)
    xi_map = np.array([1.0, -0.5, 0.0, 0.0, 0.0, 0.3])
    frames = [((1_000_000 + i * 100_000) * 1000, rng.normal(size=(40 + i, 6)).astype(np.float32))
              for i in range(3)]
    flat = tmp_path / "flat"
    os.makedirs(flat)
    make_bag(str(flat / "graph_0.db3"), {
        "/vtr/radar_raw_point_cloud": [(ns, encode_vtr_pointcloud(p, np.zeros(6), ns))
                                       for ns, p in frames],
        "/vtr/radar_filtered_point_cloud": [(ns, encode_vtr_pointcloud(p, np.zeros(6), ns))
                                            for ns, p in frames],
        "/vtr/pointmap": [(frames[0][0], encode_vtr_pointcloud(
            rng.normal(size=(80, 6)).astype(np.float32), xi_map, 500_000_000))],
    })
    want = jconvert_graph(str(flat), str(tmp_path / "fj"), msg_prefix="radar_")
    got = convert_graph(str(flat), str(tmp_path / "ft"), msg_prefix="radar_")
    assert got == want and got["max_loc"] == 42
    for name in got["frames"]:
        with np.load(tmp_path / "fj" / name) as a, np.load(tmp_path / "ft" / name) as b:
            assert_items_equal(dict(a), dict(b), name)
    from mm_masking_tpu.data.convert import se3_exp_np as jse3_exp_np
    np.testing.assert_array_equal(se3_exp_np(xi_map), jse3_exp_np(xi_map))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("network_input_type", ["cartesian", "polar"])
def test_preprocess_batch_matches_jax(trees, network_input_type):
    """One collated batch of uint8 planes through both packages'
    preprocessing. u8/255: the port's is numpy's correctly rounded divide
    bit for bit (a table of it), JAX's (a reciprocal multiply) within 1 ulp; the cfar
    plane to float32 exactly. The warp: within 1e-6 of the image's max of
    the JAX package's ops run op by op on JAX's normalised planes; JAX's
    jitted preprocess_batch is itself up to 4e-5 of max off those ops on
    this batch (XLA's fused arithmetic), so against it the limit is 1e-4."""
    root_j, _, _, _ = trees
    jc, _ = configs(root_j, root_j, augment=True)
    ds = JDataset(PAIRS, jc, "train")
    batch = jcollate([ds[i] for i in range(4)])
    assert batch["loc_data"]["fft_data"].dtype == np.uint8
    assert batch["loc_data"]["timestamp"].dtype == np.int64
    tc = Config(model=ModelConfig(**MODEL, network_input_type=network_input_type))
    jcfg = dataclasses.replace(jc, model=dataclasses.replace(
        jc.model, network_input_type=network_input_type))
    want = jpreprocess(batch, jcfg)["loc_data"]
    got = preprocess_batch(to_torch(batch), tc)["loc_data"]
    u8 = batch["loc_data"]
    if network_input_type == "polar":
        np.testing.assert_array_equal(got["fft_data"].numpy(),
                                      np.divide(u8["fft_data"], 255.0, dtype=np.float32))
        np.testing.assert_array_max_ulp(got["fft_data"].numpy(), np.asarray(want["fft_data"]), 1)
        np.testing.assert_array_equal(got["fft_cfar"].numpy(), np.asarray(want["fft_cfar"]))
    else:
        polar = {"fft_data": np.asarray(jpreprocess(batch, dataclasses.replace(
            jc, model=dataclasses.replace(jc.model, network_input_type="polar")))[
                "loc_data"]["fft_data"]), "fft_cfar": u8["fft_cfar"].astype(np.float32)}
        m = jc.model
        for key in ("fft_data", "fft_cfar"):
            ops = np.asarray(jops.radar_polar_to_cartesian(
                jnp.asarray(polar[key]), jnp.asarray(u8["azimuths"]), m.res, m.cart_resolution,
                m.cart_pixel_width))
            g, w = got[key].numpy(), np.asarray(want[key])
            assert g.dtype == np.float32 and g.shape == w.shape == (4, 64, 64)
            np.testing.assert_allclose(g, ops, rtol=0, atol=1e-6 * np.abs(ops).max())
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    assert torch.equal(got["timestamp"], torch.from_numpy(u8["timestamp"]))


def test_epoch_batches_prefetch_matches_inline(trees):
    """The prefetched epoch equals the inline one (items, order and the
    augmentation's draws), as tensors on the asked device, int64 timestamps
    included; a final partial batch is kept without drop_last."""
    _, root_t, _, _ = trees
    _, tc = configs(root_t, root_t, augment=True)
    runs = []
    for prefetch in (0, 1):
        ds = ICPWeightDataset(PAIRS, tc, "train")
        runs.append(list(epoch_batches(ds, 4, tc, seed=3, prefetch=prefetch,
                                       drop_last=False, device="cpu")))
    inline, ahead = runs
    assert [len(b["transforms"]["T_ml_gt"]) for b in ahead] == [4, 2]
    for a, b in zip(inline, ahead):
        assert_items_equal({k: to_np(v) for k, v in a.items()},
                           {k: to_np(v) for k, v in b.items()})
    assert ahead[0]["loc_data"]["timestamp"].dtype == torch.int64
    assert ahead[0]["loc_data"]["fft_data"].dtype == torch.float32


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    return tree.numpy()


class _Faulty:
    """A dataset whose third item raises."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i == 2:
            raise KeyError("item 2 is broken")
        return self.ds[i]


def test_epoch_batches_surfaces_worker_errors_and_joins_an_abandoned_worker(trees):
    _, root_t, _, _ = trees
    _, tc = configs(root_t, root_t, augment=False)
    ds = ICPWeightDataset(PAIRS, tc, "train")
    it = epoch_batches(_Faulty(ds), 2, tc, shuffle=False, device="cpu")
    next(it)
    with pytest.raises(KeyError, match="item 2 is broken"):
        next(it)
    it = epoch_batches(ds, 2, tc, shuffle=False, device="cpu")
    next(it)
    it.close()  # abandoned after one batch: the worker is stopped and joined
    assert not any(t.name == "epoch_batches_prefetch" for t in threading.enumerate())


def test_loader_worker_makes_no_tensors(trees):
    """The worker only loads and collates numpy arrays: tensors (and any
    CUDA call) are made by the consumer, on its own thread."""
    _, root_t, _, _ = trees
    _, tc = configs(root_t, root_t, augment=False)
    threads = []
    real = loader.to_tensors

    def spy(batch, device):
        threads.append(threading.current_thread().name)
        return real(batch, device)

    with mock.patch.object(loader, "to_tensors", spy):
        list(epoch_batches(ICPWeightDataset(PAIRS, tc, "train"), 2, tc, device="cpu"))
    assert set(threads) == {threading.current_thread().name} and len(threads) > 3
