"""Batch assembly and on-device preprocessing (counterpart of
``mm_masking_tpu.data.loader``).

Host-side numpy collation, then one batched polar→cartesian warp on the
device, in place of the reference's ``DataLoader(num_workers=4)``
(``train_icp_weights.py:454-455``) and its per-item warps.

The polar image planes travel uint8 from disk to the device (fft raw power,
cfar {0, 1}: the reference's on-disk formats) and are normalised to the
model's float32 contract there. The prefetch worker only loads and collates
numpy arrays; the consumer makes the tensors, moves them to the device and
runs :func:`preprocess_batch`, so no CUDA call is made from another thread
while the train step's graph may be capturing.
"""
from __future__ import annotations

import functools
from typing import Iterator

import numpy as np
import torch

from mm_masking_tpu_torch.config import Config
from mm_masking_tpu_torch.ops import radar_polar_to_cartesian
from mm_masking_tpu_torch.parallel.mesh import ShardedBatch, shard_batch
from mm_masking_tpu_torch.utils import profiling


def _collate(items: list[dict]) -> dict:
    """Stack a list of sample dicts into one batch dict of numpy arrays
    (integer leaves, the timestamps, become int64 arrays)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _collate([it[k] for it in items]) for k in first}
    return np.stack(items, axis=0)


def to_tensors(batch, device: torch.device | str) -> dict:
    """A collated numpy batch as tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_tensors(v, device) for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)


@functools.lru_cache(maxsize=8)
def _u8_to_unit(device: torch.device) -> torch.Tensor:
    """u8/255 of every byte value: numpy's correctly rounded float32 divide
    (``radar_utils.py:26``), as a table on ``device``."""
    table = np.divide(np.arange(256, dtype=np.uint8), 255.0, dtype=np.float32)
    return torch.from_numpy(table).to(device)


def _norm_images(fft: torch.Tensor, cfar: torch.Tensor):
    """uint8 on the wire → the model's float32 contract. u8/255 is looked up
    in a table of numpy's divide, so it is the same bits on any device (a
    CUDA division by a host scalar multiplies by the reciprocal, an ulp off
    on some values, as XLA's does); float32 inputs (synthetic batches) pass
    through unchanged."""
    if fft.dtype == torch.uint8:
        fft = _u8_to_unit(fft.device)[fft.int()]
    if cfar.dtype == torch.uint8:
        cfar = cfar.to(torch.float32)
    return fft, cfar


def preprocess_batch(batch: dict, config: Config) -> dict:
    """Network-input preparation on the batch's device: u8 → float32
    normalisation, plus the polar→cartesian warp when configured.
    Downstream (trainer, policy, loss) always sees float32 images."""
    m = config.model
    loc = dict(batch["loc_data"])
    fft, cfar = _norm_images(loc["fft_data"], loc["fft_cfar"])
    if m.network_input_type == "cartesian":
        az = loc["azimuths"]
        fft = radar_polar_to_cartesian(fft, az, m.res, m.cart_resolution, m.cart_pixel_width)
        cfar = radar_polar_to_cartesian(cfar, az, m.res, m.cart_resolution,
                                        m.cart_pixel_width)
    loc["fft_data"], loc["fft_cfar"] = fft, cfar
    return {**batch, "loc_data": loc}


def epoch_batches(
    dataset,
    batch_size: int,
    config: Config,
    *,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    prefetch: int = 1,
    device: torch.device | str = "cuda",
    mesh=None,
) -> Iterator[dict]:
    """Yield preprocessed batches for one epoch, as tensors on ``device``.

    With a ``mesh`` every rank loads and collates the same global batches
    (the same items, and the same draws of the dataset's augmentation
    generator, as one device), then keeps its rows
    (:func:`~mm_masking_tpu_torch.parallel.shard_batch`), moves and
    preprocesses only them, and yields a ``ShardedBatch``; a batch whose
    size does not divide the mesh is kept whole.

    With ``prefetch > 0`` (default 1) a single worker thread loads and
    collates batch k+1 while the caller's step k runs. Exactly ONE worker, so
    the item order and the dataset's augmentation-RNG draws are those of the
    inline path (``prefetch=0``). An abandoned generator stops and joins its
    worker. Each wait of the caller on the worker's queue is a span
    ``mm.loader.wait`` and adds its nanoseconds to the host counter
    ``loader.wait_ns`` (:mod:`mm_masking_tpu_torch.utils.profiling`).
    """
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = n - (n % batch_size) if drop_last and n >= batch_size else n

    def produce() -> Iterator[dict]:
        for start in range(0, end, batch_size):
            idx = order[start : start + batch_size]
            yield _collate([dataset[int(i)] for i in idx])

    def finish(batch: dict) -> dict:
        if mesh is None:
            return preprocess_batch(to_tensors(batch, device), config)
        rows = shard_batch(batch, mesh)
        out = preprocess_batch(to_tensors(rows, device), config)
        return ShardedBatch(out, rows.start, rows.total) if isinstance(rows, ShardedBatch) else out

    if prefetch <= 0:
        for batch in produce():
            yield finish(batch)
        return

    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()
    _END = object()

    def worker():
        it = produce()
        while not stop.is_set():
            try:
                item = next(it)
            except StopIteration:
                item = _END
            except BaseException as e:  # surface errors to the consumer
                item = e
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if item is _END or isinstance(item, BaseException):
                return

    t = threading.Thread(target=worker, name="epoch_batches_prefetch", daemon=True)
    t.start()
    try:
        while True:
            with profiling.blocked("mm.loader.wait", "loader.wait_ns"):
                item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield finish(item)
    finally:
        # Stop AND join: an abandoned generator must not leave the worker
        # mid-item, racing a new epoch's iteration on the same dataset (the
        # augmentation np.random.Generator is not thread-safe). The worker
        # re-checks `stop` around every queue put, so the join terminates.
        stop.set()
        t.join()
