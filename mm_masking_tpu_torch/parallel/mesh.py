"""Data parallelism over cards: one process a card, the batch split over
them (counterpart of ``mm_masking_tpu.parallel.mesh``).

The JAX package shards the batch over a 1-D device mesh and writes every
reduction against the global batch, so that N devices give the one-device
result up to reduction order. The port keeps that contract with
``torch.distributed``: every rank holds the parameters, takes its rows of
each batch (:func:`shard_batch`), and reduces across the ranks wherever the
one-device code reduces over the batch: :meth:`Mesh.mean`, :meth:`Mesh.sum`,
:meth:`Mesh.max` and :meth:`Mesh.min` on the values each rank computed from
its rows, :meth:`Mesh.gather` to collect per-item results in rank order. A
batch whose leading dimension does not divide the mesh is replicated: every
rank computes the whole batch, and nothing is reduced across ranks.

The group is the caller's (``torchrun`` sets the environment that
:func:`init_distributed` reads). Its backend follows the device:
:func:`backend_for` gives NCCL on the card and gloo on the CPU. NCCL's
collectives can be captured in a CUDA graph; gloo's cannot, so a gloo group
over CUDA tensors runs only eagerly (``ops.kernels.eager()``).
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks over ``group`` (None: the trivial mesh
    of one process, which reduces nothing); this process is ``rank`` and
    computes on ``device``."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    def sum(self, x: torch.Tensor, *, local_grad: bool = False) -> torch.Tensor:
        """Σ over the ranks of x, differentiable. Its backward is the
        identity where every rank goes on to compute the same (replicated)
        value from the sum, as a loss; with ``local_grad`` each rank's use
        of the sum is its own (batch-norm statistics that normalise the
        rank's rows), and the backward sums the cotangents over the ranks."""
        if self.group is None:
            return x
        return _AllReduce.apply(x, self.group, local_grad)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the ranks of a per-rank mean over equal shards: the
        global mean, differentiable (identity backward, as :meth:`sum`)."""
        if self.group is None:
            return x
        return self.sum(x) / self.size

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MIN)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        """Elementwise ``op`` over the ranks, no gradient."""
        if self.group is None:
            return x
        y = x.detach().clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A boolean true on some rank, as a boolean on every rank."""
        return self.max(flag.to(torch.int32)) > 0

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated on dim 0 in rank order (no gradient)."""
        if self.group is None:
            return x
        flag = x.dtype == torch.bool  # gloo gathers no booleans
        x = x.detach().to(torch.uint8 if flag else x.dtype).contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        out = torch.cat(parts)
        return out.bool() if flag else out

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's x, in place on every rank."""
        if self.group is not None:
            dist.broadcast(x, src=dist.get_global_rank(self.group, 0), group=self.group)
        return x

    def divides(self, n: int) -> bool:
        return n % self.size == 0


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, local_grad):
        ctx.group, ctx.local_grad = group, local_grad
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.local_grad:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


def backend_for(device: torch.device | str) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device: torch.device | str) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
    ``LOCAL_RANK``) with :func:`backend_for`'s backend, and return this
    rank's device: ``cuda:LOCAL_RANK`` for a CUDA ``device``, else the CPU.
    Outside ``torchrun`` (no ``WORLD_SIZE``) it joins nothing and returns
    ``device``."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device),
                            device_id=device if device.type == "cuda" else None)
    return device


def make_mesh(num_devices: int = -1, device: torch.device | str | None = None) -> Mesh:
    """A mesh over the first ``num_devices`` ranks of the initialised
    process group (-1: all of them), computing on ``device`` (default: this
    rank's current card under NCCL, else the CPU). Without a group it is the
    trivial mesh of this process. Raises when ``num_devices`` exceeds the
    world size, or when this rank lies outside the mesh."""
    if not dist.is_initialized():
        if num_devices > 1:
            raise ValueError(f"a mesh of {num_devices} needs an initialised process group "
                             f"of that many ranks; none is initialised")
        return Mesh(None, 0, 1, torch.device(device or "cpu"))
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if num_devices <= 0 else num_devices
    if n > world:
        raise ValueError(f"num_devices={num_devices} exceeds the world size {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} lies outside a mesh of the first {n} ranks")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return Mesh(group, rank, n, torch.device(device))


class ShardedBatch(dict):
    """This rank's rows of a global batch of ``total`` rows, from row
    ``start`` (a dict of tensors or arrays, as the batch was)."""

    def __init__(self, rows: dict, start: int, total: int):
        super().__init__(rows)
        self.start, self.total = start, total


def _rows(x, start: int, stop: int):
    if isinstance(x, dict):
        return {k: _rows(v, start, stop) for k, v in x.items()}
    return x[start:stop]


def _leading(batch) -> int | None:
    if isinstance(batch, dict):
        for v in batch.values():
            n = _leading(v)
            if n is not None:
                return n
        return None
    shape = getattr(batch, "shape", ())
    return shape[0] if len(shape) else None


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a batch (nested dicts of (B, …) tensors or
    arrays): a :class:`ShardedBatch` of B / size rows. A batch whose B does
    not divide the mesh (a validation remainder) comes back whole and
    unmarked: every rank computes all of it, as the JAX package replicates
    such arrays. A batch already sharded comes back as it is."""
    if isinstance(batch, ShardedBatch):
        return batch
    total = _leading(batch)
    if mesh.group is None or total is None or not mesh.divides(total):
        return batch
    per = total // mesh.size
    start = mesh.rank * per
    return ShardedBatch(_rows(batch, start, start + per), start, total)


def batch_mesh(batch, mesh: Mesh | None) -> Mesh | None:
    """The mesh a batch's reductions run over: ``mesh`` for a
    :class:`ShardedBatch`, None for a replicated (or unsharded) one."""
    if mesh is None or mesh.group is None or not isinstance(batch, ShardedBatch):
        return None
    return mesh


def shard_axis(x: torch.Tensor, mesh: Mesh, axis: int = 1) -> torch.Tensor:
    """This rank's slice of dimension ``axis`` of x, or x whole where that
    dimension is missing or does not divide the mesh (the JAX package's
    ``shard_axis``)."""
    if mesh.group is None or x.ndim <= axis or not mesh.divides(x.shape[axis]):
        return x
    per = x.shape[axis] // mesh.size
    return x.narrow(axis, mesh.rank * per, per)


def replicate(tensors, mesh: Mesh):
    """Rank 0's values of a tensor or a dict of tensors, in place on every
    rank (the JAX package's ``replicate``)."""
    if isinstance(tensors, dict):
        for v in tensors.values():
            replicate(v, mesh)
        return tensors
    with torch.no_grad():
        mesh.broadcast(tensors)
    return tensors
