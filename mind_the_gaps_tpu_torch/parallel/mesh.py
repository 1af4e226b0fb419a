"""Mesh and sharding helpers.

PyTorch port of ``mind_the_gaps_tpu/parallel/mesh.py``.  The parallel axes
of this workload are pure batch axes (bootstrap simulations x walkers, the
observed fit's walkers or chains): a likelihood sweep needs no
communication between rows, so the multi-card strategy is data
parallelism over a 1-D mesh, and the only transfers are the row blocks
out and the per-row results back.

PyTorch has no global array sharded over devices, so a sharded batch is a
list of ``mesh.size`` contiguous row blocks, block k on ``mesh.devices[k]``
(``shard_batch``), and ``gather`` concatenates them again.  A device may
appear in a mesh more than once: ``Mesh((torch.device("cpu"),) * 4)``
shards on a host without a card, ``Mesh((cuda:0, cuda:0))`` on one card.

A mesh may span processes (``parallel.distributed.process_mesh``): then
``devices`` are this process's L devices, at the positions
``local_positions`` of the ``size`` = L x ``process_count`` positions, and
this process holds only their blocks.  A mesh of one process holds every
position.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Mesh", "default_mesh", "shard_batch", "pad_to_multiple", "gather"]


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: an ordered tuple of ``torch.device``s, those of process
    ``process_index`` of ``process_count`` (every process has as many).
    ``axis_name`` is the JAX mesh's axis name, kept for its signature;
    nothing reads it."""

    devices: tuple
    axis_name: str = "batch"
    process_index: int = 0
    process_count: int = 1

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process_index {self.process_index} is not one of {self.process_count} processes")
        object.__setattr__(self, "devices", devices)

    @property
    def size(self) -> int:
        """Positions of the whole mesh, over every process."""
        return len(self.devices) * self.process_count

    @property
    def local_positions(self) -> range:
        """This process's positions, those of ``devices`` in order."""
        n = len(self.devices)
        return range(self.process_index * n, (self.process_index + 1) * n)


def default_mesh(axis_name: str = "batch", devices=None) -> Mesh:
    """1-D mesh over ``devices``, by default every visible CUDA device in
    index order; raises when there is no card and no ``devices`` (it never
    falls back to the CPU).  Under an initialized process group it is
    ``parallel.distributed.process_mesh(devices)``: each rank's own card (or
    ``devices``), not every card each rank can see."""
    from mind_the_gaps_tpu_torch.parallel import distributed

    if distributed.is_initialized():
        return distributed.process_mesh(devices, axis_name)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("default_mesh: no CUDA device is visible; pass devices= for a mesh of others")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(tuple(devices), axis_name)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad axis 0 so its length divides ``multiple``; returns (padded, n)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(np.asarray(x), pad_widths, mode="edge"), n


def shard_batch(x, mesh: Mesh):
    """The leading axis of ``x`` cut into ``mesh.size`` contiguous row
    blocks (``torch.tensor_split``: the first ``len(x) % mesh.size`` blocks
    hold one row more, and blocks may be empty), this process's blocks, in
    order, each moved to its device; a list."""
    blocks = torch.tensor_split(torch.as_tensor(x), mesh.size)
    return [blocks[k].to(device) for k, device in zip(mesh.local_positions, mesh.devices)]


def gather(shards, device):
    """The row blocks of ``shard_batch`` concatenated again on ``device``
    (this process's blocks: across processes, ``process_allgather``)."""
    return torch.cat([s.to(device) for s in shards])
