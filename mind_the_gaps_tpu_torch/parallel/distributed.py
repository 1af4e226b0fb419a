"""Processes: one mesh over several processes, one process a card, under
``torch.distributed``.

PyTorch port of what the JAX package takes from ``jax.distributed``
(``initialize``, ``shutdown``) and ``jax.experimental.multihost_utils``
(``process_allgather``), the layout of ``tests/test_multihost.py``: P
processes, each with L local devices, make one mesh of P x L positions, and
process p owns positions [p L, (p + 1) L) (``process_mesh``).  The rows of a
batch are cut over all positions by ``torch.tensor_split``, as on the mesh of
one process, so blocks may be uneven; each process runs only its own
positions' rows.

Start one process a card, e.g. ``torchrun --nproc_per_node=<cards>
script.py``, and call ``initialize()`` first in the script: it joins the
group from torchrun's environment and makes the rank's card current, so that
``device="cuda"`` means that card.  Under an initialized group
``default_mesh()`` is ``process_mesh()``.  Every rank runs the same program.

The backend is ``gloo`` on host tensors: NCCL refuses two ranks on one card,
and very little crosses processes:

- the refits' results, once a call of ``lrt.batched_max_loglike``: the (G,)
  best log-probabilities and (G, D) optima (about 14 KB at G = 513, D = 6,
  float32), by ``process_allgather``;
- one early-stop flag a step of a "gspmd" refit that has an early stop
  (``process_any``);
- the observed fits' posterior state, once a ``protassov_lrt``, from rank 0
  (``broadcast_bytes``), and a barrier after each checkpoint write;
- the rates (B, n) and E13 iteration counts (B,) of a
  ``Simulator.simulate_batch(mesh=)``, once a batch: each rank's E13 loop
  ends on its own, since a converged row is frozen and no row depends on
  another.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from mind_the_gaps_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "initialize",
    "shutdown",
    "is_initialized",
    "process_mesh",
    "process_allgather",
    "process_any",
    "broadcast_bytes",
    "barrier",
]

_rank_device: dict = {}  # "device": the device ``initialize`` gave this process


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"initialize: {name} is neither given nor set in the environment (torchrun sets it)")
    return int(os.environ[name])


def initialize(device="cuda", backend: str = "gloo", init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank``, ``world_size`` and the address (``init_method``, by default
    ``tcp://$MASTER_ADDR:$MASTER_PORT``) are read from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
    when not given.  On ``device="cuda"`` the rank's card is ``cuda:(LOCAL_RANK
    % device_count)`` (``LOCAL_RANK`` defaults to the rank), made current; a
    device that names its card keeps it.  Without a card it raises: pass
    ``device="cpu"`` for a group on the host."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device is visible; pass device='cpu' for a group on the host")
    elif device.type != "cpu":
        raise ValueError(f"initialize: device must be 'cuda' or 'cpu', not {device}")
    rank = _env_int("RANK") if rank is None else int(rank)
    world_size = _env_int("WORLD_SIZE") if world_size is None else int(world_size)
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr is None:
            raise ValueError("initialize: MASTER_ADDR is not set and no init_method is given")
        init_method = f"tcp://{addr}:{_env_int('MASTER_PORT')}"
    if device.type == "cuda":
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    _rank_device["device"] = device
    return device


def shutdown() -> None:
    """Leave the process group (no-op when there is none)."""
    if is_initialized():
        dist.destroy_process_group()
    _rank_device.clear()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_mesh(local_devices=None, axis_name: str = "batch") -> Mesh:
    """The mesh of every process's positions: this process's
    ``local_devices`` (by default the device ``initialize`` gave it, else the
    current card) at positions [p L, (p + 1) L).  Every process must pass the
    same number L.  Without a group, the mesh of this process alone."""
    if local_devices is None:
        device = _rank_device.get("device")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("process_mesh: no CUDA device is visible; pass local_devices=")
            device = torch.device("cuda", torch.cuda.current_device())
        local_devices = (device,)
    if not is_initialized():
        return Mesh(tuple(local_devices), axis_name)
    return Mesh(tuple(local_devices), axis_name, process_index=dist.get_rank(), process_count=dist.get_world_size())


def process_allgather(x, tiled: bool = True):
    """Every process's ``x`` gathered on every process, on ``x``'s device:
    concatenated along axis 0 in rank order (``tiled``), else stacked on a
    new leading axis.  The leading sizes may differ between processes
    (``tiled`` only): each block is padded to the largest, gathered and
    trimmed to its size.  Without a group, ``x`` itself (tiled)."""
    x = torch.as_tensor(x)
    if x.dim() == 0:
        x = x[None]
    if not is_initialized():
        return x if tiled else x[None]
    host = x.detach().cpu()
    wire = host.to(torch.uint8) if host.dtype == torch.bool else host
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(dist.get_world_size())]
    dist.all_gather(sizes, torch.tensor([wire.shape[0]], dtype=torch.int64))
    sizes = [int(s) for s in sizes]
    if not tiled and len(set(sizes)) > 1:
        raise ValueError(f"process_allgather(tiled=False) needs blocks of one size, got {sizes}")
    padded = wire.new_zeros((max(sizes),) + tuple(wire.shape[1:]))
    padded[: wire.shape[0]] = wire
    parts = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(parts, padded)
    parts = [p[:n] for p, n in zip(parts, sizes)]
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.to(dtype=x.dtype, device=x.device)


def process_any(flag) -> bool:
    """Whether ``flag`` is true on any process (a MAX ``all_reduce`` of one
    int); ``bool(flag)`` without a group."""
    flag = bool(flag)
    if not is_initialized():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def broadcast_bytes(data: Optional[bytes], src: int = 0) -> bytes:
    """Rank ``src``'s ``data`` on every process (the other ranks pass None);
    ``data`` itself without a group."""
    if not is_initialized():
        return data
    mine = dist.get_rank() == src
    size = torch.tensor([len(data) if mine else 0], dtype=torch.int64)
    dist.broadcast(size, src)
    buf = torch.frombuffer(bytearray(data), dtype=torch.uint8) if mine else torch.empty(int(size), dtype=torch.uint8)
    dist.broadcast(buf, src)
    return data if mine else buf.numpy().tobytes()


def barrier() -> None:
    """Wait for every process (no-op without a group)."""
    if is_initialized():
        dist.barrier()
