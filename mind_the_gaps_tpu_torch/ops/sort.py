"""Batched stable sort and the E13 rank-order remap: CUDA kernel and plain
versions.

``sort_kv(keys, vals)``: (B, m) keys and values of one float dtype (float32,
or float64 for the draws the E13 loop sorts once) sorted ascending along the
last axis, the values carried.  ``rank_remap(adj, sorted_draws)``: (B, m)
float32; returns ``perm`` (B, m) int64 = ``argsort(-adj)`` and ``xnew``
(B, m) float32 with ``xnew[b, perm[b, i]] = sorted_draws[b, i]``.

Both equal the stable sort bit for bit, ties and -0.0 / +0.0 included (the
JAX package's Pallas network was unstable on ties; its XLA path, like this
op, is stable).  Any B >= 1 and m >= 1: the kernel pads rows to a power of
two itself.

Tiers (``sort_tier``, from m and the dtype): rows padded to n = the next
power of two >= max(m, one warp's elements: 512 float32, 1024 float64);
n <= 16384 is one CTA a row ("tile"); n <= 131072 a thread-block cluster
of n / 16384 CTAs ("cluster"); longer rows the "two-level" tier, which
alone needs a device-memory scratch.  A refused cluster launch raises.

A CPU tensor goes to the plain version (``sort_kv_plain``:
``torch.sort(stable=True)`` and a gather; ``rank_remap_plain``:
``torch.argsort(stable=True)`` and a scatter).  A CUDA tensor launches
``csrc/bitonic_sort.cu`` on the current stream, or raises.  ``launches`` on
each wrapper counts its kernel launches (one per call; the two-level tier's
passes run inside that call).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from mind_the_gaps_tpu_torch.ops._build import device_scope, load_library, stream_handle

__all__ = ["sort_kv", "sort_kv_plain", "rank_remap", "rank_remap_plain", "sort_tier", "padded_length"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SORT_ENTRY = {torch.float32: "bitonic_sort_kv_f32", torch.float64: "bitonic_sort_kv_f64"}
MIN_TILE = {torch.float32: 512, torch.float64: 1024}  # Geom<K>::kMinTile in the .cu
MAX_TILE, MAX_CLUSTER = 16384, 8  # kMaxTile, kMaxCluster
TIERS = ("tile", "cluster", "two-level")


def padded_length(m: int, dtype=torch.float32) -> int:
    """The kernel's row length: the next power of two >= max(m, one warp's
    elements)."""
    return max(MIN_TILE[dtype], 1 << max(m - 1, 0).bit_length())


def sort_tier(m: int, dtype=torch.float32):
    """(tier, CTAs a row) for rows of length m >= 1: ("tile", 1),
    ("cluster", 2 | 4 | 8) or ("two-level", n / tile)."""
    if m < 1 or dtype not in _SORT_ENTRY:
        raise ValueError(f"sort_tier takes m >= 1 and float32 or float64, got {m}, {dtype}")
    n = padded_length(m, dtype)
    if n <= MAX_TILE:
        return "tile", 1
    return ("cluster" if n <= MAX_TILE * MAX_CLUSTER else "two-level"), n // MAX_TILE


@functools.lru_cache(maxsize=None)
def _entry(name):
    fn = getattr(load_library("bitonic_sort"), name)
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _P]
    fn.restype = ctypes.c_int
    return fn


def _scratch(x):
    """The two-level tier's (B, n) scratch: the encoded int64 keys and, for
    float64 keys, int32 indices; else (None, None)."""
    B, m = x.shape
    if sort_tier(m, x.dtype)[0] != "two-level":
        return None, None
    n = padded_length(m, x.dtype)
    idx = torch.empty((B, n), dtype=torch.int32, device=x.device) if x.dtype == torch.float64 else None
    return torch.empty((B, n), dtype=torch.int64, device=x.device), idx


def _check(name, a, b, dtypes):
    if a.shape != b.shape or a.dim() != 2:
        raise ValueError(f"{name} takes two (B, m) tensors of one shape, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in dtypes or b.dtype != a.dtype:
        raise TypeError(f"{name} takes {' or '.join(str(d) for d in dtypes)} tensors, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{name}: both tensors must be on one device")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {a.device}")


def _launch(name, fn, args):
    with device_scope(args[0].device):
        stream = stream_handle(args[0].device)
        rc = fn(*(None if a is None else a.data_ptr() for a in args), args[0].shape[0], args[0].shape[1], stream)
    if rc != 0:
        raise RuntimeError(f"bitonic_sort {name} kernel launch failed (code {rc})")


def sort_kv_plain(keys, vals):
    """Stable ascending sort of ``keys`` along the last axis, ``vals``
    carried."""
    out_keys, order = torch.sort(keys, dim=-1, stable=True)
    return out_keys, torch.gather(vals, -1, order)


def rank_remap_plain(adj, sorted_draws):
    """(perm, xnew): the stable ``argsort(-adj)`` and the draws scattered to
    those ranks."""
    perm = torch.argsort(-adj, dim=-1, stable=True)
    return perm, torch.empty_like(sorted_draws).scatter_(-1, perm, sorted_draws)


def sort_kv(keys, vals):
    """(keys, vals) sorted ascending along the last axis, stable."""
    _check("sort_kv", keys, vals, tuple(_SORT_ENTRY))
    if keys.device.type == "cpu":
        return sort_kv_plain(keys, vals)
    keys, vals = keys.contiguous(), vals.contiguous()
    keys_out, vals_out = torch.empty_like(keys), torch.empty_like(vals)
    if keys.numel():
        _launch("sort_kv", _entry(_SORT_ENTRY[keys.dtype]), (keys, vals, keys_out, vals_out, *_scratch(keys)))
        sort_kv.launches += 1
    return keys_out, vals_out


def rank_remap(adj, sorted_draws):
    """(perm int64, xnew float32): ``perm = argsort(-adj)`` (stable) and
    ``xnew[b, perm[b, i]] = sorted_draws[b, i]``."""
    _check("rank_remap", adj, sorted_draws, (torch.float32,))
    if adj.device.type == "cpu":
        return rank_remap_plain(adj, sorted_draws)
    adj, sorted_draws = adj.contiguous(), sorted_draws.contiguous()
    perm = torch.empty(adj.shape, dtype=torch.int64, device=adj.device)
    xnew = torch.empty_like(sorted_draws)
    if adj.numel():
        _launch("rank_remap", _entry("bitonic_rank_remap_f32"), (adj, sorted_draws, perm, xnew, *_scratch(adj)))
        rank_remap.launches += 1
    return perm, xnew


sort_kv.launches = 0
rank_remap.launches = 0
