"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``mind_the_gaps_tpu_torch/_build/`` under a name keyed
by a hash of the source, every ``csrc/*.cuh`` header and the flags, so a
stale library is never loaded.  Nothing is built at import: the first
CUDA call builds.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "load_library", "device_scope", "stream_handle"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` goes."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(*names: str) -> List[Path]:
    """Compile each ``csrc/<name>.cu`` whose keyed library does not exist,
    one ``nvcc`` per source, all started together."""
    outs = [library_path(name) for name in names]
    running = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        running.append((name, out, tmp, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, out, tmp, proc in running:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[0]))
            _loaded[name] = lib
        return lib


def stream_handle(device) -> int:
    """The raw handle of ``device``'s current CUDA stream (the int of
    ``torch.cuda.current_stream(device).cuda_stream``), without building a
    Stream object: that costs more host time than a small kernel."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(device).cuda_stream
    return raw(torch.cuda.current_device() if device.index is None else device.index)


def device_scope(device):
    """Makes ``device`` (a CUDA torch.device) current for a launch; no
    device switch when it already is (a switch costs as much host time as
    a small kernel)."""
    import torch

    return contextlib.nullcontext() if device.index == torch.cuda.current_device() else torch.cuda.device(device)
