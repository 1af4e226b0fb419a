"""Fast table loading backed by the ``_fastio`` C extension.

The port's copy of ``mind_the_gaps_tpu/io/fastio.py``, with its numpy
path and semantics unchanged.  This is host parsing, not a device kernel:
``_fastio.c`` (the port's copy of the JAX package's parser) is compiled by
the system C compiler at first use into the gitignored
``mind_the_gaps_tpu_torch/_build/``, under a name keyed by a hash of the
source and the Python headers, never into the package tree.  Without a
compiler everything falls back to numpy parsing with the same semantics.

API:
- ``load_table(path)`` -> (N, C) float64 array (QDP 'NO' -> NaN,
  comment/header lines skipped).
- ``load_columns(path)`` -> dict of column name -> array when the file
  has a header line, else numbered columns.
- ``load_directory(paths, workers=8)`` -> list of arrays, parsed in a
  thread pool (the C parser releases the GIL).
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np

__all__ = ["load_table", "load_columns", "load_directory", "have_native", "build_native", "parse_bytes"]

_SOURCE = Path(__file__).resolve().parent / "_fastio.c"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_state = {"module": None, "attempted": False}


def _ext_path() -> Path:
    include = sysconfig.get_paths()["include"]
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(include.encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return _BUILD_DIR / f"_fastio-{h.hexdigest()[:16]}{suffix}"


def build_native(force: bool = False) -> bool:
    """Compile ``_fastio.c`` into ``_build/`` (a temporary file, then an
    atomic rename).  Returns success."""
    out = _ext_path()
    if out.exists() and not force:
        return True
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    include = sysconfig.get_paths()["include"]
    cmd = [os.environ.get("CC", "cc"), "-O3", "-shared", "-fPIC", f"-I{include}", str(_SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        warnings.warn(f"_fastio build unavailable: {exc}")
        return False
    if res.returncode != 0:
        warnings.warn(f"_fastio build failed: {res.stderr[-500:]}")
        return False
    os.replace(tmp, out)
    return True


def _get_native():
    """The extension module, built and imported on first use (None when
    it cannot be)."""
    with _lock:
        if _state["module"] is not None or _state["attempted"]:
            return _state["module"]
        _state["attempted"] = True
        if not build_native():
            return None
        try:
            spec = importlib.util.spec_from_file_location("mind_the_gaps_tpu_torch.io._fastio", _ext_path())
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError as exc:  # pragma: no cover - platform specific
            warnings.warn(f"_fastio import failed: {exc}")
            return None
        _state["module"] = mod
        return mod


def have_native() -> bool:
    return _get_native() is not None


def _parse_numpy(data: bytes):
    """Pure-numpy fallback with the same line semantics as the C parser."""
    rows: List[List[float]] = []
    ncols = -1
    nskipped = 0
    for raw in data.decode("utf-8", errors="replace").splitlines():
        line = raw.strip().lstrip(",")
        if not line or line[0] in "!#;%":
            continue
        toks = line.replace(",", " ").split()
        vals = []
        ok = True
        for tok in toks:
            if tok.upper() == "NO" or tok.lower() == "nan":
                vals.append(np.nan)
                continue
            try:
                vals.append(float(tok))
            except ValueError:
                ok = False
                break
        if not ok or not vals:
            if ncols >= 0:
                nskipped += 1
            continue
        if ncols < 0:
            ncols = len(vals)
        if len(vals) != ncols:
            nskipped += 1
            continue
        rows.append(vals)
    arr = np.asarray(rows, dtype=np.float64) if rows else np.empty((0, max(ncols, 0)))
    return arr, nskipped


def parse_bytes(data: bytes, warn_skipped: bool = False) -> np.ndarray:
    """Parse an in-memory table; (N, C) float64 (always writable).

    ``warn_skipped``: warn when malformed or ragged rows were dropped (the
    C parser collapses consecutive delimiters, so an empty CSV field makes
    the row ragged)."""
    mod = _get_native()
    if mod is not None:
        buf, nrows, ncols, nskipped = mod.parse_table(data)
        # a copy: frombuffer over the returned bytes is read-only
        arr = np.frombuffer(buf, dtype=np.float64).reshape(nrows, ncols if nrows else 0).copy()
    else:
        arr, nskipped = _parse_numpy(data)
    if warn_skipped and nskipped:
        warnings.warn(
            f"table parse skipped {nskipped} malformed row(s) "
            "(ragged column count — empty delimited fields collapse)"
        )
    return arr


def load_table(path: str, warn_skipped: bool = True) -> np.ndarray:
    with open(path, "rb") as fh:
        return parse_bytes(fh.read(), warn_skipped=warn_skipped)


def _header_names(path: str) -> Optional[List[str]]:
    """Column names from the first non-empty line when it is a header."""
    with open(path, "r", errors="replace") as fh:
        for raw in fh:
            line = raw.strip()
            if not line:
                continue
            line = line.lstrip("!#;% ")
            toks = line.replace(",", " ").split()
            if not toks:
                continue
            try:
                float(toks[0])
                return None  # data line first: no header
            except ValueError:
                return toks
    return None


def load_columns(path: str) -> Dict[str, np.ndarray]:
    arr = load_table(path)
    names = _header_names(path)
    if names is None or len(names) != arr.shape[1]:
        names = [f"col{i}" for i in range(arr.shape[1])]
    return {name: arr[:, i] for i, name in enumerate(names)}


def load_directory(paths: Iterable[str], workers: int = 8) -> List[np.ndarray]:
    """Parse many files concurrently (the C parser releases the GIL, so
    threads run in parallel)."""
    paths = list(paths)
    if not paths:
        return []
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(load_table, paths))
