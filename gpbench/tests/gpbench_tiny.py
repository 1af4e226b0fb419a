"""Small sizes at which the tests drive the cells on the host, and limits
set for them (the chip's limits are in ``limits/``); the parked cells
(``parked/``) put back into a copy of BENCHMARK.json, so that the tests
still drive them."""
import atexit
import copy
import functools
import json
import shutil
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PARKED = ROOT / "gpbench" / "parked"

TINY = {
    "config": {"n_points": 64, "nsims": 15, "chunk": 8, "sim_max_steps": 80, "observed_max_steps": 60},
    "traffic": {"max_steps": 60, "warmup_steps": 10},
}
# set from runs at these sizes: sound runs read below them, the controls and
# the faults above
TINY_LIMITS = {
    "gauss.bootstrap": {"null_excess": 1e-7, "alt_err": 1e-8, "null_gap": 1.0, "alt_gap": 20.0, "gen_dist": 20.0},
    "gauss.observed": {"lp_err": 1e-8, "best_gap": 5.0, "width_dev": 3.0},
}
# 15 rows of 64 points leave the rates' skewness to the Poisson noise: pdf_skew_gap is read
# at the simulator's full size instead (test_gpbench_faults.py)
TINY_LIMITS["lognormal.bootstrap"] = dict(TINY_LIMITS["gauss.bootstrap"], pdf_skew_gap=10.0)
TINY_LIMITS["gauss4.bootstrap"] = dict(TINY_LIMITS["gauss.bootstrap"])
# the four-rank cell: calls of 63 sims at chunk 32, 8 refit rows a rank
TINY_RANKS = {"config": {"nsims": 63, "chunk": 32}}


def tiny(cell, **extra):
    out = {k: dict(v) for k, v in TINY.items()}
    out["limits"] = dict(TINY_LIMITS[cell])
    for key, value in extra.items():
        out[key].update(value)
    return out


def run_tiny(cell, seed=3_000_000_019, seconds=0.5, trace=False, control=False, **kw):
    from gpbench.run import run_cell

    return run_cell(cell, seed, seconds, trace, root=ROOT, device="cpu", overrides=tiny(cell),
                    control=control, **kw)


def with_parked(bench: dict) -> dict:
    """``bench`` with each parked cell of ``parked/`` put back: its
    configurations, cells and metrics, and its cells' names added to the
    metrics that it ``joins``."""
    out = copy.deepcopy(bench)
    for path in sorted(PARKED.glob("*.json")):
        parked = json.loads(path.read_text())
        for key in ("configs", "workloads", "per_layer"):
            out[key] += parked[key]
        joined = [m for m in out["end_to_end"] + out["per_layer"] if m["name"] in parked["joins"]]
        assert len(joined) == len(parked["joins"]), path
        for m in joined:
            m["workloads"] += [w["name"] for w in parked["workloads"]]
    return out


@functools.lru_cache(maxsize=None)
def parked_root() -> Path:
    """A root whose BENCHMARK.json holds the parked cells too, and whose
    ``gpbench`` is this one (a link): the harness runs those cells from
    there.  Removed when the process ends."""
    root = Path(tempfile.mkdtemp(prefix="gpbench-parked-"))
    atexit.register(shutil.rmtree, root, True)
    (root / "gpbench").symlink_to(ROOT / "gpbench")
    bench = with_parked(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def launch_tiny(cell="gauss4.bootstrap", seed=3_000_000_019, seconds=0.5, trace=False, **kw):
    """(exit code, result) of the (parked) cell run through the launcher as
    four gloo ranks on the host at the tiny sizes."""
    from gpbench.ranks import launch

    return launch(cell, seed, seconds, trace, ranks=4, root=parked_root(), device="cpu",
                  overrides=tiny(cell, **TINY_RANKS), **kw)


# plants the ranks call before they start ("gpbench.tests.gpbench_tiny:<name>")

def raise_in_window():
    """Rank 2's first call in the window (its second ``protassov_lrt``, after
    the warm-up) raises."""
    import os

    from mind_the_gaps_tpu_torch import lrt

    inner, calls = lrt.protassov_lrt, []

    def failing(*args, **kwargs):
        calls.append(1)
        if os.environ.get("RANK") == "2" and len(calls) == 2:
            raise RuntimeError("a failure planted on rank 2")
        return inner(*args, **kwargs)

    lrt.protassov_lrt = failing


def keep_t_dist():
    """Each ``protassov_lrt`` call's ``t_dist`` saved to
    ``$GPBENCH_TEST_OUT/t_dist.<rank>.<call>.npy`` (rank "one" in a run of
    one process)."""
    import os

    import numpy as np

    from mind_the_gaps_tpu_torch import lrt

    inner, calls = lrt.protassov_lrt, []

    def keeping(*args, **kwargs):
        res = inner(*args, **kwargs)
        name = f"t_dist.{os.environ.get('RANK', 'one')}.{len(calls)}.npy"
        np.save(os.path.join(os.environ["GPBENCH_TEST_OUT"], name), res.t_dist)
        calls.append(1)
        return res

    lrt.protassov_lrt = keeping


def hang_in_setup():
    """Rank 2's first ``protassov_lrt`` call (the set-up's warm-up) never
    returns."""
    import os
    import time

    from mind_the_gaps_tpu_torch import lrt

    inner = lrt.protassov_lrt

    def hanging(*args, **kwargs):
        if os.environ.get("RANK") == "2":
            time.sleep(3600)
        return inner(*args, **kwargs)

    lrt.protassov_lrt = hanging


def holds_jax():
    """Rank 3 holds a module named ``jax`` (a stand-in: the run has to refuse
    to print)."""
    import os
    import sys
    import types

    if os.environ.get("RANK") == "3":
        sys.modules["jax"] = types.ModuleType("jax")
