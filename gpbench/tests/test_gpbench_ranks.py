"""The rank path (``ranks.py``) on the host: four gloo ranks, the port's
plain versions, run through the launcher at the tiny sizes
(``gpbench_tiny.TINY_RANKS``: calls of 63 sims at chunk 32, 8 refit rows a
rank), the cell ``gauss4.bootstrap``, parked (``parked/``) and put back
for the tests.  On the chip the same path runs the cell over four cards."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from gpbench_tiny import ROOT, TINY_LIMITS, launch_tiny, parked_root

PLANTS = "gpbench.tests.gpbench_tiny"
RUN = (
    "import json, sys\n"
    "sys.path.insert(0, 'gpbench/tests')\n"
    "from gpbench_tiny import launch_tiny\n"
    "rc, res = launch_tiny(trace=True, plants=['gpbench.tests.gpbench_tiny:keep_t_dist'])\n"
    "print(json.dumps({'rc': rc, 'result': res}))\n"
)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced run through the launcher, in a process of its own, each
    rank keeping its calls' T distributions: (its standard output, the
    directory of the T distributions)."""
    out = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, GPBENCH_TEST_OUT=str(out))
    run = subprocess.run([sys.executable, "-c", RUN], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return run.stdout, out


def test_four_host_ranks_give_one_line_and_a_correct_result(traced):
    from gpbench.ranks import over_ranks, reduction
    from gpbench.run import PACKAGE_DIR, load_cell, load_module

    stdout, _ = traced
    lines = stdout.splitlines()
    assert len(lines) == 1  # the ranks print nothing on the launcher's standard output
    out = json.loads(lines[0])
    res = out["result"]
    assert out["rc"] == 0 and res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"]["count"] == 4 and len(res["per_rank"]) == 4 and list(res)[-1] == "checks"
    assert {"generation_ms_per_sim", "refits_ms_per_sim", "mesh_wait_ms_per_step"} <= set(res["metrics"])
    cell = load_cell("gauss4.bootstrap", parked_root(), [PACKAGE_DIR])
    for m in cell.per_layer:
        if m["name"] in res["metrics"]:
            how = reduction(load_module([PACKAGE_DIR], "metrics", m["name"]))
            ranks = [r["metrics"][m["name"]] for r in res["per_rank"]]
            assert res["metrics"][m["name"]]["value"] == pytest.approx(over_ranks(how, ranks))
    assert res["metrics"]["mesh_wait_ms_per_step"]["value"] > 0


def test_the_ranks_give_one_process_s_t_dist_bit_for_bit(traced, tmp_path, monkeypatch):
    """One process runs the cell unsharded at the same chunk (as the readings
    that set its limits do): the same T distributions, bit for bit."""
    from gpbench.run import run_cell
    from gpbench_tiny import TINY_RANKS, keep_t_dist, tiny
    from mind_the_gaps_tpu_torch import lrt

    _, ranks_out = traced
    monkeypatch.setattr(lrt, "protassov_lrt", lrt.protassov_lrt)
    monkeypatch.setenv("GPBENCH_TEST_OUT", str(tmp_path))
    monkeypatch.delenv("RANK", raising=False)
    keep_t_dist()
    assert run_cell("gauss4.bootstrap", 3_000_000_019, 0.5, False, root=parked_root(), device="cpu",
                    overrides=tiny("gauss4.bootstrap", **TINY_RANKS))["correct"] is True
    for call in (0, 1):  # the warm-up call and the window's first
        one = np.load(tmp_path / f"t_dist.one.{call}.npy")
        assert one.shape == ((31,) if call == 0 else (63,))
        for rank in range(4):
            assert np.array_equal(np.load(ranks_out / f"t_dist.{rank}.{call}.npy"), one), (rank, call)


def test_a_rank_that_raises_ends_every_rank_within_the_limit():
    t0 = time.monotonic()
    rc, res = launch_tiny(plants=[f"{PLANTS}:raise_in_window"], limit_s=300)
    assert rc != 0 and res is None
    assert time.monotonic() - t0 < 300


def test_a_rank_that_hangs_is_ended_at_the_limit():
    t0 = time.monotonic()
    rc, res = launch_tiny(plants=[f"{PLANTS}:hang_in_setup"], limit_s=30)
    assert rc == 1 and res is None
    assert 30 <= time.monotonic() - t0 < 60


def test_a_rank_that_holds_jax_ends_the_run_with_4():
    rc, res = launch_tiny(plants=[f"{PLANTS}:holds_jax"])
    assert rc == 4 and res is None


def test_a_dropped_gather_is_not_correct():
    rc, res = launch_tiny(plants=["gpbench.faults:dropped_gather"])
    assert rc == 0 and res["correct"] is False
    limits = TINY_LIMITS["gauss4.bootstrap"]
    assert res["checks"]["null_gap"]["value"] > limits["null_gap"] or \
        res["checks"]["alt_gap"]["value"] > limits["alt_gap"]

