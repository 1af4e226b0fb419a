"""``mind_the_gaps_tpu_torch.bench`` (the port's benchmark) against the JAX
repo's ``bench.py``, on the CPU.

The JAX bench is loaded as a module from its file.  Its watchdog thread is
replaced by a no-op, and its phase marker by a stub that reads the caller's
locals at "imports done" and stops the run there, so its data are read from
the program itself and nothing of it is compiled or timed; its bootstrap
chunk's rows are read the same way, from the arguments its runner is
lowered with (``mind_the_gaps_tpu.lrt._make_batched_max_loglike`` stubbed).

- The data stream (t, y, diag, the kernel's vector) and the bootstrap
  chunk's rows equal ``bench.py``'s bit for bit.
- The primary sweep at B=16, N=500 equals the JAX package's
  ``solver.batched.batched_log_likelihood`` over ``jax.vmap(kernel.coefficients)``
  on the same rows: rtol 1e-8 in float64; within 0.5 in float32 (the JAX
  bench's gate-2 tolerance) and the float32 sweep within 1.0 of the JAX
  float64 one (its gate-1 tolerance).
- Each gate, fed a mismatch (the op monkeypatched), ends ``main`` with exit
  code 1 and the error record as the JSON line, and no sweep runs through
  the plain version after it.
- ``main`` at tiny sizes on the CPU prints one JSON line with ``KEYS`` (the
  JAX bench's keys among them, its metric string letter for letter), every
  phase's numbers finite.
- Importing the module starts no thread and touches no card.
"""
import importlib.util
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mind_the_gaps_tpu.lrt as j_lrt  # noqa: E402
from mind_the_gaps_tpu.kernels import DampedRandomWalk as JDRW  # noqa: E402
from mind_the_gaps_tpu.kernels import Lorentzian as JLorentzian  # noqa: E402
from mind_the_gaps_tpu.solver.batched import batched_log_likelihood as j_batched_log_likelihood  # noqa: E402
from mind_the_gaps_tpu_torch import bench  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "bench.py"
# the JAX bench's JSON keys (bench.py:323-327, 396-402, 431-433, 467-471,
# 521-525, 560) but the TPU estimate and the watchdog's "skipped"
JAX_KEYS = (
    "metric", "value", "unit", "vs_baseline", "bootstrap_chunk_sims", "bootstrap_walkers", "bootstrap_steps",
    "bootstrap_early_stop", "bootstrap_scaled_from_chunk", "bootstrap_chunk_seconds_null",
    "bootstrap_chunk_seconds_alt", "bootstrap_10k_seconds", "e13_lognormal_lcs_per_sec",
    "derive_posteriors_4k_seconds", "derive_posteriors_steps", "derive_posteriors_walkers",
    "lrt_512_measured_seconds", "lrt_512_t_obs", "lrt_512_p_value",
)
# run()'s sizes for the CPU: N=400, batch 64, a chunk of 4 x 4 walkers x 10
# steps, E13 B=4, 8 x 30 derive_posteriors, lrt_512 at 8 simulations
TINY = dict(n_points=400, batch=64, chunk_sims=4, boot_walkers=4, boot_steps=10, e13_batch=4, dp_steps=30,
            dp_walkers=8, lrt_nsims=8, lrt_observed_steps=30, lrt_sim_steps=10)


class _Captured(Exception):
    def __init__(self, values):
        super().__init__("captured")
        self.values = values


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("_jax_bench", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module._watchdog = lambda: None
    return module


def _jax_data(jax_bench, monkeypatch):
    """(t, y, diag, theta0) of the JAX bench's ``main``, read at its
    "imports done" mark."""
    def mark(msg):
        if msg == "imports done":
            local = sys._getframe(1).f_locals
            raise _Captured({k: local[k] for k in ("t", "y", "diag", "theta0")})

    monkeypatch.setattr(jax_bench, "_mark", mark)
    with pytest.raises(_Captured) as got:
        jax_bench.main()
    return got.value.values


def test_data_stream_equals_the_jax_bench(jax_bench, monkeypatch):
    ref = _jax_data(jax_bench, monkeypatch)
    t, y, diag, kernel = bench.data()
    for name, mine in (("t", t), ("y", y), ("diag", diag)):
        assert mine.dtype == ref[name].dtype and np.array_equal(mine, ref[name]), name
    assert np.array_equal(kernel.get_parameter_vector(), np.asarray(ref["theta0"]))


@pytest.mark.parametrize("chunk_sims", [16, 512])
def test_bootstrap_rows_equal_the_jax_bench(jax_bench, monkeypatch, chunk_sims):
    class Runner:
        def lower(self, key, ys, diags, theta0, percent):
            raise _Captured((np.asarray(ys), np.asarray(diags)))

    monkeypatch.setattr(j_lrt, "_make_batched_max_loglike", lambda *a, **k: Runner())
    t, y, diag, _ = bench.data()
    with pytest.raises(_Captured) as got:
        jax_bench._bootstrap_chunk_seconds(t, y, diag, chunk_sims=chunk_sims)
    ys_ref, diags_ref = got.value.values
    ys, diags = bench.bootstrap_rows(y, diag, chunk_sims)
    assert ys.dtype == np.float32 and ys.shape == (chunk_sims, 5000)
    assert np.array_equal(ys, ys_ref) and np.array_equal(diags, diags_ref)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sweep_matches_jax_batched_log_likelihood(dtype):
    t, y, diag, kernel = bench.data(500)
    j_kernel = JDRW(log_S0=1.0, log_omega0=-3.0) + JLorentzian(log_S0=-1.0, log_Q=2.0, log_omega0=-2.0)
    rows = (kernel.get_parameter_vector() + 0.05 * np.random.default_rng(3).standard_normal((16, 5))).astype(dtype)
    cols = [a.astype(dtype) for a in (t, y, diag)]
    mine = bench.sweep(kernel, torch.as_tensor(rows), *(torch.as_tensor(a) for a in cols)).numpy()
    ref = np.asarray(j_batched_log_likelihood(jax.vmap(j_kernel.coefficients)(jnp.asarray(rows)),
                                              *(jnp.asarray(a) for a in cols)))
    assert mine.dtype == dtype and np.all(np.isfinite(mine))
    if dtype == np.float64:
        np.testing.assert_allclose(mine, ref, rtol=1e-8)
    else:
        assert np.max(np.abs(mine.astype(np.float64) - ref)) <= 0.5
        ref64 = np.asarray(j_batched_log_likelihood(jax.vmap(j_kernel.coefficients)(jnp.asarray(rows, jnp.float64)),
                                                    *(jnp.asarray(a) for a in (t, y, diag))))
        assert np.max(np.abs(mine.astype(np.float64) - ref64)) <= 1.0


@pytest.mark.parametrize("gate, shift, calls", [
    # gate 1: the float32 values 2.0 off the float64 ones on its 8 rows
    ("f32/f64 mismatch", lambda c: 2.0 if c.ar.dtype == torch.float32 else 0.0, {"op": 2, "plain": 0}),
    # gate 2: the batch's sweep 1.0 off the plain version (gate 1's rows untouched)
    ("kernel/plain mismatch", lambda c: 1.0 if c.ar.shape[0] > 8 else 0.0, {"op": 3, "plain": 1}),
], ids=["gate1", "gate2"])
def test_a_failed_gate_exits_1_without_a_fallback(monkeypatch, capsys, gate, shift, calls):
    seen = {"op": 0, "plain": 0}
    op, plain = bench.celerite_log_likelihood, bench.batched_log_likelihood

    def shifted_op(coeffs, *args, **kwargs):
        seen["op"] += 1
        return op(coeffs, *args, **kwargs) + shift(coeffs)

    def counted_plain(*args, **kwargs):
        seen["plain"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(bench, "celerite_log_likelihood", shifted_op)
    monkeypatch.setattr(bench, "batched_log_likelihood", counted_plain)
    with pytest.raises(SystemExit) as ended:
        bench.main(["--device", "cpu"], **TINY)
    assert ended.value.code == 1
    lines = capsys.readouterr().out.strip().splitlines()
    record = json.loads(lines[-1])
    assert len(lines) == 1 and record["value"] == 0.0 and record["error"].startswith(gate)
    assert seen == calls


def test_main_prints_the_json_line_on_the_cpu(capsys):
    out = bench.main(["--device", "cpu"], **TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert tuple(line) == bench.KEYS and set(JAX_KEYS) <= set(line)
    metric = re.search(r'"metric": "(GP loglike evals/sec \(N=5k, DRW\+QPO[^"]*)"', SCRIPT.read_text()).group(1)
    assert line["metric"] == metric and line["unit"] == "evals/s" and line["device"] == "cpu"
    assert line["value"] > 0 and line["vs_baseline"] == line["value"] / 8040.0
    # the kernel's numbers are the card's: none on the CPU, where the op ran its plain version
    assert all(line[k] is None for k in ("build_seconds", "kernel_ms", "team", "bound_ms", "latency_floor_ms"))
    assert out["launches"] == 0
    numbers = [k for k in bench.KEYS if isinstance(line[k], (int, float)) and not isinstance(line[k], bool)]
    assert len(numbers) >= 20 and all(math.isfinite(line[k]) for k in numbers)
    assert line["gate_f32_f64_max_abs_err"] <= 1.0 and line["gate_kernel_plain_max_abs_err"] <= 0.5
    assert (line["bootstrap_chunk_sims"], line["bootstrap_walkers"], line["bootstrap_steps"]) == (4, 4, 10)
    assert line["bootstrap_early_stop"] == [0.01, 50] and line["bootstrap_scaled_from_chunk"] is True
    assert 1 <= line["bootstrap_steps_run_null"] <= 10 and 1 <= line["bootstrap_steps_run_alt"] <= 10
    total = line["bootstrap_chunk_seconds_null"] + line["bootstrap_chunk_seconds_alt"]
    assert line["bootstrap_10k_seconds"] == pytest.approx(total * 10_000 / 4, rel=1e-12)
    for lls in out["bootstrap_best_loglikes"].values():
        assert lls.shape == (4,) and bool(torch.isfinite(lls).all())
    assert out["e13_rates"].shape == (4, 500) and bool((out["e13_rates"] > 0).all())
    assert (line["derive_posteriors_steps"], line["derive_posteriors_walkers"]) == (30, 8)
    assert 1.0 / 9 <= line["lrt_512_p_value"] <= 1.0


def test_import_starts_nothing():
    code = ("import threading, torch\nimport mind_the_gaps_tpu_torch.bench\n"
            "print(threading.active_count(), torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "False"]
