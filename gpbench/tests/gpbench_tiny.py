"""Small sizes at which the tests drive the cells on the host, and limits
set for them (the chip's limits are in ``limits/``)."""
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

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

