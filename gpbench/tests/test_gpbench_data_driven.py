"""A later cell needs only files of its own: a configuration, a traffic
mix, its limits and a metric's reader, added in a directory of their own
and named in a ``BENCHMARK.json``, run with no file of the harness edited."""
import json

from gpbench_tiny import ROOT, TINY, TINY_LIMITS


def test_a_new_cell_config_traffic_and_metric_run_from_their_own_files(tmp_path):
    from gpbench.run import run_cell

    extra = tmp_path / "more"
    for d in ("configs", "traffic", "limits", "metrics"):
        (extra / d).mkdir(parents=True)
    config = json.loads((ROOT / "gpbench/configs/lrt_gauss_n5000.json").read_text())
    config.update(TINY["config"], name="lrt_gauss_small", nsims=7)
    (extra / "configs" / "lrt_gauss_small.json").write_text(json.dumps(config))
    (extra / "traffic" / "short_fits.json").write_text(json.dumps(
        {"driver": "observed", "walkers": 8, "max_steps": 40, "warmup_steps": 10}))
    (extra / "limits" / "small.short_fits.json").write_text(json.dumps(TINY_LIMITS["gauss.observed"]))
    (extra / "metrics" / "walker_steps_per_s.py").write_text(
        "def read(ctx):\n    return 8 * sum(r['steps'] for r in ctx.records) / ctx.window_s\n")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "lrt_gauss_small", "source": "test", "file": str(extra / "configs" /
                             "lrt_gauss_small.json"), "reduced": [], "why": "test"})
    bench["workloads"] = [{"name": "small.short_fits", "config": "lrt_gauss_small", "traffic": "short_fits",
                           "chips": 1, "why": "test"}]
    bench["end_to_end"] = [{"name": "walker_steps_per_s", "unit": "steps/s", "better": "higher", "bound": 0.05,
                            "source": "host_clock"},
                           {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25, "source": "host_clock"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "gpbench").rglob("*") if p.is_file() and "__pycache__" not in str(p)}
    res = run_cell("small.short_fits", 5, 0.5, False, root=tmp_path, device="cpu", dirs=[extra])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"walker_steps_per_s", "setup_s"}
    after = {p: p.read_bytes() for p in (ROOT / "gpbench").rglob("*") if p.is_file() and "__pycache__" not in str(p)}
    assert after == before
