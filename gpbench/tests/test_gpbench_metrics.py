"""Each metric's reader on canned records and a canned profiler trace."""
from types import SimpleNamespace

import pytest

from gpbench.roofline import launch_bound_s, step_flops
from gpbench.run import PACKAGE_DIR, load_cell, load_module
from gpbench.trace import Trace, busy_intervals, busy_seconds, celerite_launches, device_ops, idle_gaps
from gpbench_tiny import ROOT, parked_root
from mind_the_gaps_tpu_torch.parallel import Mesh

K32 = "void celerite::loglike_kernel<float, 1, 1, false, 8>(float const*, float const*, int)"
K64 = "void celerite::loglike_kernel<double, 1, 0, false, 32>(double const*, double const*, int)"
LANE = "void celerite::lane_kernel<double, 1, 1>(double const*, int)"
GRAD = "grad_kernel(int, int, double const*)"


def _trace():
    device = [(GRAD, 0.0, 0.1), (K32, 0.2, 0.3), ("Memcpy DtoH (Device -> Pinned)", 0.3, 0.35),
              (K64, 0.5, 0.6), (K32, 0.55, 0.7), (LANE, 0.9, 1.0)]
    host = [("cudaLaunchKernel", 0.1, 0.16), ("cudaStreamSynchronize", 0.36, 0.5), ("cudaLaunchKernel", 0.75, 0.81)]
    return Trace(device, host, 1.25)


def _ctx(cell, records, traced_records=None, root=ROOT):
    c = load_cell(cell, root, [PACKAGE_DIR])
    trace = _trace()
    traced = SimpleNamespace(records=traced_records, trace=trace, busy_s=busy_seconds(trace.device),
                             window_s=trace.window_s)
    return SimpleNamespace(cell=c, config=c.config, traffic=c.traffic, records=records, traced=traced,
                           setup_s=12.5, window_s=10.0, dirs=[PACKAGE_DIR], mesh=None)


def _read(name, ctx):
    return load_module(ctx.dirs, "metrics", name).read(ctx)


def test_the_trace_reductions():
    t = _trace()
    assert busy_intervals(t.device) == [(0.0, 0.1), (0.2, 0.35), (0.5, 0.7), (0.9, 1.0)]
    assert busy_seconds(t.device) == pytest.approx(0.55)
    assert busy_seconds(t.device, since=0.1) == pytest.approx(0.45)
    assert device_ops(t.device, top=2) == [[K32[:160], pytest.approx(0.25)], [GRAD, pytest.approx(0.1)]]
    gaps = dict(idle_gaps(t))
    assert gaps == {"cudaLaunchKernel": pytest.approx(0.1 + 0.2), "cudaStreamSynchronize": pytest.approx(0.15)}
    assert [(d, jr, jc) for d, jr, jc, _ in celerite_launches(t.device)] == [
        ("float32", 1, 1), ("float64", 1, 0), ("float32", 1, 1), ("float64", 1, 1)]


def test_the_bootstrap_readers():
    timings = {"generation_s": 0.5, "refits_s": 4.0}
    records = [{"sims": 1000, "timings": timings, "refit_launches": 2600}] * 2
    ctx = _ctx("gauss.bootstrap", records)
    assert _read("sims_per_s", ctx) == pytest.approx(200.0)
    assert _read("setup_s", ctx) == 12.5
    assert _read("generation_ms_per_sim", ctx) == pytest.approx(0.5)
    assert _read("refits_ms_per_sim", ctx) == pytest.approx(4.0)
    assert _read("refit_launches_per_sim", ctx) == pytest.approx(2.6)
    assert _read("device_idle_pct.bootstrap", ctx) == pytest.approx(100 * (1 - 0.55 / 1.25))
    cfg = ctx.config
    rows = cfg["chunk"]
    refit = [launch_bound_s(rows * 6, cfg["n_points"], 1, 1, rows, "float32")[0]] * 2
    refine = [launch_bound_s(rows, cfg["n_points"], jr, jc, rows, "float64")[0] for jr, jc in ((1, 0), (1, 1))]
    expect = 100 * (sum(refit) + sum(refine)) / (0.1 + 0.15 + 0.1 + 0.1)
    assert _read("celerite_roofline_pct.bootstrap", ctx) == pytest.approx(expect)


def test_the_refits_count_a_chunk_s_rows():
    c = load_cell("gauss.bootstrap", ROOT, [PACKAGE_DIR])
    ctx = SimpleNamespace(config=c.config, dirs=[PACKAGE_DIR], mesh=None)
    driver = load_module(ctx.dirs, "drivers", "bootstrap")
    assert driver.launch_shape(ctx, "float32", 1, 1) == (512 * 6, 512)
    assert driver.launch_shape(ctx, "float64", 1, 1) == (512, 512)
    # a rank refits its block of the chunk's rows; every rank refines the whole chunk
    c4 = load_cell("gauss4.bootstrap", parked_root(), [PACKAGE_DIR])
    for rank in range(4):
        ctx = SimpleNamespace(config=c4.config, dirs=[PACKAGE_DIR], mesh=Mesh(("cpu",), process_index=rank,
                                                                              process_count=4))
        assert driver.launch_shape(ctx, "float32", 1, 1) == (512 * 6, 512)
        assert driver.launch_shape(ctx, "float64", 1, 1) == (2048, 2048)


def test_the_mesh_wait_reader():
    records = [{"sims": 63, "timings": {"refit_steps": 200}}, {"sims": 63, "timings": {"refit_steps": 300}}]
    ctx = _ctx("gauss4.bootstrap", records, traced_records=records, root=parked_root())
    assert _read("mesh_wait_ms_per_step", ctx) is None  # a run of one process has no vote
    ctx.traced.process_any_s = [0.001] * 400 + [0.0005] * 100
    assert _read("mesh_wait_ms_per_step", ctx) == pytest.approx(1e3 * 0.45 / 500)


def test_the_readers_reduce_over_ranks_as_their_docstrings_say():
    from gpbench.ranks import over_ranks, reduction

    cell = load_cell("gauss4.bootstrap", parked_root(), [PACKAGE_DIR])
    expect = {"sum": 10.0, "mean": 2.5, "rank0": 1.0}
    said = {"sum": "Over ranks: the sum", "mean": "Over ranks: the mean", "rank0": "Over ranks: rank 0's"}
    for m in cell.end_to_end + cell.per_layer:
        module = load_module([PACKAGE_DIR], "metrics", m["name"])
        how = reduction(module)
        assert said[how] in " ".join(module.__doc__.split()), m["name"]
        assert over_ranks(how, [1.0, 2.0, 3.0, 4.0]) == expect[how]
        assert over_ranks(how, [1.0, None, 3.0, 4.0]) is None  # a rank that read nothing: nothing
    hows = {m["name"]: reduction(load_module([PACKAGE_DIR], "metrics", m["name"]))
            for m in cell.per_layer}
    assert hows["refit_launches_per_sim"] == "sum" and hows["refit_steps_per_refit"] == "rank0"


def test_the_observed_readers():
    records = [{"steps": 2000, "map_fit_s": 0.2, "sampling_s": 5.0, "sampling_launches": 4008}] * 2
    traced = [{"steps": 600, "sampling_s": 1.7}, {"steps": 400, "sampling_s": 1.2}]
    ctx = _ctx("gauss.observed", records, traced)
    assert _read("observed_steps_per_s", ctx) == pytest.approx(400.0)
    assert _read("map_fit_ms_per_fit", ctx) == pytest.approx(200.0)
    assert _read("sampler_launches_per_step", ctx) == pytest.approx(2.004)
    # the window's sampling 10 s over 4000 steps; traced busy 0.55 s, 0.1 of it the gradient kernel's
    assert _read("sampler_glue_ms_per_step", ctx) == pytest.approx(1e3 * (10.0 / 4000 - 0.45 / 1000))
    bound = sum(launch_bound_s(16, 5000, jr, jc, 1, d)[0]
                for d, jr, jc in (("float32", 1, 1), ("float64", 1, 0), ("float32", 1, 1), ("float64", 1, 1)))
    assert _read("celerite_roofline_pct.observed", ctx) == pytest.approx(100 * bound / 0.45)


def test_a_reader_with_nothing_to_read_returns_nothing():
    ctx = _ctx("gauss.observed", [{"steps": 10, "map_fit_s": 0.1, "sampling_s": 1.0, "sampling_launches": 0}])
    ctx.traced = None
    for name in ("sampler_launches_per_step", "sampler_glue_ms_per_step", "celerite_roofline_pct.observed",
                 "device_idle_pct.observed"):
        assert _read(name, ctx) is None


def test_the_operation_count_follows_one_convention():
    # R = 1: c h, exp; D w; one multiply-add; P M; P^T; S u; D; 1/D, w; f; z; the sums
    assert step_flops(1, 0) == 2 + 1 + 2 + 1 + 1 + 1 + 2 + 3 + 2 + 1 + 2 + 5
    # the alternative's step at R = 3, the roofline of the bench's launch
    assert step_flops(1, 1) == 113
    t, what = launch_bound_s(65_536, 5000, 1, 1, 1, "float32")
    assert what == "operations" and t == pytest.approx(65_536 * 4999 * 113 / 67e12)
