"""The span reductions (``gpbench/spans.py``) and the readers of the port's
spans and counters, on canned spans, a canned trace and canned records."""
import sys
from types import SimpleNamespace

import pytest

from gpbench import spans as sp
from gpbench.run import PACKAGE_DIR, load_cell, load_module
from gpbench.trace import Trace, busy_seconds
from gpbench_tiny import ROOT

K = "void celerite::loglike_kernel<float, 1, 1, false, 8>(float const*, float const*, int)"
# the card busy 0-0.1, 0.3-0.4, 0.6-1.0 and 1.5-1.6 of a 2 s turn: idle 1.3 s
TRACE = Trace([(K, 0.0, 0.1), (K, 0.3, 0.4), (K, 0.6, 1.0), (K, 1.5, 1.6)],
              [("cudaLaunchKernel", 0.0, 0.01), ("cudaStreamSynchronize", 1.95, 2.0)], 2.0)
BOOTSTRAP = [
    ("lrt.protassov_lrt", 0.0, 2.0, 1, None),
    ("lrt.chunk", 0.05, 1.9, 2, 1),
    ("lrt.generation", 0.05, 0.2, 3, 2),
    ("lrt.refits", 0.2, 1.2, 4, 2),
    ("refits.run", 0.2, 1.2, 5, 4),
    ("refits.step", 0.2, 0.7, 6, 5),
    ("refits.early_stop", 0.5, 0.7, 7, 6),
    ("refits.step", 0.7, 1.2, 8, 5),
    ("refits.early_stop", 1.0, 1.1, 9, 8),
    ("lrt.refine", 1.2, 1.9, 10, 2),
]
OBSERVED = [
    ("gp.derive_posteriors", 0.0, 2.0, 1, None),
    ("gp.map_fit", 0.0, 0.25, 2, 1),
    ("gp.sampling", 0.25, 2.0, 3, 1),
    ("sampler.segment", 0.25, 1.3, 4, 3),
    ("sampler.autocorr", 1.3, 1.4, 5, 3),
    ("sampler.segment", 1.4, 1.95, 6, 3),
    ("sampler.autocorr", 1.95, 2.0, 7, 3),
]


def _ctx(cell, records, traced_records, device="cuda"):
    import torch

    c = load_cell(cell, ROOT, [PACKAGE_DIR])
    traced = SimpleNamespace(records=traced_records, trace=TRACE, busy_s=busy_seconds(TRACE.device),
                             window_s=TRACE.window_s)
    return SimpleNamespace(cell=c, config=c.config, traffic=c.traffic, records=records, traced=traced,
                           device=torch.device(device), dirs=[PACKAGE_DIR])


def _read(name, ctx):
    return load_module(ctx.dirs, "metrics", name).read(ctx)


def test_the_span_reductions():
    assert sp.idle_intervals([(0.0, 0.1), (0.3, 0.4)], 0.05, 0.5) == [(0.1, 0.3), (0.4, 0.5)]
    assert sp.idle_inside(BOOTSTRAP, TRACE, {"lrt.refits"}) == pytest.approx(0.1 + 0.2 + 0.2)
    assert sp.idle_inside(BOOTSTRAP, TRACE, {"sim.e13_pass"}) is None
    assert sp.host_seconds(BOOTSTRAP, {"refits.early_stop"}) == pytest.approx(0.3)
    assert sp.host_seconds(BOOTSTRAP, {"sampler.segment"}) is None
    pieces = sp.innermost(BOOTSTRAP)
    assert [p[:2] for p in pieces] == sorted(p[:2] for p in pieces)  # in time order, disjoint
    assert sum(e - s for s, e, *_ in pieces) == pytest.approx(2.0)
    by_name, at_root, outside = sp.idle_by_span(BOOTSTRAP, TRACE)
    assert by_name == pytest.approx({"lrt.generation": 0.1, "refits.step": 0.3, "refits.early_stop": 0.2,
                                     "lrt.refine": 0.6})
    assert at_root == pytest.approx(0.1) and outside == pytest.approx(0.0)
    # a gap between two roots lies outside every span
    later = [("lrt.protassov_lrt", 0.0, 1.2, 1, None), ("lrt.protassov_lrt", 1.4, 2.0, 2, None)]
    by_name, at_root, outside = sp.idle_by_span(later, TRACE)
    assert by_name == {} and outside == pytest.approx(0.2) and at_root == pytest.approx(1.1)
    assert sp.within(BOOTSTRAP + [("gp.map_fit", 2.5, 3.0, 11, None)], TRACE) == BOOTSTRAP


def test_the_port_s_spans_are_read_in_seconds(monkeypatch):
    torch = pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile

    from mind_the_gaps_tpu_torch import tracing

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("test.outer", rows=3):
            with tracing.span("test.inner"):
                torch.ones(4).sum()
    (inner, s0, e0, i0, p0), (outer, s1, e1, i1, p1) = sp.program_spans()
    assert (inner, outer, p0, p1) == ("test.inner", "test.outer", i1, None)
    assert s1 <= s0 <= e0 <= e1 and 1e9 < s1  # Unix-epoch seconds
    import mind_the_gaps_tpu_torch

    monkeypatch.delattr(mind_the_gaps_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "mind_the_gaps_tpu_torch.tracing", None)  # a port without spans
    assert sp.program_spans() is None


def test_the_span_readers(monkeypatch):
    monkeypatch.setattr(sp, "program_spans", lambda: list(BOOTSTRAP))
    ctx = _ctx("gauss.bootstrap", [], [{"sims": 100}])
    assert _read("refit_idle_ms_per_sim", ctx) == pytest.approx(1e3 * 0.5 / 100)
    assert _read("refit_sync_ms_per_sim", ctx) == pytest.approx(1e3 * 0.3 / 100)
    monkeypatch.setattr(sp, "program_spans", lambda: list(OBSERVED))
    ctx = _ctx("gauss.observed", [], [{"steps": 600}, {"steps": 400}])
    # the segments and checks cover 0.25-2.0 s, idle in 0.25-0.3, 0.4-0.6, 1.0-1.5 and 1.6-2.0
    assert _read("sampler_idle_ms_per_step", ctx) == pytest.approx(1e3 * 1.15 / 1000)
    assert _read("refit_idle_ms_per_sim", _ctx("gauss.bootstrap", [], [{"sims": 100}])) is None


def test_the_counter_readers():
    records = [{"sims": 1023, "timings": {"refit_steps": 1200, "e13_passes": 30}}] * 2
    ctx = _ctx("lognormal.bootstrap", records, [])
    # 1023 simulations and the observed row at chunk 512: two chunks of two refit runs, both with simulations
    assert _read("refit_steps_per_refit", ctx) == pytest.approx(2 * 1200 / 8)
    assert _read("e13_passes_per_chunk", ctx) == pytest.approx(2 * 30 / 4)


@pytest.mark.parametrize("name", ["refit_idle_ms_per_sim", "refit_sync_ms_per_sim", "sampler_idle_ms_per_step",
                                  "refit_steps_per_refit", "e13_passes_per_chunk"])
def test_a_reader_with_nothing_to_read_returns_nothing(monkeypatch, name):
    monkeypatch.setattr(sp, "program_spans", lambda: None)  # a port that records no spans
    without = [{"sims": 1023, "steps": 2000, "timings": {"generation_s": 0.1}}]
    gaussian = [{"sims": 1023, "steps": 2000, "timings": {"refit_steps": 1200, "e13_passes": 0}}]
    for ctx in (_ctx("lognormal.bootstrap", without, without),
                _ctx("lognormal.bootstrap", gaussian, gaussian, device="cpu")):
        assert _read(name, ctx) is None
    ctx = _ctx("gauss.bootstrap", gaussian, gaussian)
    ctx.traced = None
    if name != "refit_steps_per_refit":
        assert _read(name, ctx) is None
