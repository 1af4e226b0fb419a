"""``BENCHMARK.json`` against the benchmark's contract, as committed and
with the parked cells (``parked/``) put back, and the harness's isolation
from JAX and from the JAX package."""
import json
import os
import re
import subprocess
import sys

import pytest

from gpbench_tiny import ROOT, parked_root, with_parked

COMMITTED = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(params=["committed", "with parked cells"])
def bench(request):
    return COMMITTED if request.param == "committed" else with_parked(COMMITTED)


def test_the_parked_cells_are_out_of_the_committed_file():
    parked = {w["name"] for w in with_parked(COMMITTED)["workloads"]} - {w["name"] for w in COMMITTED["workloads"]}
    assert parked == {"gauss4.bootstrap"}


def test_the_file_has_exactly_the_contract_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "-m"] and len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p for p in bench["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_lines_use_only_the_allowed_characters(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [x["name"] for x in bench["configs"] + bench["workloads"] + metrics]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    lines = [x["why"] for x in bench["configs"] + bench["workloads"]] + [c["source"] for c in bench["configs"]]
    lines += [m["layer"] for m in bench["per_layer"]] + bench["command"]
    assert all(LINE.match(x) for x in lines)
    for group in (bench["configs"], bench["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_moves_names_an_end_to_end_metric_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in [c for c in cells if _reports(m, c)]:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        assert _reports(e2e["setup_s"], cell)
        assert sum(_reports(m, cell) for m in bench["end_to_end"]) >= 2
        assert any(_reports(m, cell) for m in bench["per_layer"])


def test_every_name_has_its_files(bench):
    metrics = bench["end_to_end"] + bench["per_layer"]
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("gpbench/") and set(c["reduced"]) <= set(data)
        assert {"precision", "reduced", "assumed", "deployment"} <= set(data)
    for w in bench["workloads"]:
        assert w["config"] in configs
        assert (ROOT / "gpbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "gpbench" / "limits" / f"{w['name']}.json").is_file()
        # a four-card cell runs one process a card (ranks.py); a one-card cell runs one process
        ranks = json.loads((ROOT / configs[w["config"]]["file"]).read_text()).get("ranks")
        assert ranks == 4 if w["chips"] == 4 else ranks is None, (w["name"], ranks)
    for m in metrics:
        assert (ROOT / "gpbench" / "metrics" / f"{m['name']}.py").is_file()
    assert _four_card_cells_allowed(bench["workloads"])


def _four_card_cells_allowed(workloads) -> bool:
    """At most a quarter of the cells, rounded down, ask for four cards, and
    one always may."""
    return sum(w["chips"] == 4 for w in workloads) <= max(1, len(workloads) // 4)


@pytest.mark.parametrize("chips, allowed", [((1, 1, 1, 4), True), ((1, 4), True), ((1, 1, 1, 4, 4), False),
                                            ((1, 1, 1, 1, 1, 1, 1, 4, 4), True), ((4, 4), False)])
def test_the_quarter_rule_for_four_card_cells(chips, allowed):
    assert _four_card_cells_allowed([{"chips": c} for c in chips]) is allowed


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'gpbench/tests')\n"
        "torch.set_num_threads(2)\n"
        "from gpbench_tiny import run_tiny\n"
        "import gpbench.readings, gpbench.reference, gpbench.trace, gpbench.roofline\n"
        "for cell in ('gauss.bootstrap', 'gauss.observed'):\n"
        "    run_tiny(cell, trace=True)\n"
        "from gpbench.run import forbidden_modules\n"
        "print('FOUND', forbidden_modules(), 'mind_the_gaps_tpu_torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert "FOUND [] True" in out.stdout, out.stderr[-2000:]


def test_the_reference_imports_nothing_of_either_package():
    code = "import sys, gpbench.reference; print(sorted(m for m in sys.modules if m.startswith('mind_the_gaps')))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_the_command_refuses_to_run_without_a_card(card_absent):
    out = subprocess.run([sys.executable, "-m", "gpbench", "--workload", "gauss.bootstrap", "--seed", "3000000001",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_four_card_cell_refuses_to_run_without_four_cards():
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("four cards are here: the refusal is for a machine with fewer")
    out = subprocess.run([sys.executable, "-m", "gpbench", "--workload", "gauss4.bootstrap", "--seed", "3000000001",
                          "--seconds", "1", "--trace", "0"], cwd=parked_root(), capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 3 and out.stdout.strip() == ""
    assert "needs 4 CUDA card(s)" in out.stderr


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for a machine without one")
