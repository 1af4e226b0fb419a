"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
isolation from JAX and from the JAX package."""
import json
import re
import subprocess
import sys

import pytest

from gpbench_tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_the_file_has_exactly_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "-m"] and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p for p in BENCH["paths"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_lines_use_only_the_allowed_characters():
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    lines = [x["why"] for x in BENCH["configs"] + BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
    lines += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    assert all(LINE.match(x) for x in lines)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_moves_names_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in [c for c in cells if _reports(m, c)]:
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        assert _reports(e2e["setup_s"], cell)
        assert sum(_reports(m, cell) for m in BENCH["end_to_end"]) >= 2
        assert any(_reports(m, cell) for m in BENCH["per_layer"])


def test_every_name_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("gpbench/") and set(c["reduced"]) <= set(data)
        assert {"precision", "reduced", "assumed", "deployment"} <= set(data)
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        assert (ROOT / "gpbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "gpbench" / "limits" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1  # the harness runs one-card cells
    for m in METRICS:
        assert (ROOT / "gpbench" / "metrics" / f"{m['name']}.py").is_file()
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


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


@pytest.fixture
def card_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for a machine without one")
