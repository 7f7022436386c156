"""The benchmark's files: found by name, held to the contract's shape,
and free of JAX and of the JAX package."""

import ast
import json
import re

import pytest

import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry, cfg, traffic = harness.cell_files(cell, BENCH)
    assert entry["chips"] == 1
    assert traffic["limits"], "a cell compares at least one number"
    driver = harness.load_module("drivers", cfg["driver"])
    assert callable(driver.run)
    conf = {c["name"]: c for c in BENCH["configs"]}[entry["config"]]
    assert harness.load_json(harness.ROOT / conf["file"]) == cfg
    assert set(conf["reduced"]) == set(cfg["reduced"])


@pytest.mark.parametrize("metric", METRICS)
def test_metric_readers_found_by_name(metric):
    reader = harness.load_module("metrics", metric)
    assert reader.read(None, {}, {}) is None, "nothing to read: no value"


def test_names_units_and_entries():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = harness.metrics_of(BENCH, cell, trace=False)
    per_layer = harness.metrics_of(BENCH, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per_layer


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(harness.BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_and_no_jax_package(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), (path, tops)


@pytest.mark.parametrize("path", sorted(
    (harness.BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert tops <= {"math", "typing", "torch", "__future__", "numpy"}, tops


def test_forbidden_modules_compares_top_level_names_whole():
    import sys
    sys.modules["repro_torch_lookalike"] = sys
    try:
        found = harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_lookalike"]
    assert all(m.split(".", 1)[0] in harness.FORBIDDEN for m in found)
