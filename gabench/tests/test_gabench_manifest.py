"""`BENCHMARK.json` and the files it names hold together, and nothing the
benchmark runs reaches the JAX package or `benchmarks/`."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gabench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _sources(under: Path):
    return sorted(under.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_sources_found():
    names = {p.relative_to(BENCH).as_posix() for p in _sources(BENCH)}
    assert {"run.py", "harness.py", "reference/plain.py", "work.py",
            "check.py", "trace.py"} <= names


@pytest.mark.parametrize("path", _sources(BENCH),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_or_jax_package(path):
    roots = {m.split(".")[0] for m in _imports(path)}
    assert not roots & FORBIDDEN, (path, roots & FORBIDDEN)


@pytest.mark.parametrize("path", _sources(BENCH / "reference"),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    roots = {m.split(".")[0] for m in _imports(path)}
    assert roots <= {"__future__", "dataclasses", "math", "typing",
                     "numpy", "torch"}, roots


def test_nothing_reads_the_jax_benchmarks():
    for path in _sources(BENCH):
        if path.parent == BENCH / "tests":
            continue
        roots = {m.split(".")[0] for m in _imports(path)}
        assert "benchmarks" not in roots, path
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                assert "benchmarks/" not in node.value, path


def test_manifest_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["gabench"]
    assert MANIFEST["command"][1] == "gabench/run.py"
    assert 10 <= MANIFEST["run_seconds"] <= 51
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MANIFEST[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in e and group != "end_to_end":
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in MANIFEST[group]}) == len(
            MANIFEST[group])
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_every_name_resolves():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    for w in MANIFEST["workloads"]:
        conf = configs[w["config"]]
        used.add(w["config"])
        path = ROOT / conf["file"]
        assert path.is_file() and path.is_relative_to(BENCH)
        data = json.loads(path.read_text())
        assert data["reduced"] == conf["reduced"]
        for key in data["reduced"]:
            assert key in data or key in data["spec"], (path, key)
        assert data["source"] == conf["source"]
        for key, default in (("reference", "reference/plain.py"),
                             ("work", "work.py")):
            module = ROOT / data.get(key, f"gabench/{default}")
            assert module.is_file() and module.is_relative_to(BENCH), module
        traffic = BENCH / "traffic" / f"{w['traffic']}.json"
        assert json.loads(traffic.read_text())["kind"] in ("jobs", "stream")
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert used == set(configs)
    for m in MANIFEST["per_layer"]:
        reader = BENCH / "metrics" / f"{m['name']}.py"
        tree = ast.parse(reader.read_text())
        assert "read" in {n.name for n in tree.body
                          if isinstance(n, ast.FunctionDef)}, reader


def _reports(cell: str):
    e2e = {m["name"] for m in MANIFEST["end_to_end"]
           if cell in m.get("workloads", [cell])}
    layer = [m for m in MANIFEST["per_layer"]
             if cell in m.get("workloads", [cell])]
    return e2e, layer


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cells_report_what_their_metrics_move(cell):
    e2e, layer = _reports(cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])
    layers = {}
    for m in MANIFEST["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert all(layers.values())


def test_forbidden_modules_compare_top_level_names_whole():
    sys.path.insert(0, str(ROOT))
    from gabench.harness import forbidden_loaded
    assert forbidden_loaded(["jax.numpy", "repro_torch.ga", "reprox",
                             "repro.ga", "flax", "numpy"]) == [
        "flax", "jax", "repro"]
    assert forbidden_loaded(["repro_torch", "repro_torch.kernels"]) == []


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")


def test_run_refuses_a_host_without_a_card(no_card, tmp_path):
    cell = MANIFEST["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
