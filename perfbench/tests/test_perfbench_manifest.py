"""The manifest keeps to the benchmark's contract, every file is found by
its name, and a cell, a configuration and a metric added as new files are
found with no edit; nothing the benchmark imports is JAX or the JAX
package, and the reference imports nothing of the program."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_keys_names_and_units(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["perfbench"]
    assert man["command"][1] == "perfbench/run.py"
    assert 1 <= man["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in man["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in man["workloads"]:
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_every_cell_reports_setup_another_metric_and_a_layer(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for w in man["workloads"]:
        mine = {m["name"] for m in
                harness.cell_metrics(man, w["name"], "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        layers = harness.cell_metrics(man, w["name"], "per_layer")
        assert layers, w["name"]
        for m in layers:
            assert m["moves"] in mine, (w["name"], m["name"])


def test_moves_and_cells_are_consistent(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", cells)) <= cells
        assert m["layer"] and "\n" not in m["layer"]
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}


def test_every_file_is_found_by_name(man):
    for w in man["workloads"]:
        found = harness.find_cell(w["name"], man)
        assert harness.entry_class(found["work"]["entry"])
        assert set(found["work"]["limits"])
    for m in man["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for c in man["configs"]:
        cfg = harness.load_json(ROOT / c["file"])
        assert c["file"].startswith("perfbench/configs/")
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        harness.program_config(cfg)         # the program's config is the file's


def test_new_files_are_found_with_no_edit(tmp_path, man):
    bench = tmp_path / "perfbench"
    shutil.copytree(harness.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((bench / "configs/mpii_r18_384.json").read_text())
    cfg["name"] = "mpii_r18_384_b"
    (bench / "configs/mpii_r18_384_b.json").write_text(json.dumps(cfg))
    (bench / "traffic/closed-b64.json").write_text(json.dumps(
        {"kind": "closed_batch", "batch": 64, "distinct": 32,
         "warmup_calls": 3}))
    work = json.loads((bench / "workloads/r18-infer-b128.json").read_text())
    (bench / "workloads/new-cell.json").write_text(json.dumps(work))
    (bench / "metrics/calls_per_s.py").write_text(
        "def read(obs):\n    return obs['calls'] / obs['window_s']\n")
    new = json.loads(json.dumps(man))
    new["configs"].append({"name": "mpii_r18_384_b", "source": "x",
                           "file": "perfbench/configs/mpii_r18_384_b.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "new-cell", "config": "mpii_r18_384_b",
                             "traffic": "closed-b64", "chips": 1, "why": "x"})
    new["end_to_end"][0]["workloads"].append("new-cell")
    new["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "inference entry",
                             "moves": "infer_img_per_s",
                             "workloads": ["new-cell"]})
    found = harness.find_cell("new-cell", new, bench)
    assert found["traffic"]["batch"] == 64
    assert found["cfg"]["name"] == "mpii_r18_384_b"
    got = harness.read_per_layer(new, "new-cell",
                                 {"calls": 10, "window_s": 2.0}, bench)
    assert got["calls_per_s"] == {"value": 5.0, "unit": "1/s"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_and_a_reference_apart_from_the_program():
    files = sorted(harness.BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & set(harness.FORBIDDEN), (f, tops)
        if "reference" in f.parts:
            assert "ppn_tpu_torch" not in tops, f


def test_top_level_names_are_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    assert "jaxtyping_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ppn_tpu.ops", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["ppn_tpu"]
