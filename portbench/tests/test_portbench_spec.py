"""Configurations, mixes and metrics are found by file name, and
BENCHMARK.json keeps the contract's shape."""
from __future__ import annotations

import json
import re
import shutil

from conftest import PB, ROOT
from portbench.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_real_benchmark_resolves():
    spec = Spec()
    bench = spec.bench
    assert set(spec.configs()) >= {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer and set(cell.readers) == \
            {m["name"] for m in cell.per_layer}


def test_contract_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert len(json.dumps(b)) < 64 * 1024
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e
        assert (PB / "metrics" / f"{m['name']}.py").exists()


def test_found_by_name_without_an_edit(tiny_spec, tmp_path):
    """A configuration, a mix and a metric added as files in a folder
    are listed, and a cell that names them resolves."""
    root = tmp_path / "bench"
    shutil.copytree(tiny_spec.root, root)
    cfg = json.loads((root / "configs" / "tiny-lr.json").read_text())
    cfg["name"] = "tiny-lr2"
    (root / "configs" / "tiny-lr2.json").write_text(json.dumps(cfg))
    shutil.copy(root / "traffic" / "short.json", root / "traffic" / "s2.json")
    (root / "metrics" / "loop.files.py").write_text(
        "def read(ctx):\n    return ctx['reads']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "t.new", "config": "tiny-lr2",
                               "traffic": "s2", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "loop.files", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "file loop",
                               "moves": "query_bp_per_s",
                               "workloads": ["t.new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root, root / "BENCHMARK.json")
    assert "tiny-lr2" in spec.configs() and "s2" in spec.traffics()
    assert "loop.files" in spec.metrics()
    cell = spec.cell("t.new")
    assert cell.config["name"] == "tiny-lr2"
    assert cell.readers["loop.files"]({"reads": 7}) == 7
    assert "loop.files" not in spec.cell("t.lr").readers


def test_readers_return_nothing_without_data():
    spec = Spec()
    empty = {"stats_before": {}, "stats_after": {}, "bp": 0, "reads": 0,
             "window_s": 1.0, "setup": {}, "trace": None}
    for name in spec.metrics():
        r = spec.cell(spec.bench["workloads"][0]["name"]).readers.get(name)
        if r is not None:
            assert r(empty) is None
