"""The chromosome-scale configuration (lr-chr1) and the amplicon mix,
found by name; the readers of the collect's counters
(front.collect_hbm_pct) and of the cuckoo walk's span (setup.cuckoo_s)
on contexts written by hand and without data; a tiny CPU run of
lr-chr1 cut to a 400 kb graph."""
from __future__ import annotations

import json
import shutil

import pytest

from conftest import CPU_FRONT, PB, ROOT
from portbench.harness import run_cell
from portbench.spec import Spec, load_reader

NEW_METRICS = ("front.collect_hbm_pct", "setup.cuckoo_s")


def reader(name):
    return load_reader(PB / "metrics" / f"{name}.py")


def test_new_cells_resolve_by_name():
    spec = Spec()
    chr1 = spec.cell("lr-chr1.pb15k")
    assert chr1.config["name"] == "lr-chr1" and chr1.traffic_name == "pb15k"
    assert chr1.config["preset"] == "lr"
    assert chr1.config["graph_bp"] == 248_956_422
    base = json.loads((PB / "configs" / "lr-bubble20m.json").read_text())
    assert chr1.config["graph"] == base["graph"]
    assert chr1.config["graph_seed"] != base["graph_seed"]
    amp = spec.cell("lr.amplicon")
    assert amp.config_name == "lr-bubble20m"
    assert amp.traffic_name == "amplicon"
    ln = amp.traffic["length"]
    assert 800 <= ln["min"] and ln["max"] <= 2048
    for cell in (chr1, amp, spec.cell("lr.pb15k"),
                 spec.cell("asm.hap-contigs")):
        assert set(NEW_METRICS) <= set(cell.readers)


def ctx(before, after):
    return {"stats_before": before, "stats_after": after, "bp": 1000,
            "reads": 10, "window_s": 1.0, "setup": {}, "trace": None}


def test_collect_hbm_pct_value():
    before = {"collect_probed": 1000, "collect_anchor_slots": 500,
              "table_slot_words": 2,
              "stage_ms": {"collect": 2.0, "sketch": 1.0}}
    after = {"collect_probed": 1000 + 256 * 384,
             "collect_anchor_slots": 500 + 256 * 512,
             "table_slot_words": 2,
             "stage_ms": {"collect": 3.0, "sketch": 9.0}}
    # 8 bytes x (98304 x 2 x 2 + 131072 x 6) words in 1 ms
    want = 100.0 * 8 * (98304 * 4 + 131072 * 6) / 1e-3 / 3.35e12
    assert reader("front.collect_hbm_pct")(ctx(before, after)) == \
        pytest.approx(want)


def test_cuckoo_s_value():
    before = {"span_ms": {"setup.front.cuckoo": 812.5,
                          "setup.front.tables": 1500.0}}
    assert reader("setup.cuckoo_s")(ctx(before, before)) == \
        pytest.approx(0.8125)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_none_without_data(name):
    """An empty context, and a program without the counters and span
    (the parent's stats)."""
    assert reader(name)(ctx({}, {})) is None
    plain = {"n_share_dev": 1000, "tail_ms": 10.0,
             "stage_ms": {"collect": 5.0},
             "span_ms": {"setup.front.tables": 4450.0}}
    assert reader(name)(ctx(plain, plain)) is None


def test_tiny_chr1_run_is_correct(tmp_path):
    """lr-chr1 cut to a 400 kb graph (denser sites, as conftest's tiny
    copies), with a few dozen short reads a file."""
    root = tmp_path / "bench"
    (root / "configs").mkdir(parents=True)
    (root / "traffic").mkdir()
    shutil.copytree(PB / "metrics", root / "metrics")
    cfg = json.loads((PB / "configs" / "lr-chr1.json").read_text())
    cfg.update(graph_bp=400_000, threads=2)
    cfg["graph"]["sites_per_mb"] = 50.0
    (root / "configs" / "lr-chr1.json").write_text(json.dumps(cfg))
    tr = json.loads((PB / "traffic" / "amplicon.json").read_text())
    tr.update(reads_per_file=40, pool_files=2)
    (root / "traffic" / "amplicon.json").write_text(json.dumps(tr))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [c for c in bench["configs"]
                        if c["name"] == "lr-chr1"]
    bench["workloads"] = [{"name": "t.chr1", "config": "lr-chr1",
                           "traffic": "amplicon", "chips": 1,
                           "why": "tiny lr-chr1"}]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["t.chr1"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = Spec(root, root / "BENCHMARK.json").cell("t.chr1")
    res = run_cell(cell, 2**33 + 21, 1.0, False, device="cpu",
                   front_kw=CPU_FRONT)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert res["checks"]["sample_reads_differ"] == {"value": 0, "limit": 0}
