"""The run's plumbing at a tiny size on the CPU (the port's plain
versions, device="cpu"), the real command's refusal without a card,
and `correct` coming out false with the timed path broken underneath."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import CPU_FRONT, ROOT
from portbench import harness
from portbench.harness import run_cell

SEED = 2**31 + 77


def _run(cell, trace=False):
    return run_cell(cell, SEED, 1.0, trace, device="cpu",
                    front_kw=CPU_FRONT)


@pytest.mark.parametrize("wl", ["t.lr", "t.asm"])
def test_plumbing_tiny_cpu(tiny_spec, wl):
    res = _run(tiny_spec.cell(wl))
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"query_bp_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["checks"]["gaf_reads_differ"] == {"value": 0, "limit": 0}
    assert res["checks"]["sample_reads_differ"] == {"value": 0, "limit": 0}
    json.dumps(res)


def test_traced_run_reports_per_layer(tiny_spec):
    res = _run(tiny_spec.cell("t.lr"), trace=True)
    assert res["correct"] is True
    m = res["metrics"]
    assert {"loop.device_share_pct", "tail.ms_per_mbp", "setup.index_s",
            "setup.front_s"} <= set(m)
    # no device on the CPU: the trace's readers find nothing to read
    assert "kernels.busy_ms_per_mbp" not in m and "device.idle_pct" not in m
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "lr.pb15k", "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert r.returncode != 0 and r.stdout == ""


def _alter(res):          # an answer altered where it is produced
    k = next(k for k, v in sorted(res.items()) if v)
    f = res[k].split("\t")
    f[11] = str((int(f[11]) + 1) % 61)        # the mapping quality
    res[k] = "\t".join(f)
    return res


def _drop_half(res):      # half of the batch left out
    return {k: ("" if i % 2 else v)
            for i, (k, v) in enumerate(sorted(res.items()))}


def _stale(res):          # a step that returns its state unchanged
    keys = sorted(res)
    return {k: res[keys[max(0, i - 1)]] for i, k in enumerate(keys)}


@pytest.mark.parametrize("fault", [_alter, _drop_half, _stale])
def test_broken_path_is_not_correct(tiny_spec, monkeypatch, fault):
    from minigraph_tpu_torch.mapping import mapper
    real = mapper.map_batch_native

    def broken(*args, **kw):
        return fault(real(*args, **kw))
    monkeypatch.setattr(mapper, "map_batch_native", broken)
    res = _run(tiny_spec.cell("t.lr"))
    assert res["correct"] is False
    assert res["checks"]["gaf_reads_differ"]["value"] > 0


@pytest.mark.parametrize("fault", [_drop_half, _stale])
def test_broken_path_fails_the_independent_sample(tiny_spec, monkeypatch,
                                                 fault):
    """The sample held to pyref catches a fault on its own (the frozen
    reference's comparison is taken out of the run here)."""
    from minigraph_tpu_torch.mapping import mapper
    from portbench import check
    real = mapper.map_batch_native
    monkeypatch.setattr(mapper, "map_batch_native",
                        lambda *a, **kw: fault(real(*a, **kw)))
    monkeypatch.setattr(check, "compare_file", lambda got, want: (0, 0))
    res = _run(tiny_spec.cell("t.lr"))
    assert res["checks"]["gaf_reads_differ"]["value"] == 0
    assert res["checks"]["sample_reads_differ"]["value"] > 0
    assert res["correct"] is False


@pytest.mark.cuda
def test_cell_on_card(card):
    """The real cell, a short window, on the card."""
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "lr.pb15k", "--seed", str(SEED), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.splitlines()[-1])["correct"] is True


def test_main_prints_checks_last(tiny_spec, monkeypatch, capsys):
    monkeypatch.setattr(harness, "Spec", lambda: tiny_spec)
    real = harness.run_cell
    monkeypatch.setattr(harness, "run_cell", lambda cell, seed, s, t, **kw:
                        real(cell, seed, s, t, device="cpu",
                             front_kw=CPU_FRONT))
    assert harness.main(["--workload", "t.asm", "--seed", "5", "--seconds",
                         "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.splitlines()[-1])["correct"] is True
    assert [ln.split(":")[0] for ln in err.splitlines()[-3:]] == [
        "check gaf_reads_differ", "check reads_unjudged",
        "check sample_reads_differ"]
    assert err.splitlines()[-1] == "check sample_reads_differ: 0 (limit 0)"
