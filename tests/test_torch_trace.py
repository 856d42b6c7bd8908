"""The port's spans and counters (minigraph_tpu_torch/utils/trace.py) on
the CPU: every span of the file loop, the device front and the set-up
reaches map_reads' stats; the native tail's spans sum to tail_ms; the
front's inner spans fit inside their parents; under a CPU torch.profiler
the spans are "mg:" ranges of the exported trace, nested as named, and
with no profiler record_function is never entered; the GAF bytes do
not change with a profiler; the five attributes that portbench's traced
run wraps still see every call; in the open split the tail.* spans are
the tail worker's and the front.* spans the loop thread's; and
stats["submit_tail_overlap_ms"] counts the part of the front's submits
during which the worker ran a tail call.  A tiny synthetic graph, a CPU
front on one small bucket, several arena batches a file."""
import functools
import io
import json
import math
import sys
import threading
from pathlib import Path

import pytest
import torch

from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.mapping.device_front import DeviceFront
from minigraph_tpu_torch.mapping.split import ShareSplit
from minigraph_tpu_torch.options import (MG_M_SHOW_UNMAP, IndexOptions,
                                         MapOptions)
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)
from minigraph_tpu_torch.utils import trace

torch.set_num_threads(1)

BATCH_BP = 4000        # ~6 reads an arena batch
LOOP = ("loop.read_wait", "read.arena", "loop.emit")
SUBMIT = ("front.encode", "front.upload", "front.dispatch", "front.stage")
STAGES = ("front.sketch", "front.collect", "front.chain", "front.backtrack",
          "front.pack")
GATHER = ("front.wait", "front.unpack")
SETUP = ("setup.index", "setup.front.tables", "setup.front.upload")
TAILS = ("tail.host_share", "tail.device_share", "tail.probe")
# the split's start, as a new front's first file finds it
OPEN = ShareSplit
# every read to the device: each arena batch submits and finishes once
PINNED = functools.partial(ShareSplit, share=0.0)
COLLAPSED = functools.partial(ShareSplit, collapsed=True)


def opts(batch_bp=BATCH_BP):
    mo = MapOptions(flag=MG_M_SHOW_UNMAP)
    mo.mini_batch_size = batch_bp
    return mo


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    ref = make_reference(150_000, seed=191)
    hap = write_bubble_rgfa(ref, 192, str(d / "g.gfa"), seg_len=20_000)
    reads = simulate_reads([hap, ref], 40, seed=193, mean_len=700,
                           min_len=200, max_len=1000)
    write_fasta(str(d / "r.fa"), reads)
    gfa, fa = str(d / "g.gfa"), str(d / "r.fa")
    gi = build_index(read_gfa(gfa), 17, 11, opts())
    host = io.StringIO()
    mapper.map_reads(gi, opts(), [fa], host, 2, None, {})
    assert host.getvalue().count("\n") >= 35
    return fa, gi, host.getvalue()


def new_front(gi, state=None):
    front = DeviceFront(gi, opts(), device="cpu", buckets=((1024, 8),),
                        chain_window=64)
    front._split_state = (state or OPEN)()
    return front


def run(files, front, batch_bp=BATCH_BP):
    """map_reads of the file with `front`; (GAF text, stats, the spans'
    ms and calls this run added)."""
    fa, gi, _ = files
    before = trace.snapshot()
    out, st = io.StringIO(), {}
    mapper.map_reads(gi, opts(batch_bp), [fa], out, 2, front, st)
    after = trace.snapshot()
    return out.getvalue(), st, delta(before, after)


def delta(before, after):
    d = {}
    for key in ("span_ms", "span_n"):
        d[key] = {k: v - before[key].get(k, 0)
                  for k, v in after[key].items()
                  if v - before[key].get(k, 0)}
    return d


def test_every_span_reaches_stats(files):
    """The open split and a collapsed one with its probes name every
    span; stats hold the registry's totals beside stage_ms."""
    fa, gi, want = files
    before = trace.snapshot()
    got, st, d_open = run(files, new_front(gi))
    assert got == want
    got, st_c, d_col = run(files, new_front(gi, COLLAPSED), batch_bp=1500)
    assert got == want
    assert st["n_arena"] >= 5 and st_c["n_probes"] >= 1, (st, st_c)
    names = set(d_open["span_ms"]) | set(d_col["span_ms"])
    assert names >= set(LOOP + SUBMIT + STAGES + GATHER + TAILS
                        + ("front.submit", "front.gather")), names
    # the set-up spans: the fixture's index, the two fronts' tables
    setup = delta(before, trace.snapshot())["span_n"]
    assert setup["setup.front.tables"] == setup["setup.front.upload"] == 2
    assert trace.snapshot()["span_n"]["setup.index"] >= 1
    for s in (st, st_c):
        assert set(s["span_ms"]) == set(s["span_n"])
        assert set(s["stage_ms"]) == {x.split(".")[1] for x in STAGES}
    # per batch, never per read: one submit span a device share
    assert d_open["span_n"]["front.submit"] <= st["n_arena"]
    assert d_open["span_n"]["loop.emit"] == st["n_arena"]


def test_tail_spans_sum_to_tail_ms(files):
    fa, gi, _ = files
    for state, bp in ((OPEN, BATCH_BP), (COLLAPSED, 1500)):
        _, st, d = run(files, new_front(gi, state), batch_bp=bp)
        tails = sum(d["span_ms"].get(t, 0.0) for t in TAILS)
        assert st["tail_ms"] > 0
        assert tails == pytest.approx(st["tail_ms"], rel=0.01), (d, st)


def test_children_fit_inside_parents(files):
    fa, gi, _ = files
    _, st, d = run(files, new_front(gi))
    ms = d["span_ms"]
    assert sum(ms[k] for k in SUBMIT) <= ms["front.submit"]
    assert sum(ms[k] for k in GATHER) <= ms["front.gather"]
    assert sum(ms[k] for k in STAGES) <= ms["front.dispatch"]
    n = d["span_n"]
    assert n["front.encode"] == n["front.dispatch"] == n["front.pack"] \
        == n["front.stage"]
    # every chunk is handed on as views: no copy of the host's own
    assert "front.copy" not in n
    assert st["stage_bytes"] > 0 and st["stage_pinned_bytes"] == 0


def _ranges(events):
    """The trace's "mg:" ranges by name: [(start, end, thread)]."""
    out = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and name.startswith(trace.PREFIX):
            ts = float(e["ts"])
            out.setdefault(name[len(trace.PREFIX):], []).append(
                (ts, ts + float(e["dur"]), e.get("tid")))
    return out


def _inside(child, parents):
    a, b, tid = child
    return any(pa <= a and b <= pb and pt == tid for pa, pb, pt in parents)


def test_profiler_ranges_nested_and_bytes_unchanged(files, tmp_path):
    fa, gi, want = files
    front = new_front(gi)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got, st, d = run(files, front)
    assert got == want
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    rg = _ranges(json.loads(path.read_text())["traceEvents"])
    # the profiler records the thread that started it: the reader's
    # prefetch thread (read.arena) and the open split's tail worker
    # (every tail.device_share, the open batches' tail.host_share) have
    # no range; a collapsed batch maps its host share on the loop's
    main = set(LOOP + SUBMIT + STAGES + GATHER + (
        "front.submit", "front.gather")) - {"read.arena"}
    assert set(rg) >= main and "read.arena" not in rg, rg
    assert "tail.device_share" not in rg and d["span_n"]["tail.device_share"]
    assert len(rg.get("tail.host_share", ())) < d["span_n"]["tail.host_share"]
    for parent, kids in (("front.submit", SUBMIT),
                         ("front.dispatch", STAGES),
                         ("front.gather", GATHER)):
        for k in kids:
            assert all(_inside(c, rg[parent]) for c in rg[k]), (parent, k)
    # one range for each span the registry counted
    for name in main:
        assert len(rg[name]) == d["span_n"][name], name


def test_no_record_function_without_a_profiler(files, monkeypatch):
    fa, gi, want = files

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    got, st, d = run(files, new_front(gi))
    assert got == want and d["span_n"]["front.submit"] >= 1


def test_wrapped_attributes_see_every_call(files, monkeypatch):
    """portbench's traced run wraps these five attributes; the file loop
    still calls each through the module or the instance."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import tracing
    fa, gi, want = files
    front = new_front(gi, PINNED)
    calls = {}

    def counted(obj, attr):
        real = getattr(obj, attr)

        def f(*a, **k):
            calls[attr] = calls.get(attr, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(obj, attr, f)
    for attr in ("_map_host_share", "_open_split_finish",
                 "map_batch_native"):
        counted(mapper, attr)
    for attr in ("submit", "gather_flat"):
        counted(front, attr)
    undo = tracing.wrap_layers(mapper, front)
    try:
        got, st, d = run(files, front)
    finally:
        tracing.unwrap(undo)
    assert got == want
    n = d["span_n"]
    assert calls["submit"] == n["front.submit"] >= 2
    assert calls["gather_flat"] == n["front.gather"]
    assert calls["map_batch_native"] == sum(n.get(t, 0) for t in TAILS)
    assert calls["_map_host_share"] == st["n_arena"]
    assert calls["_open_split_finish"] == st["n_arena"]


def test_open_split_threads_and_submit_overlap(files, monkeypatch):
    """In the open split the tail.* spans are entered on the tail worker
    only and the front.* spans on the loop's thread only; the submits'
    overlap with the worker's calls is at most the front.submit spans,
    and 0 with one group and no host share (nothing runs on the worker
    while the one submit does)."""
    fa, gi, want = files
    seen = {}

    class span(trace.span):
        __slots__ = ()

        def __enter__(self):
            seen.setdefault(self.name, set()).add(
                threading.current_thread().name)
            return super().__enter__()
    monkeypatch.setattr(trace, "span", span)
    monkeypatch.setattr(mapper, "TAIL_READS_PER_THREAD", 1)
    got, st, d = run(files, new_front(gi), batch_bp=1 << 30)
    assert got == want and st["n_arena"] == 1
    assert st["n_tail_groups"] == math.ceil(st["n_share_dev"] / 8) >= 2
    assert {"tail.host_share", "tail.device_share", "front.submit",
            "front.gather"} <= set(seen)
    loop = threading.current_thread().name
    for name, threads in seen.items():
        if name.startswith("tail."):
            assert threads == {"mgt-tail"}, (name, threads)
        elif name.startswith("front."):
            assert threads == {loop}, (name, threads)
    assert 0 < st["submit_tail_overlap_ms"] <= d["span_ms"]["front.submit"]
    monkeypatch.setattr(mapper, "TAIL_READS_PER_THREAD", 32)
    got, st, d = run(files, new_front(gi, PINNED), batch_bp=1 << 30)
    assert got == want and st["n_tail_groups"] == 1
    assert st["n_share_host"] == 0 and d["span_n"]["front.submit"] == 1
    assert st["submit_tail_overlap_ms"] == 0


def test_python_loop_device_path_spans(files, monkeypatch):
    """The Python reader loop's device path: the same spans around the
    same calls, the tails still summing to tail_ms."""
    fa, gi, want = files

    def refuse(path):
        raise OSError("native reader refused")
    monkeypatch.setattr(mapper, "NativeSeqReader", refuse)
    got, st, d = run(files, new_front(gi))
    assert got == want and "n_arena" not in st
    ms = d["span_ms"]
    assert {"front.submit", "front.gather", "tail.host_share",
            "tail.device_share"} <= set(ms)
    tails = sum(ms.get(t, 0.0) for t in TAILS)
    assert tails == pytest.approx(st["tail_ms"], rel=0.01)


def test_span_registry_counts_under_threads():
    """More threads than cores, a short switch interval: no span call is
    lost."""
    old = sys.getswitchinterval()
    n_threads, n_iter = 16, 400
    before = trace.snapshot()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_iter):
                with trace.span("test.stress"):
                    pass
        ths = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    d = delta(before, trace.snapshot())
    assert d["span_n"]["test.stress"] == n_threads * n_iter


def test_span_times_its_block():
    with trace.span("test.outer") as outer:
        with trace.span("test.inner") as inner:
            sum(range(10000))
    assert 0 < inner.ns <= outer.ns
    assert outer.ms == pytest.approx(outer.ns / 1e6)


def _x(name, ts, dur, tid=1, cat="cpu_op"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "tid": tid,
            "cat": cat}


def test_spanprof_idle_by_span_on_a_made_trace():
    """tools/spanprof.py: the device's gaps go to the chain of the main
    thread's ranges at each gap's middle; another thread's ranges and
    the device-side annotations are left out of the chains."""
    from minigraph_tpu_torch.tools import spanprof
    ev = [_x("mg:loop", 0, 100), _x("mg:front.submit", 10, 30),
          _x("mg:tail.device_share", 60, 30),
          _x("mg:read.arena", 50, 20, tid=2),
          _x("mg:front.submit", 10, 30, tid=0, cat="gpu_user_annotation"),
          _x("kernel_a", 0, 5, tid=7, cat="kernel"),
          _x("copy", 40, 20, tid=7, cat="gpu_memcpy"),
          _x("kernel_b", 90, 30, tid=7, cat="kernel")]
    red = spanprof.reduce(ev)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx(35e-6)
    assert red["idle_s"] == pytest.approx(65e-6)
    assert dict(red["idle_by_span"]) == pytest.approx(
        {"loop>front.submit": 35e-6, "loop>tail.device_share": 30e-6})
    assert red["ranges"]["front.submit"] == {"ms": 0.03, "n": 1}
    assert red["ranges"]["read.arena"]["n"] == 1
    assert spanprof.reduce([ev[-1]]) is None


def test_spanprof_profiles_the_cpu_front(files):
    """On the CPU front: a range for each span the main thread counted,
    and the whole window idle (no device events)."""
    from minigraph_tpu_torch.tools import spanprof
    fa, gi, want = files
    front = new_front(gi)
    before = trace.snapshot()
    out, st = io.StringIO(), {}
    _, red = spanprof.profile_spans(
        lambda: mapper.map_reads(gi, opts(), [fa], out, 2, front, st),
        cuda=False)
    d = delta(before, trace.snapshot())
    assert out.getvalue() == want
    for name in set(d["span_n"]) - {"read.arena"} - set(TAILS):
        assert red["ranges"][name]["n"] == d["span_n"][name], name
    # the open split's tails run on the tail worker: no range
    assert "tail.device_share" not in red["ranges"]
    assert red["ranges"].get("tail.host_share", {"n": 0})["n"] \
        < d["span_n"]["tail.host_share"]
    assert red["busy_s"] == 0 and red["idle_s"] == red["window_s"] > 0
    rep = spanprof.report(st, red)
    assert rep["spans"]["front.gather"]["range_n"] \
        == d["span_n"]["front.gather"]
    assert rep["n_arena"] == st["n_arena"] and "tail_dev_overlap_ms" not in rep


def test_spanprof_command_line_host_only(files, tmp_path, capsys):
    from minigraph_tpu_torch.tools import spanprof
    fa, gi, _ = files
    keep = tmp_path / "t.json"
    assert spanprof.main([str(Path(fa).parent / "g.gfa"), fa, "-t", "2",
                          "--device", "none", "--trace", str(keep)]) == 0
    rep = json.loads(capsys.readouterr().out)
    for name in ("setup.index", "loop.emit", "tail.host_share"):
        assert rep["spans"][name]["range_n"] >= 1, name
    assert rep["busy_s"] == 0 and rep["idle_by_span"]
    assert keep.stat().st_size > 0
