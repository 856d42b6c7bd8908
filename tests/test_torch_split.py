"""The port's native file loop (mapping/mapper.py _map_file_native) with
its host/device split, on the CPU: the GAF bytes with a CPU device front
and the split pinned at share 0, left at its start of 0.35, and
collapsed with device probes equal the JAX package's host-only
map_files and the port's device=None run, over >= 8 arena batches,
with the device share cut into one, two or more groups a batch (the
front running the same bucket batches); the port's NativeSeqReader cuts
the batches where BSeqFile.read_batch does; a collapsed split's probe
refreshes the device cost estimate t_dev; an exception in a queued
native tail reaches the caller; no tail of batch k is in flight when
the reader hands out batch k + 2; the split's learned state carries
from one map_reads call to the next on one front.  The share controller
(mapping/split.py ShareSplit) on made-up costs, with no front: the
finish-together target and its clamps, the two collapses, the reopen,
cold costs, the probe cadence, whose interval equals the JAX package's
_probe_interval.  Inputs from tools/synth.py.  Tolerance 0."""
import io
import math
import sys
import threading
import time

import pytest
import torch

from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.mapping.mapper import _probe_interval as jax_probe_interval
from minigraph_tpu.mapping.mapper import map_files as jax_map_files
from minigraph_tpu.options import IndexOptions as JaxIndexOptions
from minigraph_tpu.options import MapOptions as JaxMapOptions
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.mapping import split as split_mod
from minigraph_tpu_torch.mapping.device_front import DeviceFront
from minigraph_tpu_torch.mapping.split import ShareSplit
from minigraph_tpu_torch.options import (MG_M_SHOW_UNMAP, IndexOptions,
                                         MapOptions)
from minigraph_tpu_torch.seqio.bseq import BSeqFile, NativeSeqReader
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)
from minigraph_tpu_torch.utils import trace

torch.set_num_threads(1)

FLAG = MG_M_SHOW_UNMAP
BATCH_BP = 4000        # ~6 reads an arena batch


def opts(batch_bp=BATCH_BP):
    mo = MapOptions(flag=FLAG)
    mo.mini_batch_size = batch_bp
    return mo


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("split")
    ref = make_reference(150_000, seed=91)
    hap = write_bubble_rgfa(ref, 92, str(d / "g.gfa"), seg_len=20_000)
    reads = simulate_reads([hap, ref], 48, seed=93, mean_len=700,
                           min_len=200, max_len=1000)
    # an empty read and one longer than the front's bucket (host only)
    reads[5] = ("empty", "")
    reads += simulate_reads([hap], 1, seed=94, mean_len=1500,
                            min_len=1400, max_len=1600)
    write_fasta(str(d / "r.fa"), reads)
    gfa, fa = str(d / "g.gfa"), str(d / "r.fa")
    want = io.StringIO()
    jmo = JaxMapOptions(flag=FLAG)
    jmo.mini_batch_size = BATCH_BP
    jax_map_files(jax_read_gfa(gfa), [fa], JaxIndexOptions(), jmo,
                  out=want, n_threads=2, device=False)
    host, st = io.StringIO(), {}
    mapper.map_files(read_gfa(gfa), [fa], IndexOptions(), opts(), out=host,
                     n_threads=2, device=None, stats=st)
    assert host.getvalue() == want.getvalue()
    assert want.getvalue().count("\n") >= 40
    assert st["n_arena"] >= 8, st
    gi = build_index(read_gfa(gfa), 17, 11, opts())
    return gfa, fa, gi, want.getvalue()


def front_run(files, state, batch_bp=BATCH_BP, pad_len=1024, bsz=8):
    """map_reads with a CPU front on one small bucket and the given
    split state; returns (GAF text, stats, split state)."""
    _, fa, gi, _ = files
    mo = opts(batch_bp)
    front = DeviceFront(gi, mo, device="cpu", buckets=((pad_len, bsz),),
                        chain_window=64)
    if state is not None:
        front._split_state = state
    out, st = io.StringIO(), {}
    mapper.map_reads(gi, mo, [fa], out, 2, front, st)
    return out.getvalue(), st, front._split_state


# the device share's groups a batch: (the bucket's batch size, reads a
# tail worker in C, so n_threads = 2 times it a group); ~6 reads a batch
GROUPS = {"one": (8, 32), "two": (2, 2), "many": (1, 1)}


def record_groups(monkeypatch):
    """Wrap the open split's group submits: a list a batch of (reads,
    bucket batches the front ran) a group."""
    batches = []
    real_open, real_submit = mapper._open_split_submit, mapper._submit_group

    def open_submit(*a, **k):
        batches.append([])
        return real_open(*a, **k)

    def submit_group(front, st, group):
        n0 = front.n_batches
        h = real_submit(front, st, group)
        batches[-1].append((len(group), front.n_batches - n0))
        return h
    monkeypatch.setattr(mapper, "_open_split_submit", open_submit)
    monkeypatch.setattr(mapper, "_submit_group", submit_group)
    return batches


@pytest.mark.parametrize("groups", ["one", "two", "many"])
@pytest.mark.parametrize("state", ["pinned", "start", "collapsed"])
def test_split_gaf_matches_host(files, state, groups, monkeypatch):
    init = {"pinned": ShareSplit(share=0.0), "start": None,
            "collapsed": ShareSplit(collapsed=True)}[state]
    bsz, per_thread = GROUPS[groups]
    monkeypatch.setattr(mapper, "TAIL_READS_PER_THREAD", per_thread)
    batches = record_groups(monkeypatch)
    # pinned: a bucket that takes the long read too, so the host maps no
    # eligible read, measures no cost and the share stays at 0
    got, st, split = front_run(files, init, bsz=bsz,
                               pad_len=2048 if state == "pinned" else 1024)
    assert got == files[3]
    assert st["n_arena"] >= 8, st
    n_reads = st["n_share_dev"] + st["n_share_host"]
    assert n_reads == 49 - 1, st                  # all but the empty read
    # each group whole bucket batches, the fewest that give the two
    # workers per_thread reads each (the batch's last group what is
    # left), and the front runs the batches one submit of the batch's
    # device share would: one a bsz reads, the last one partial
    target = 2 * per_thread
    assert st.get("n_tail_groups", 0) == sum(map(len, batches)), st
    for grp in batches:
        r = sum(n for n, _ in grp)
        assert sum(b for _, b in grp) == math.ceil(r / bsz), grp
        assert len(grp) == math.ceil(math.ceil(r / bsz)
                                     / math.ceil(target / bsz)), grp
        for n, b in grp[:-1]:
            assert n % bsz == 0 and n >= target > n - bsz, grp
    if state != "collapsed":
        most = max(map(len, batches))
        assert most == {"one": 1, "two": 2}.get(groups, most) \
            and (groups != "many" or most >= 3), batches
    if state == "pinned":
        assert st["n_share_host"] == 0 and split.share == 0.0, st
        assert st["n_device"] + st["n_fallback"] + st["n_chain_unsure"] \
            == 48, st
        assert st["n_device"] >= 16, st
        assert st["n_batches"] == sum(math.ceil(sum(n for n, _ in g) / bsz)
                                      for g in batches), st
        if groups == "one":
            assert st["n_batches"] == st["n_arena"], st
        # the reads the front flagged or could not chain took the
        # worker's collect, none the per-read path
        assert st["n_fallback"] + st["n_chain_unsure"] > 0, st
        assert st["n_perread"] == 0, st
    elif state == "start":
        assert split.t_dev is not None and split.t_host is not None
        assert st["n_share_dev"] > 0 and st["n_share_host"] > 1, st
    else:
        assert st["n_probes"] >= 1 and st["collapsed"], st
        assert st["n_share_dev"] <= 8 * st["n_probes"], st


def test_collapsed_probe_refreshes_t_dev(files):
    """A collapsed split probes every 8th arena batch while it has no
    cost estimates; the first probe runs the bucket cold, so the second
    sets t_dev."""
    got, st, split = front_run(files, ShareSplit(collapsed=True),
                               batch_bp=1500)
    assert got == files[3]
    assert st["n_arena"] >= 16 and st["n_probes"] >= 2, st
    assert split.t_dev is not None and split.t_host is not None


def _front_batches(buckets, qlen, reads):
    """The bucket batches front.submit runs for `reads`: a sorted list
    of tuples of arena indices."""
    by = {}
    for k in reads:
        pad, bsz = next(b for b in sorted(buckets) if qlen[k] <= b[0])
        by.setdefault((pad, bsz), []).append(k)
    return sorted(tuple(ks[i: i + bsz]) for (_, bsz), ks in by.items()
                  for i in range(0, len(ks), bsz))


@pytest.mark.parametrize("case,want", [
    ("short", [4, 4, 2]),            # 1024 bucket: a read weighs 1
    ("long", [40]),                  # 4096 bucket: 1/16, one group
    ("mixed", [4, 8, 18])])           # a group closes on its weight
def test_tail_groups_weigh_the_buckets(monkeypatch, case, want):
    """_tail_groups on two buckets, two tail threads of 2 reads (a
    group's weight 4): groups of whole bucket batches that together run
    the batches one submit of the share runs, a read of the 4096 bucket
    weighing (1024 / 4096)^2."""
    import numpy as np

    class Front:
        buckets = ((1024, 4), (4096, 2))
    monkeypatch.setattr(mapper, "TAIL_READS_PER_THREAD", 2)
    qlen = {"short": [500] * 10, "long": [3000] * 40,
            "mixed": [500] * 4 + [3000] * 4 + [500] * 6 + [3000] * 16}[case]
    qlen = np.array(qlen + [0])
    cand = list(range(len(qlen) - 1))
    groups = mapper._tail_groups(Front, cand, qlen, 2)
    assert [len(g) for g in groups] == want
    assert sorted(k for g in groups for k in g) == cand
    got = sorted(b for g in groups
                 for b in _front_batches(Front.buckets, qlen, g))
    assert got == _front_batches(Front.buckets, qlen, cand)


def test_tail_exception_reaches_the_caller(files, monkeypatch):
    """A native tail that raises on the tail worker: map_reads raises it
    on its own thread, within a time limit, the worker is gone and the
    interpreter's switch interval is what it was."""
    switch = sys.getswitchinterval()
    real = mapper.map_batch_native
    calls = []

    def failing(*a, **k):
        calls.append(threading.current_thread().name)
        if len(calls) == 3:
            raise RuntimeError("tail failed")
        return real(*a, **k)
    monkeypatch.setattr(mapper, "map_batch_native", failing)
    monkeypatch.setattr(mapper, "TAIL_READS_PER_THREAD", 1)
    got = []

    def run():
        try:
            front_run(files, ShareSplit(share=0.0), pad_len=2048, bsz=2)
        except BaseException as e:
            got.append(e)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "the file loop hangs"
    assert len(got) == 1 and isinstance(got[0], RuntimeError), got
    assert str(got[0]) == "tail failed" and calls[2] == "mgt-tail", calls
    assert not any(t.name == "mgt-tail" and t.is_alive()
                   for t in threading.enumerate())
    assert sys.getswitchinterval() == switch


def test_counts_exact_under_a_short_switch_interval(files, monkeypatch):
    """The loop's thread and the tail worker both add to `stats` and to
    the span registry: with a switch interval of 1 us and a group a
    read, no count is lost (the reads add up, the tails' spans sum to
    tail_ms) and the bytes hold."""
    monkeypatch.setattr(mapper, "TAIL_READS_PER_THREAD", 1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = trace.snapshot()
        got, st, _ = front_run(files, None, batch_bp=1 << 30, bsz=1)
        after = trace.snapshot()
    finally:
        sys.setswitchinterval(old)
    assert got == files[3]
    assert st["n_share_dev"] + st["n_share_host"] == 48, st
    assert st["n_share_host"] > 0 and st["n_tail_groups"] >= 8, st
    tails = sum(after["span_ms"].get(t, 0.0) - before["span_ms"].get(t, 0.0)
                for t in ("tail.host_share", "tail.device_share",
                          "tail.probe"))
    assert tails == pytest.approx(st["tail_ms"], rel=1e-9), st


def test_no_tail_in_flight_two_batches_on(files, monkeypatch):
    """The reader hands out batch k + 2 (and the prefetch recycles batch
    k - 1's arena) only once no native tail of batch k is running: each
    arena batch's tails end before the loop takes the next batch."""
    real_read = NativeSeqReader.read_batch_arena
    real_tail = mapper.map_batch_native
    lock = threading.Lock()
    handed, running, addr, bad = [], [], {}, []

    def read_batch_arena(self, *a, **k):
        with lock:
            j = len(handed)
            handed.append(j)
            late = [i for i in running if i <= j - 2]
            if late:
                bad.append((j, late))
        a = real_read(self, *a, **k)
        if a is not None:
            with lock:
                addr[a[1]] = j
        return a

    def tail(*a, blob=None, **k):
        with lock:
            j = addr[blob[1]]
            running.append(j)
            if len(handed) - 1 >= j + 2:    # batch j + 2 read or reading
                bad.append((len(handed) - 1, [j]))
        try:
            time.sleep(0.01)        # widen the window
            return real_tail(*a, blob=blob, **k)
        finally:
            with lock:
                running.remove(j)
    monkeypatch.setattr(NativeSeqReader, "read_batch_arena",
                        read_batch_arena)
    monkeypatch.setattr(mapper, "map_batch_native", tail)
    monkeypatch.setattr(mapper, "TAIL_READS_PER_THREAD", 1)
    got, st, _ = front_run(files, ShareSplit(share=0.0), pad_len=2048,
                           bsz=2)
    assert got == files[3] and st["n_arena"] >= 8
    assert st["n_tail_groups"] > st["n_arena"], st
    assert not bad, bad


@pytest.mark.parametrize("max_bp", [1, 700, 3000, 1 << 30])
def test_native_reader_batches_match_bseq(files, max_bp):
    fa = files[1]
    rdr = NativeSeqReader(fa)
    fp = BSeqFile(fa)
    import ctypes as ct
    try:
        while True:
            want = fp.read_batch(max_bp)
            a = rdr.read_batch_arena(max_bp)
            if a is None:
                assert not want
                break
            n, sq_addr, sq_off, nm_addr, nm_off = a
            got = [(ct.string_at(nm_addr + int(nm_off[k]),
                                 int(nm_off[k + 1] - nm_off[k])).decode(),
                    ct.string_at(sq_addr + int(sq_off[k]),
                                 int(sq_off[k + 1] - sq_off[k])).decode())
                   for k in range(n)]
            assert got == [(r.name, r.seq) for r in want]
    finally:
        rdr.close()
        fp.close()


def test_native_reader_refuses_missing_file(tmp_path):
    with pytest.raises(OSError):
        NativeSeqReader(str(tmp_path / "absent.fa"))


@pytest.mark.parametrize("split", [
    {}, {"t_dev": None, "t_host": 1e-3},
    {"t_dev": 1.02e-3, "t_host": 0.18e-3}, {"t_dev": 70e-3, "t_host": 2.7e-3},
    {"t_dev": 1e-6, "t_host": 1.0}, {"t_dev": 10.0, "t_host": 1e-4}])
def test_probe_interval_matches_jax(split):
    ctl = ShareSplit()
    ctl.t_dev, ctl.t_host = split.get("t_dev"), split.get("t_host")
    assert ctl.probe_interval() == jax_probe_interval(split)


def test_split_state_carries_across_files(files, monkeypatch):
    """Two map_reads calls on one front (as the benchmark maps its files):
    the second starts from the first's learned share and costs, on the
    same ShareSplit, and both write the host run's bytes."""
    _, fa, gi, want = files
    mo = opts()
    front = DeviceFront(gi, mo, device="cpu", buckets=((1024, 8),),
                        chain_window=64)
    shares = []
    real_plan = ShareSplit.plan

    def plan(self, n, n_elig):
        shares.append((self.share, self.t_dev, self.t_host))
        return real_plan(self, n, n_elig)
    monkeypatch.setattr(ShareSplit, "plan", plan)
    out = io.StringIO()
    mapper.map_reads(gi, mo, [fa], out, 2, front, {})
    split = front._split_state
    assert isinstance(split, ShareSplit) and shares[0] == (0.35, None, None)
    assert split.t_dev is not None and split.t_host is not None
    learned = (split.share, split.t_dev, split.t_host)
    n_first = len(shares)
    out2 = io.StringIO()
    mapper.map_reads(gi, mo, [fa], out2, 2, front, {})
    assert front._split_state is split
    assert shares[n_first] == learned
    assert out.getvalue() == out2.getvalue() == want


@pytest.mark.parametrize("t_dev,t_host,share", [
    (1.0, 3.0, 0.25),                # the host takes t_dev / (sum)
    (3.0, 1.0, 0.75),
    (0.95, 0.05, 0.9),               # 0.95: clamped at 0.9
    (0.96, 0.04, 1.0)])              # over 0.95: the device does not pay
def test_share_is_the_finish_together_target(t_dev, t_host, share):
    ctl = ShareSplit()
    ctl.device_cost(t_dev, 1, False)
    ctl.host_cost(t_host, t_host, 1)
    ctl.end_batch(10)
    assert ctl.share == pytest.approx(share) and not ctl.collapsed
    assert ctl.plan(10, 8) == 8 - int(8 * ctl.share)


@pytest.mark.parametrize("targets,collapsed", [
    ([0.96], False), ([0.96, 0.96], True), ([0.96, 0.5, 0.96], False)])
def test_collapse_on_two_high_targets_in_a_row(targets, collapsed):
    """A target over 0.95 twice in a row collapses the split; once, or
    twice with a lower one between, does not."""
    ctl = ShareSplit()
    for tgt in targets:
        ctl.t_dev, ctl.t_host = tgt, 1.0 - tgt
        ctl.end_batch(10)
    assert ctl.collapsed == collapsed
    assert ctl.share == (1.0 if targets[-1] > 0.95 else 0.5)


@pytest.mark.parametrize("case,cycles,cyc_s,t_cpu,collapsed", [
    ("three cycles, one thread 2x faster", 3, 0.1, 5e-4, True),
    ("two cycles only", 2, 0.1, 5e-4, False),
    ("one thread as fast, under 8% ahead", 3, 0.1, 1e-3, False),
    ("build-length cycles", 3, 10.0, 5e-4, False)])
def test_collapse_when_one_host_thread_beats_the_blend(
        monkeypatch, case, cycles, cyc_s, t_cpu, collapsed):
    """Batches of 100 reads cycling every cyc_s s: the blend maps
    100 / cyc_s reads a second; one host thread at t_cpu s a read beats
    it by more than 8% once three cycles are in the average.  A cycle of
    over 0.05 s a read is a build's and not counted."""
    now = [0.0]
    monkeypatch.setattr(split_mod, "_clock", lambda: now[0])
    ctl = ShareSplit()
    ctl.t_dev = ctl.t_host = 1e-3           # target 0.5
    ctl.t_host_cpu = t_cpu
    ctl.end_batch(100)                      # the first end: no cycle yet
    for _ in range(cycles):
        now[0] += cyc_s
        ctl.end_batch(100)
    assert ctl.collapsed == collapsed, case
    assert ctl.nb_mix == (0 if cyc_s > 5 else cycles)
    assert ctl.share == (1.0 if collapsed else 0.5)


@pytest.mark.parametrize("probes,reopened", [
    (["low"], False), (["low", "low"], True), (["low", "high", "low"], False),
    (["low", "cold", "none", "low"], True)])
def test_reopen_after_two_low_probes_in_a_row(probes, reopened):
    """Collapsed, a warm probe at a target <= 0.45 counts toward the
    reopen, one above it resets the count; a cold probe and a batch with
    no probe leave it.  On reopen the share stays 1.0 for the next batch
    and the blended rate starts afresh."""
    ctl = ShareSplit(collapsed=True)
    ctl.host_cost(1e-2, 1e-2, 10)          # 1 ms a read
    ctl.rate_mix, ctl.nb_mix = 5000.0, 4
    for p in probes:
        if p != "none":
            # the average restarted: each probe's target is its own
            # (0.33 low, 0.83 high)
            ctl.t_dev = None
            ctl.device_cost({"high": 5e-2}.get(p, 5e-3), 10, p == "cold")
        ctl.end_batch(40)
    assert ctl.collapsed != reopened and ctl.share == 1.0
    assert (ctl.rate_mix, ctl.nb_mix, ctl.reopen) == (
        (None, 0, 0) if reopened else (5000.0, 4, 1))


@pytest.mark.parametrize("collapsed", [False, True])
def test_cold_device_cost_is_not_a_cost(collapsed):
    """A device cost from a submit that built the kernels or ran a bucket
    cold leaves t_dev; the next warm one sets it."""
    ctl = ShareSplit(collapsed=collapsed)
    ctl.device_cost(5.0, 10, True)
    assert ctl.t_dev is None
    ctl.device_cost(0.02, 10, False)
    assert ctl.t_dev == pytest.approx(0.002)


@pytest.mark.parametrize("t_dev,t_host,interval", [
    (None, None, 8), (2e-3, 1e-4, 100), (1.0, 1e-4, 256)])
def test_probe_cadence(t_dev, t_host, interval):
    """Collapsed, every interval-th batch probes max(8, n // 4) of the
    batch's n reads (at most its eligible ones); the others send none.
    Open, the device takes what the share leaves."""
    ctl = ShareSplit(collapsed=True)
    ctl.t_dev, ctl.t_host = t_dev, t_host
    got = [ctl.plan(100, 60) for _ in range(2 * interval)]
    assert [k + 1 for k, g in enumerate(got) if g] == [interval,
                                                       2 * interval]
    assert max(got) == 25
    ctl.nb = interval - 1
    assert ctl.plan(20, 60) == 8 and ctl.nb == interval
    ctl.nb = interval - 1
    assert ctl.plan(100, 3) == 3
    assert ShareSplit().plan(100, 60) == 60 - 21
