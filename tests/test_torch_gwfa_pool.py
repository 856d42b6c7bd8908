"""The device GWFA bridge pool of the port (align/gwfa_device.py, its
plain version on the CPU) against the JAX package's: DeviceGwfaPool.run
and run_multi and GwfaBatchSink on the same harvest rows (both query
buckets, oversize and empty jobs), result for result with the same
counts; then --gwfa-device through map_files on both routes of the
Python reader loop -- a device front on the CPU with one pool call a
read, and no front with one pool call a batch (GwfaBatchSink) -- with and
without -c: GAF bytes equal to the JAX package's pool route without a
front and to the host-only run, with bridges solved by the pool.  (The
JAX route with a front maps the same bytes; it compiles the JAX front,
~50 s on a CPU, so it is left out.)  Tolerance: exact equality."""
import contextlib
import io

import numpy as np
import pytest
import torch

from minigraph_tpu import cli as jax_cli
from minigraph_tpu.align.gwfa_device import DeviceGwfaPool as JaxPool
from minigraph_tpu.align.gwfa_device import GwfaBatchSink as JaxSink
from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.index.midx import build_index as jax_build_index
from minigraph_tpu_torch import cli
from minigraph_tpu_torch.align.gwfa_device import (DeviceGwfaPool,
                                                   GwfaBatchSink)
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.options import (MG_M_CIGAR, IndexOptions,
                                         MapOptions)
from minigraph_tpu_torch.tools.synth import (bridge_jobs, make_reference,
                                             simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gwfa_pool")
    ref = make_reference(300_000, seed=41)
    hap = write_bubble_rgfa(ref, 42, str(d / "g.gfa"), seg_len=5000,
                            bubble_every=2)
    write_fasta(str(d / "r.fa"),
                simulate_reads([hap, ref], 24, seed=43, mean_len=2500,
                               min_len=800, max_len=6000))
    return {"g": str(d / "g.gfa"), "r": str(d / "r.fa")}


def rows_of(jobs):
    """Harvest rows and the read each job's query sits in: jobs are laid
    end to end in one query, as a read's bridge sites are."""
    rows, q = [], b""
    for qb, v0, e0, v1, e1, med in jobs:
        rows.append([len(q), len(q) + len(qb), v0, e0, v1, e1, med, 0])
        q += qb
    return np.asarray(rows, dtype=np.int64), q.decode("latin-1")


def test_pool_matches_jax(files):
    g = read_gfa(files["g"])
    gi = build_index(g, 15, 10)
    jg = jax_read_gfa(files["g"])
    jgi = jax_build_index(jg, 15, 10)
    rng = np.random.default_rng(44)
    jobs = bridge_jobs(g, gi.es, rng, 400, 8, 4096)
    short = [j for j in jobs if len(j[0]) <= 256][:10]
    mid = [j for j in jobs if 256 < len(j[0]) <= 1024][:6]
    long = [j for j in jobs if len(j[0]) > 1024][:2]
    assert len(short) == 10 and len(mid) >= 3 and long
    allj = short + mid + long
    rows, qseq = rows_of(allj)
    rows = np.concatenate([rows, [[5, 5, 0, 0, 0, 0, 10, 0]]])  # empty job
    pool = DeviceGwfaPool(gi, device="cpu")
    jpool = JaxPool(jgi)
    got = pool.run(rows, qseq)
    want = jpool.run(rows, qseq)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    counts = ("n_jobs", "n_device", "n_flagged", "n_oversize")
    assert [getattr(pool, c) for c in counts] \
        == [getattr(jpool, c) for c in counts]
    assert pool.n_device > 0 and pool.n_oversize == len(long)
    assert pool.n_batches == 2 and pool.kernel_ms > 0
    assert (got[0] == -2).sum() == len(rows) - pool.n_device

    # run_multi and the batch sink: the jobs split over three reads
    parts = [allj[:5], allj[5:12], allj[12:]]
    sink, jsink = GwfaBatchSink(pool), JaxSink(jpool)
    tickets = []
    for part in parts:
        r, q = rows_of(part)
        tickets.append((sink.add(r, q), jsink.add(r, q)))
    sink.solve()
    jsink.solve()
    for t, jt in tickets:
        sink.queue_inject([t])
        jsink.queue_inject([jt])
        for a, b in zip(sink.pop_inject(), jsink.pop_inject()):
            assert np.array_equal(a, b)
    assert sink.pop_inject() is None
    assert [getattr(pool, c) for c in counts] \
        == [getattr(jpool, c) for c in counts]


def test_pool_kernel_time_inside_batch_time(files):
    """kernel_ms times the launch alone (the plain version on the CPU),
    batch_ms the whole wrapper call around it: 0 < kernel_ms <= batch_ms
    after each batch, and an empty run adds to neither."""
    g = read_gfa(files["g"])
    gi = build_index(g, 15, 10)
    jobs = bridge_jobs(g, gi.es, np.random.default_rng(45), 40, 8, 1024)
    pool = DeviceGwfaPool(gi, device="cpu")
    pool.run(np.empty((0, 8), dtype=np.int64), "")
    assert (pool.n_batches, pool.kernel_ms, pool.batch_ms) == (0, 0.0, 0.0)
    for part in (jobs[:3], jobs[3:12]):
        k0, b0 = pool.kernel_ms, pool.batch_ms
        pool.run(*rows_of(part))
        assert 0 < pool.kernel_ms - k0 <= pool.batch_ms - b0
    assert pool.n_batches >= 2


def test_pool_threads_keep_counts(files):
    """The Python loop's reader threads share one pool: under a short
    switch interval, 4 threads x 2 calls keep every count whole."""
    import sys
    import threading
    g = read_gfa(files["g"])
    gi = build_index(g, 15, 10)
    jobs = [j for j in bridge_jobs(g, gi.es, np.random.default_rng(45), 40,
                                   25, 256) if len(j[0]) <= 40][:1]
    assert jobs
    rows, qseq = rows_of(jobs)
    rows[:, 6] = 8          # max_ed: a few steps a call
    pool = DeviceGwfaPool(gi, device="cpu")
    want = pool.run(rows, qseq)
    pool = DeviceGwfaPool(gi, device="cpu")
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=lambda: got.extend(
            pool.run(rows, qseq) for _ in range(2))) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 8
    for res in got:
        for a, b in zip(res, want):
            assert np.array_equal(a, b)
    assert (pool.n_jobs, pool.n_batches) == (8, 8)
    assert pool.n_device + pool.n_flagged == 8


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("cigar", [False, True], ids=["gaf", "cigar"])
def test_map_files_gwfa_routes(files, cigar):
    c = ["-c"] if cigar else []
    paths = [files["g"], files["r"]]
    rc, host, _ = run(jax_cli.main, ["-t1"] + c + paths)
    assert rc == 0 and host.count("\n") >= 20
    rc, jgwfa, err = run(jax_cli.main, ["-t1", "--gwfa-device"] + c + paths)
    assert rc == 0 and jgwfa == host
    assert "device GWFA bridges" in err
    for device in (None, "cpu"):
        opt = MapOptions()
        if cigar:
            opt.flag |= MG_M_CIGAR
        out, stats = io.StringIO(), {}
        # without a front, -t 2 maps in a fork pool whose workers bridge
        # on the host (as the JAX package's do): the sink route is -t 1
        mapper.map_files(read_gfa(files["g"]), [files["r"]], IndexOptions(),
                         opt, out=out, n_threads=1 if device is None else 2,
                         device=device, gwfa_device="cpu", stats=stats)
        assert out.getvalue() == host, device
        assert stats["gwfa_device"] > 0, stats


def test_cli_gwfa_device_follows_device(files):
    """--device cpu --gwfa-device: the front's and the pool's plain
    versions; the same bytes, and the pool's stats line."""
    rc, want, _ = run(jax_cli.main, ["-t1", files["g"], files["r"]])
    rc, got, err = run(cli.main, ["-t2", "--device", "cpu", "--gwfa-device",
                                  files["g"], files["r"]])
    assert rc == 0 and got == want
    assert "device GWFA bridges" in err
