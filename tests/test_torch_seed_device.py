"""The device long-query sketch and the device index of the port
(index/midx_device.py, mapping/seeds.py collect_minimizers_device, the
--seed-device route of mapping/mapper.py map_frag) against the JAX
package's, on the CPU: the port's sketch runs its plain version
(ops/sketch.py sketch_planes_ref), the JAX package its XLA sketch.

- the chunk-halo sweep against the JAX sweep and the host sketch, on the
  recipe of tests/test_device_index.py (N bases, a tandem insert, and
  "ACGT" * 1500, whose planes overflow and which goes whole to the host
  sketch), and on one contig past 32768 bp at DEV_BUCKETS (two chunks,
  two buckets) for asm's and lr's (k, w);
- collect_minimizers_device against the JAX one and the host
  collect_minimizers on the recipe of tests/test_seed_device.py (a
  256 kb make_haplotype contig);
- build_index_device's tables against the JAX one's and build_index's;
- the command line: -xasm -S --seed-device (the Python reader loop, so
  the device route) and -cxggs --seed-device (graph generation) write
  the JAX CLI's bytes with the sketch run, and plain -xasm --seed-device
  (the native file loop) never reaches it, as in the JAX package.

Tolerance: exact equality."""
import contextlib
import io

import numpy as np
import pytest
import torch

from minigraph_tpu import cli as jax_cli
from minigraph_tpu.graph.gfa import Graph as JaxGraph
from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.index.midx import build_index as jax_build_index
from minigraph_tpu.index.midx_device import (
    build_index_device as jax_build_index_device,
    sketch_segments_device as jax_sketch_segments)
from minigraph_tpu.mapping import mapper as jax_mapper
from minigraph_tpu.mapping.seeds import (
    collect_minimizers_device as jax_collect_device)
from minigraph_tpu.options import MapOptions as JaxMapOptions
from minigraph_tpu_torch import cli
from minigraph_tpu_torch.graph.gfa import Graph
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index import midx_device
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.index.midx_device import (build_index_device,
                                                   sketch_segments_device)
from minigraph_tpu_torch.index.sketch import sketch
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.mapping.seeds import (collect_minimizers,
                                               collect_minimizers_device)
from minigraph_tpu_torch.options import (GGOptions, IndexOptions,
                                         MapOptions, opt_set)
from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                             make_reference,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)


@pytest.fixture
def sketch_calls(monkeypatch):
    """Counts the sweep's sketch_planes calls (the kernel's launches on
    the card)."""
    calls = []
    real = midx_device.sketch_planes

    def counted(codes, lens, w, k):
        calls.append(tuple(codes.shape))
        return real(codes, lens, w, k)

    monkeypatch.setattr(midx_device, "sketch_planes", counted)
    return calls


def _fuzz_seqs():
    # tests/test_device_index.py's recipe
    rng = np.random.default_rng(4)
    seqs = []
    for t in range(10):
        n = int(rng.integers(500, 12000))
        s = list("".join(rng.choice(list("ACGT"), n)))
        for p in rng.integers(0, n, n // 300):
            s[p] = "N"
        if t % 3 == 0:
            u = "".join(s[:25])
            s = s[:50] + list(u * 6) + s[50:]
        seqs.append("".join(s))
    seqs.append("ACGT" * 1500)
    return seqs


def test_sketch_segments_matches_jax(monkeypatch, sketch_calls):
    seqs = _fuzz_seqs()
    host = []
    real_host = midx_device.host_sketch
    monkeypatch.setattr(midx_device, "host_sketch",
                        lambda s, w, k, rid: host.append(s)
                        or real_host(s, w, k, rid))
    got = sketch_segments_device(seqs, 11, 17, buckets=((4096, 8),),
                                 device="cpu")
    want = jax_sketch_segments(seqs, 11, 17, buckets=((4096, 8),))
    for s, (x, y), (jx, jy) in zip(seqs, got, want):
        hx, hy = sketch(s, 11, 17, rid=0)
        assert len(x) > 0
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
        assert np.array_equal(x, hx) and np.array_equal(y, hy)
    # the tandem sequence's planes overflow: it alone took the host
    assert host == ["ACGT" * 1500]
    assert all(shape == (8, 4096 + 29 + 12) for shape in sketch_calls)


@pytest.mark.parametrize("k,w", [(19, 10), (17, 11)])
def test_sketch_segments_two_buckets(sketch_calls, k, w):
    rng = np.random.default_rng(k)
    contig = "".join(rng.choice(list("ACGT"), 32768 + 3000))
    got = sketch_segments_device([contig], w, k, device="cpu")
    want = jax_sketch_segments([contig], w, k)
    hx, hy = sketch(contig, w, k, rid=0)
    (x, y), = got
    assert np.array_equal(x, want[0][0]) and np.array_equal(y, want[0][1])
    assert np.array_equal(x, hx) and np.array_equal(y, hy)
    # the (16, 32768 + 2w + k + 2) bucket first, then the tail's
    assert sketch_calls == [(16, 32768 + 2 * w + k + 2),
                            (128, 4096 + 2 * w + k + 2)]


def test_sketch_segments_order_as_jax(sketch_calls):
    """A 1000 bp sequence opens the 4096 bucket; a later one of 35768 bp
    has its last chunk there, so the sweep decodes that chunk before the
    first: the JAX package's record order (ROADMAP C), not the host's.
    The records themselves are the host's."""
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT"), n)) for n in (1000, 35768)]
    got = sketch_segments_device(seqs, 10, 19, device="cpu")
    want = jax_sketch_segments(seqs, 10, 19)
    for (x, y), (jx, jy) in zip(got, want):
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
    hx, hy = sketch(seqs[1], 10, 19, rid=0)
    x, y = got[1]
    assert not np.array_equal(y, hy)
    order = np.argsort(y, kind="stable")
    h_order = np.argsort(hy, kind="stable")
    assert np.array_equal(y[order], hy[h_order])
    assert np.array_equal(x[order], hx[h_order])


def _one_segment_graph(cls, ref):
    g = cls()
    sid = g.add_seg("s1")
    g.seg[sid].seq = ref
    g.seg[sid].len = len(ref)
    g.seg[sid].snid = g.sseq_add("chr1")
    g.seg[sid].soff = 0
    g.seg[sid].rank = 0
    g.finalize()
    return g


def test_collect_minimizers_device_matches_jax(sketch_calls):
    # tests/test_seed_device.py's recipe
    ref = make_reference(300_000, seed=9)
    contig = make_haplotype(ref, seed=10)[:262_144]
    io_, mo, go = IndexOptions(), MapOptions(), GGOptions()
    opt_set("asm", io_, mo, go)
    gi = build_index(_one_segment_graph(Graph, ref), io_.k, io_.w, mo)
    jgi = jax_build_index(_one_segment_graph(JaxGraph, ref), io_.k, io_.w)
    # lower case reaches the sweep as upper case, as in the JAX package
    qs = [contig[:1000].lower() + contig[1000:]]
    x0, y0 = collect_minimizers(gi, [len(contig)], [contig])
    x1, y1 = collect_minimizers_device(gi, [len(contig)], qs, "cpu")
    x2, y2 = jax_collect_device(jgi, [len(contig)], qs)
    assert len(x0) > 1000
    for x, y in ((x1, y1), (x2, y2)):
        assert np.array_equal(x0, x) and np.array_equal(y0, y)
    assert sketch_calls == [(16, 32768 + 2 * io_.w + io_.k + 2)]
    # two segments: rid and the position offset are rebased
    qs = [contig[:20000], contig[20000:60000]]
    ql = [len(q) for q in qs]
    x0, y0 = collect_minimizers(gi, ql, qs)
    x1, y1 = collect_minimizers_device(gi, ql, qs, "cpu")
    assert np.array_equal(x0, x1) and np.array_equal(y0, y1)


def test_build_index_device_matches_jax(tmp_path, sketch_calls):
    ref = make_reference(120_000, seed=21)
    path = str(tmp_path / "g.gfa")
    write_bubble_rgfa(ref, 22, path, seg_len=8000)
    io_, mo, _ = IndexOptions(), MapOptions(), GGOptions()
    mo_h, jmo = MapOptions(), JaxMapOptions()
    g = read_gfa(path)
    for s in g.seg[::3]:          # the build uppercases in place
        s.seq = s.seq.lower()
    gi = build_index_device(g, io_.k, io_.w, mo, device="cpu")
    gh = build_index(read_gfa(path), io_.k, io_.w, mo_h)
    gj = jax_build_index_device(jax_read_gfa(path), io_.k, io_.w, jmo)
    assert all(s.seq == s.seq.upper() for s in g.seg)
    assert len(gi.keys) > 10000
    for other in (gh, gj):
        for f in ("keys", "key_start", "key_cnt", "pos"):
            assert np.array_equal(getattr(gi, f), getattr(other, f)), f
        assert [(e.fwd, e.rc, e.len) for e in gi.es] \
            == [(e.fwd, e.rc, e.len) for e in other.es]
    assert (mo.occ_max1, mo.lc_max_occ) == (mo_h.occ_max1, mo_h.lc_max_occ) \
        == (jmo.occ_max1, jmo.lc_max_occ)
    assert len(sketch_calls) >= 2      # segments of both buckets


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("seed_device")
    ref = make_reference(200_000, seed=31)
    write_bubble_rgfa(ref, 32, str(d / "g.gfa"), seg_len=20_000)
    asm = make_haplotype(ref, 33, sv_per_mb=40)
    ctg = cut_contigs(asm, 34, mean_len=6000, min_len=2000, max_len=12000,
                      long_every=6, long_len=40000)
    write_fasta(str(d / "asm.fa"), ctg)
    return {"g": str(d / "g.gfa"), "asm": str(d / "asm.fa"),
            "n_long": sum(len(s) >= 16384 for _, s in ctg)}


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


# (options, the contigs take the device route)
CLI_CASES = {
    "asm_lchain": (["-xasm", "-S"], True),
    "ggs_cigar": (["-cxggs", "-l5k", "-d5k"], True),
    "asm_native_loop": (["-xasm"], False),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_seed_device_matches_jax(monkeypatch, files, sketch_calls,
                                     case):
    opts, routed = CLI_CASES[case]
    monkeypatch.setitem(jax_mapper.SEED_DEVICE, "on", False)
    monkeypatch.setitem(mapper.SEED_DEVICE, "on", False)
    monkeypatch.setitem(mapper.SEED_DEVICE, "device", "cuda")
    paths = [files["g"], files["asm"]]
    rc, want, err = run(jax_cli.main, ["-t1", "--seed-device"] + opts
                        + paths)
    assert rc == 0, err
    assert want.count("\n") >= 10
    # graph generation at -t 2 maps in forked workers, whose sweeps this
    # process does not count: -t 1 there
    threads = "-t1" if case.startswith("ggs") else "-t2"
    rc, got, err = run(cli.main, [threads, "--device", "cpu",
                                  "--seed-device"] + opts + paths)
    assert rc == 0, err
    assert got == want, case
    # --seed-device follows --device
    assert mapper.SEED_DEVICE == {"on": True, "min_len": 16384,
                                  "device": "cpu"}
    if routed:
        # one sweep a contig of 16384 bp or more (graph generation maps
        # each sample's contigs against each new graph)
        assert len(sketch_calls) >= files["n_long"] >= 3
    else:
        assert sketch_calls == []


def test_seed_device_route(monkeypatch, files, sketch_calls):
    """map_frag takes the sweep only for qlen_sum >= min_len without
    --heap-sort, on the explicit device, with the host path's result."""
    from minigraph_tpu_torch.seqio.bseq import read_all
    monkeypatch.setitem(mapper.SEED_DEVICE, "device", "cpu")
    io_, mo, go = IndexOptions(), MapOptions(), GGOptions()
    opt_set("asm", io_, mo, go)
    gi = build_index(read_gfa(files["g"]), io_.k, io_.w, mo)
    ctg = [r for r in read_all(files["asm"])]
    long_ = next(r for r in ctg if len(r.seq) >= 16384)
    short = next(r for r in ctg if len(r.seq) < 16384)
    want = {r.name: mapper.map_one(gi, r.seq, mo, r.name).gc
            for r in (long_, short)}
    monkeypatch.setitem(mapper.SEED_DEVICE, "on", True)
    for r, n_calls in ((short, 0), (long_, 1)):
        got = mapper.map_one(gi, r.seq, mo, r.name).gc
        assert [(c.qs, c.qe, c.ps, c.pe, c.score) for c in got] \
            == [(c.qs, c.qe, c.ps, c.pe, c.score) for c in want[r.name]]
        assert len(sketch_calls) == n_calls
    from minigraph_tpu_torch.options import MG_M_HEAP_SORT
    mo.flag |= MG_M_HEAP_SORT
    mapper.map_one(gi, long_.seq, mo, long_.name)
    assert len(sketch_calls) == 1


def test_sweep_needs_the_card(monkeypatch):
    """The sweep runs on the card unless the caller asks for the CPU: no
    quiet move to the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sketch_segments_device(["ACGT" * 100], 10, 19)
