"""The port's native file loop (mapping/mapper.py _map_file_native) with
its host/device split, on the CPU: the GAF bytes with a CPU device front
and the split pinned at share 0, left at its start of 0.35, and
collapsed with device probes equal the JAX package's host-only
map_files and the port's device=None run, over >= 8 arena batches; the
port's NativeSeqReader cuts the batches where BSeqFile.read_batch does;
the ported _probe_interval gives the JAX package's values; and a
collapsed split's probe refreshes the device cost estimate t_dev.
Inputs from tools/synth.py.  Tolerance 0."""
import io

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
from minigraph_tpu_torch.mapping.device_front import DeviceFront
from minigraph_tpu_torch.options import (MG_M_SHOW_UNMAP, IndexOptions,
                                         MapOptions)
from minigraph_tpu_torch.seqio.bseq import BSeqFile, NativeSeqReader
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

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


def front_run(files, state, batch_bp=BATCH_BP, pad_len=1024):
    """map_reads with a CPU front on one small bucket and the given
    split state; returns (GAF text, stats, split state)."""
    _, fa, gi, _ = files
    mo = opts(batch_bp)
    front = DeviceFront(gi, mo, device="cpu", buckets=((pad_len, 8),),
                        chain_window=64)
    if state is not None:
        front._split_state = state
    out, st = io.StringIO(), {}
    mapper.map_reads(gi, mo, [fa], out, 2, front, st)
    return out.getvalue(), st, front._split_state


@pytest.mark.parametrize("state", ["pinned", "start", "collapsed"])
def test_split_gaf_matches_host(files, state):
    init = {"pinned": {"share": 0.0, "t_host": None, "t_dev": None},
            "start": None,
            "collapsed": {"share": 1.0, "collapsed": True, "t_host": None,
                          "t_dev": None}}[state]
    # pinned: a bucket that takes the long read too, so the host maps no
    # eligible read, measures no cost and the share stays at 0
    got, st, split = front_run(files, init,
                               pad_len=2048 if state == "pinned" else 1024)
    assert got == files[3]
    assert st["n_arena"] >= 8, st
    n_reads = st["n_share_dev"] + st["n_share_host"]
    assert n_reads == 49 - 1, st                  # all but the empty read
    if state == "pinned":
        assert st["n_share_host"] == 0 and split["share"] == 0.0, st
        assert st["n_device"] + st["n_fallback"] + st["n_chain_unsure"] \
            == 48, st
        assert st["n_device"] >= 16, st
        assert st["n_batches"] == st["n_arena"], st
    elif state == "start":
        assert split["t_dev"] is not None and split["t_host"] is not None
        assert st["n_share_dev"] > 0 and st["n_share_host"] > 1, st
    else:
        assert st["n_probes"] >= 1 and st["collapsed"], st
        assert st["n_share_dev"] <= 8 * st["n_probes"], st


def test_collapsed_probe_refreshes_t_dev(files):
    """A collapsed split probes every 8th arena batch while it has no
    cost estimates; the first probe runs the bucket cold, so the second
    sets t_dev."""
    got, st, split = front_run(
        files, {"share": 1.0, "collapsed": True, "t_host": None,
                "t_dev": None}, batch_bp=1500)
    assert got == files[3]
    assert st["n_arena"] >= 16 and st["n_probes"] >= 2, st
    assert split["t_dev"] is not None and split["t_host"] is not None


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
    assert mapper._probe_interval(split) == jax_probe_interval(split)
