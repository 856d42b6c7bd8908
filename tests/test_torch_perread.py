"""The port's per-read path (mapping/mapper.py map_frag and what it
calls, seqio/gaf.py write_gaf) against the JAX package's: for every
read the GAF bytes are equal on the whole native tail and on each
decomposed path that a native bail leads to, each forced on both sides
by the same stub.  Then each file loop re-maps the reads whose native
batch tail bailed on that path, with the bytes of the JAX package's
map_files and of the unforced run: the Python reader loop (the loop of
a file the native reader cannot open, e.g. stdin) and the native file
loop, each with a CPU device front (the split pinned at share 0) and
with device=None."""
import io

import pytest
import torch

import minigraph_tpu.graph.shortk as jax_shortk
import minigraph_tpu.mapping.gchain as jax_gchain
import minigraph_tpu.mapping.lchain as jax_lchain
from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.index.midx import build_index as jax_build_index
from minigraph_tpu.mapping.mapper import map_files as jax_map_files
from minigraph_tpu.mapping.mapper import map_frag as jax_map_frag
from minigraph_tpu.options import IndexOptions as JaxIndexOptions
from minigraph_tpu.options import MapOptions as JaxMapOptions
from minigraph_tpu.seqio.gaf import write_gaf as jax_write_gaf
import minigraph_tpu_torch.graph.shortk as port_shortk
import minigraph_tpu_torch.mapping.gchain as port_gchain
import minigraph_tpu_torch.mapping.lchain as port_lchain
import minigraph_tpu_torch.mapping.mapper as port_mapper
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping.device_front import DeviceFront
from minigraph_tpu_torch.mapping.split import ShareSplit
from minigraph_tpu_torch.options import (MG_M_PRINT_2ND, MG_M_SHOW_UNMAP,
                                         IndexOptions, MapOptions)
from minigraph_tpu_torch.seqio.gaf import write_gaf
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

FLAG = MG_M_PRINT_2ND | MG_M_SHOW_UNMAP


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("perread")
    ref = make_reference(200_000, seed=71)
    hap = write_bubble_rgfa(ref, 72, str(d / "g.gfa"), seg_len=10_000)
    reads = simulate_reads([hap, ref], 40, seed=73, mean_len=3000,
                           min_len=1000, max_len=8000)
    reads.append(("random", "ACGT" * 20 + "TTGCA" * 30))
    write_fasta(str(d / "r.fa"), reads)
    return str(d / "g.gfa"), str(d / "r.fa"), reads


@pytest.fixture(scope="module")
def indexes(files):
    gfa = files[0]
    opt = MapOptions(flag=FLAG)
    gi = build_index(read_gfa(gfa), 17, 11, opt)
    jopt = JaxMapOptions(flag=FLAG)
    jgi = jax_build_index(jax_read_gfa(gfa), 17, 11, jopt)
    return gi, opt, jgi, jopt


def _none(*args, **kwargs):
    return None


# which native stages return None (bail) on both sides
PATHS = {
    "whole_tail": (),
    "no_map_tail": ("map_tail_full",),
    "decomposed": ("map_tail_full", "lchain_tail_tab", "gchain_full_tab"),
    # the decomposed path with the graph-chain DP and the k-shortest
    # path search in Python too (their engines' overflow bails)
    "python_gdp": ("map_tail_full", "lchain_tail_tab", "gchain_full_tab",
                   "_gdp_core", "_shortest_k_native"),
}


def _force(monkeypatch, names):
    for port_mod, jax_mod in ((port_gchain, jax_gchain),
                              (port_lchain, jax_lchain),
                              (port_shortk, jax_shortk)):
        for n in names:
            if hasattr(port_mod, n):
                stub = (lambda *a, **k: (False, None)) \
                    if n == "_shortest_k_native" else _none
                monkeypatch.setattr(port_mod, n, stub)
                monkeypatch.setattr(jax_mod, n, stub)


@pytest.mark.parametrize("path", list(PATHS))
def test_map_frag_bytes_match_jax(files, indexes, monkeypatch, path):
    gi, opt, jgi, jopt = indexes
    _force(monkeypatch, PATHS[path])
    reads = files[2]
    n_lines = 0
    for name, seq in reads:
        ql = len(seq)
        want = jax_write_gaf(jgi.g, jax_map_frag(jgi, [ql], [seq], jopt, name,
                                                 fast_emit=True),
                             1, [ql], name, jopt.flag)
        got = write_gaf(gi.g, port_mapper.map_frag(gi, [ql], [seq], opt, name,
                                                   fast_emit=True),
                        1, [ql], name, opt.flag)
        assert got == want, (path, name)
        n_lines += got.count("\n")
    assert n_lines >= len(reads)


def _bail_some(monkeypatch):
    """map_batch_native reports a bail for every third read."""
    real = port_mapper.map_batch_native

    def bailing(*args, **kw):
        res = real(*args, **kw)
        return {k: (None if k % 3 == 0 else v) for k, v in res.items()}
    monkeypatch.setattr(port_mapper, "map_batch_native", bailing)


def _refuse(fn):
    raise OSError(f"cannot open {fn}")


def _port_gaf(files, device, stats=None, loop="batch"):
    """The port's GAF text.  loop="batch": the native reader refused, so
    the Python reader loop maps the file batch by batch.  loop="native":
    the native file loop.  map_files for device=None; for a device
    map_reads with the host/device split pinned at share 0 (every
    eligible read to the device front)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        if loop == "batch":
            mp.setattr(port_mapper, "NativeSeqReader", _refuse)
        if device is None:
            port_mapper.map_files(read_gfa(files[0]), [files[1]],
                                  IndexOptions(), MapOptions(flag=FLAG),
                                  out=out, n_threads=2, device=device,
                                  stats=stats)
            return out.getvalue()
        opt = MapOptions(flag=FLAG)
        gi = build_index(read_gfa(files[0]), 17, 11, opt)
        front = DeviceFront(gi, opt, device=device)
        front._split_state = ShareSplit(share=0.0)
        port_mapper.map_reads(gi, opt, [files[1]], out, 2, front, stats)
    return out.getvalue()


@pytest.fixture(scope="module")
def unforced(files):
    """The JAX package's map_files bytes, and the port's unforced runs."""
    want = io.StringIO()
    jax_map_files(jax_read_gfa(files[0]), [files[1]], JaxIndexOptions(),
                  JaxMapOptions(flag=FLAG), out=want, n_threads=2,
                  device=False)
    return want.getvalue(), {d: _port_gaf(files, d) for d in ("cpu", None)}


@pytest.mark.parametrize("path", ["whole_tail", "decomposed"])
@pytest.mark.parametrize("device", ["cpu", None])
def test_map_batch_bailed_reads(files, unforced, monkeypatch, device, path):
    want, plain = unforced[0], unforced[1][device]
    _bail_some(monkeypatch)
    _force(monkeypatch, PATHS[path])
    st = {}
    forced = _port_gaf(files, device, st)
    assert forced == plain == want
    assert st["n_perread"] == (len(files[2]) + 2) // 3, st
    assert "n_arena" not in st, st              # the Python loop
    if device is not None:
        assert st["n_device"] >= 15, st


@pytest.mark.parametrize("path", ["whole_tail", "decomposed"])
@pytest.mark.parametrize("device", ["cpu", None])
def test_native_loop_bailed_reads(files, unforced, monkeypatch, device,
                                  path):
    want, plain = unforced[0], unforced[1][device]
    _bail_some(monkeypatch)
    _force(monkeypatch, PATHS[path])
    st = {}
    forced = _port_gaf(files, device, st, loop="native")
    assert forced == plain == want
    assert st["n_perread"] == (len(files[2]) + 2) // 3, st
    assert st["n_arena"] >= 1, st
    if device is not None:
        assert st["n_device"] >= 15, st
        assert st["n_share_host"] == 0, st      # the pin held
