"""Paired reads through the port's file loops against the JAX package's
map_files, with exact equality: the sr preset on two files (the Python
reader loop, mates read in step) and on one interleaved file (the
native arena loop, mates grouped in C, without a front; the Python
loop with one), each pair orientation pe_ori (FR is sr's) flipped in
place on the arena bytes by the native loop and on the Python strings
by the Python loop, including with the native reader refused (as for
stdin), and mini-batches that end between mates."""
import io

import pytest
import torch

from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.mapping.mapper import map_files as jax_map_files
from minigraph_tpu.options import GGOptions as JaxGGOptions
from minigraph_tpu.options import IndexOptions as JaxIndexOptions
from minigraph_tpu.options import MapOptions as JaxMapOptions
from minigraph_tpu.options import opt_set as jax_opt_set
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.options import IndexOptions, MapOptions, opt_set
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_pairs,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("frag")
    ref = make_reference(200_000, seed=121)
    hap = write_bubble_rgfa(ref, 122, str(d / "g.gfa"), seg_len=20_000)
    r1, r2 = simulate_pairs(hap, 120, seed=123)
    # an unpaired record between pairs
    inter = [x for p in zip(r1, r2) for x in p]
    inter.insert(61, ("single", r1[70][1]))
    write_fasta(str(d / "r1.fa"), r1)
    write_fasta(str(d / "r2.fa"), r2)
    write_fasta(str(d / "ri.fa"), inter)
    return {k: str(d / f"{k}.fa") for k in ("r1", "r2", "ri")} \
        | {"g": str(d / "g.gfa")}


def opts(pe_ori, batch_bp, jax=False):
    o = (JaxIndexOptions(), JaxMapOptions()) if jax \
        else (IndexOptions(), MapOptions())
    if jax:
        jax_opt_set("sr", *o, JaxGGOptions())
    else:
        opt_set("sr", *o)
    o[1].pe_ori = pe_ori
    if batch_bp:
        o[1].mini_batch_size = batch_bp
    return o


def jax_gaf(files, fns, pe_ori, batch_bp=None):
    io_, mo = opts(pe_ori, batch_bp, jax=True)
    out = io.StringIO()
    jax_map_files(jax_read_gfa(files["g"]), [files[f] for f in fns], io_,
                  mo, out=out, n_threads=1)
    return out.getvalue()


def _refuse(fn):
    raise OSError(f"cannot open {fn}")


def port_gaf(files, fns, pe_ori, device, batch_bp=None, refuse=False):
    io_, mo = opts(pe_ori, batch_bp)
    out, st = io.StringIO(), {}
    with pytest.MonkeyPatch.context() as mp:
        if refuse:
            mp.setattr(mapper, "NativeSeqReader", _refuse)
        mapper.map_files(read_gfa(files["g"]), [files[f] for f in fns], io_,
                         mo, out=out, n_threads=2, device=device, stats=st)
    return out.getvalue(), st


@pytest.mark.parametrize("pe_ori", [0, 1, 2, 3])
def test_two_files_match_jax(files, pe_ori):
    want = jax_gaf(files, ["r1", "r2"], pe_ori)
    assert want.count("\n") >= 100
    for device in (None, "cpu"):
        got, st = port_gaf(files, ["r1", "r2"], pe_ori, device)
        assert got == want, device
        assert "n_arena" not in st, st          # the Python loop


@pytest.mark.parametrize("pe_ori", [0, 1, 2, 3])
def test_interleaved_native_loop_matches_jax(files, pe_ori):
    want = jax_gaf(files, ["ri"], pe_ori)
    got, st = port_gaf(files, ["ri"], pe_ori, None)
    assert got == want
    assert st["n_arena"] >= 1, st
    # the same pairs in two files give the same bytes, but for the
    # unpaired record
    two = jax_gaf(files, ["r1", "r2"], pe_ori)
    assert len(got.splitlines()) >= len(two.splitlines())


@pytest.mark.parametrize("refuse", [False, True])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_interleaved_python_loop_matches_jax(files, device, refuse):
    """FR pairs of one file through the Python loop: with a front (the
    native loop takes no front in frag mode) or with the native reader
    refused."""
    want = jax_gaf(files, ["ri"], 1)
    got, st = port_gaf(files, ["ri"], 1, device, refuse=refuse)
    assert got == want
    assert ("n_arena" in st) == (device is None and not refuse), st
    if device is not None:
        assert st["n_device"] == 0, st          # no pair is eligible


@pytest.mark.parametrize("loop", ["native", "python"])
def test_batches_end_between_mates(files, loop):
    """Mini-batches of ~4 pairs: a batch that reaches its size takes the
    mates of its last record along."""
    want = jax_gaf(files, ["ri"], 1, batch_bp=1200)
    got, st = port_gaf(files, ["ri"], 1, None, batch_bp=1200,
                       refuse=loop == "python")
    assert got == want
    if loop == "native":
        assert st["n_arena"] >= 20, st


@pytest.mark.parametrize("device", [None, "cpu"])
def test_independent_segments_match_jax(files, device):
    """INDEPEND_SEG (no command-line option sets it): each mate of a
    pair mapped on its own on the per-read path."""
    from minigraph_tpu.options import MG_M_INDEPEND_SEG as JAX_FLAG
    from minigraph_tpu_torch.options import MG_M_INDEPEND_SEG
    io_, mo = opts(1, None, jax=True)
    mo.flag |= JAX_FLAG
    want = io.StringIO()
    jax_map_files(jax_read_gfa(files["g"]), [files["r1"], files["r2"]],
                  io_, mo, out=want, n_threads=1)
    io_, mo = opts(1, None)
    mo.flag |= MG_M_INDEPEND_SEG
    out = io.StringIO()
    mapper.map_files(read_gfa(files["g"]), [files["r1"], files["r2"]], io_,
                     mo, out=out, n_threads=2, device=device)
    assert out.getvalue() == want.getvalue()
    assert want.getvalue().count("\n") >= 100
