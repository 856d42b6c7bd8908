"""-c through the port's file loops against the JAX package's command
line (host only, one thread) on synthetic inputs: GAF bytes, cg:Z and
ds:Z included, equal for
- -cx lr through the native file loop with a CPU device front (the
  split pinned at share 0: the native batch tail aligns the front's
  chains in its workers) and host only;
- -cx asm on the seed-only front;
- -c --vc and -c -S through the Python reader loop with the front,
  where the gap pool runs: the native anchor walk declined for every
  4th chain (the way the tests force bails), so those chains' gaps go
  to the pool (its plain versions on the CPU, at buckets cut to CPU
  size) or to the host engine;
- -c from stdin;
- -c with the native batch tail bailing on every 40th read (the
  per-read path), through both loops.
Tolerance: exact equality."""
import contextlib
import io
import sys

import pytest
import torch

from minigraph_tpu import cli as jax_cli
import minigraph_tpu_torch.align.cigar as port_cigar
import minigraph_tpu_torch.mapping.mapper as mapper
from minigraph_tpu_torch import cli
from minigraph_tpu_torch.align.cigar_device import DeviceWfaPool
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping.device_front import DeviceFront
from minigraph_tpu_torch.mapping.split import ShareSplit
from minigraph_tpu_torch.options import (MG_M_CIGAR, MG_M_VERTEX_COOR,
                                         MG_M_WRITE_LCHAIN, IndexOptions,
                                         MapOptions, opt_set)
from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                             make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

SMALL_BUCKETS = ((64, 80, 8), (192, 240, 8))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("map_cigar")
    ref = make_reference(200_000, seed=91)
    hap = write_bubble_rgfa(ref, 92, str(d / "g.gfa"), seg_len=20_000)
    reads = simulate_reads([hap, ref], 36, seed=93, mean_len=1200,
                           min_len=400, max_len=2000)
    reads.append(("empty", ""))
    write_fasta(str(d / "r.fa"), reads)
    asm = make_haplotype(ref, 94, sv_per_mb=40)
    write_fasta(str(d / "asm.fa"),
                cut_contigs(asm, 95, mean_len=6000, min_len=1000,
                            max_len=20000, long_every=10, long_len=40000))
    return {"g": str(d / "g.gfa"), "r": str(d / "r.fa"),
            "asm": str(d / "asm.fa")}


def run(main, argv, stdin=None):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        if stdin is not None:
            real, sys.stdin = sys.stdin, io.StringIO(stdin)
        try:
            rc = main(argv)
        finally:
            if stdin is not None:
                sys.stdin = real
    assert rc == 0, err.getvalue()
    return out.getvalue()


_want = {}


def jax_gaf(files, args, q="r"):
    key = (tuple(args), q)
    if key not in _want:
        _want[key] = run(jax_cli.main, ["-t1"] + args + [files["g"],
                                                         files[q]])
    return _want[key]


def _refuse(fn):
    raise OSError(f"cannot open {fn}")


def port_gaf(files, flag, preset=None, q="r", loop="native", pool=None):
    """The port's bytes with a CPU device front, the split pinned at
    share 0; loop="python": the native reader refused."""
    io_, mo = IndexOptions(), MapOptions()
    opt_set(preset, io_, mo)
    mo.flag |= flag
    gi = build_index(read_gfa(files["g"]), io_.k, io_.w, mo)
    front = DeviceFront(gi, mo, device="cpu")
    front._split_state = ShareSplit(share=0.0)
    front._wfa_pool = pool
    out, st = io.StringIO(), {}
    with pytest.MonkeyPatch.context() as mp:
        if loop == "python":
            mp.setattr(mapper, "NativeSeqReader", _refuse)
        mapper.map_reads(gi, mo, [files[q]], out, 2, front, st)
    return out.getvalue(), st, front


def _decline_every(monkeypatch, k):
    """The native anchor walk declines every k-th chain."""
    real = port_cigar._gchain_cigar_native
    n = [0]

    def stub(*args):
        n[0] += 1
        return False if n[0] % k == 0 else real(*args)
    monkeypatch.setattr(port_cigar, "_gchain_cigar_native", stub)


def _bail_every(monkeypatch, k):
    """The native batch tail bails on every k-th read of a batch."""
    real = mapper.map_batch_native

    def bailing(*args, **kw):
        res = real(*args, **kw)
        return {j: None if j % k == 0 else v for j, v in res.items()}
    monkeypatch.setattr(mapper, "map_batch_native", bailing)


def test_lr_native_loop(files):
    want = jax_gaf(files, ["-c"])
    assert want.count("cg:Z:") >= 30 and want.count("ds:Z:") >= 30
    assert "\t-\t" in want                  # minus-strand cg/ds reversed
    got, st, _ = port_gaf(files, MG_M_CIGAR)
    assert got == want
    assert st["n_arena"] >= 1 and st["n_device"] >= 25, st
    assert st["n_share_host"] == 0, st
    assert run(cli.main, ["-t2", "--device", "none", "-c", files["g"],
                          files["r"]]) == want


def test_asm_seed_only_front(files):
    want = jax_gaf(files, ["-cxasm"], "asm")
    assert want.count("cg:Z:") >= 10
    got, st, front = port_gaf(files, MG_M_CIGAR, "asm", "asm")
    assert not front.chain_enabled
    assert got == want and st["n_device"] >= 10, st


@pytest.mark.parametrize("flag,args", [(MG_M_VERTEX_COOR, ["--vc"]),
                                       (MG_M_WRITE_LCHAIN, ["-S"])],
                         ids=["vc", "lchain"])
def test_python_loop_gap_pool(files, monkeypatch, flag, args):
    want = jax_gaf(files, ["-c"] + args)
    _decline_every(monkeypatch, 4)
    pool = DeviceWfaPool(buckets=SMALL_BUCKETS, device="cpu")
    got, st, front = port_gaf(files, MG_M_CIGAR | flag, loop="python",
                              pool=pool)
    assert got == want
    assert "n_arena" not in st and st["n_device"] >= 25, st
    assert front._wfa_pool is pool
    assert pool.n_device > 0 and pool.n_host > 0, \
        (pool.n_device, pool.n_host)


def test_python_loop_default_pool(files, monkeypatch):
    """The loop makes the front's pool itself at its first use, on the
    front's device."""
    want = jax_gaf(files, ["-c", "--vc"])
    got, st, front = port_gaf(files, MG_M_CIGAR | MG_M_VERTEX_COOR,
                              loop="python")
    assert got == want
    assert front._wfa_pool.device == front.device
    assert front._wfa_pool.n_device == 0       # no chain declined


def test_stdin(files):
    want = jax_gaf(files, ["-c"])
    with open(files["r"]) as fh:
        text = fh.read()
    for dev in ("none", "cpu"):
        got = run(cli.main, ["-t2", "--device", dev, "-c", files["g"], "-"],
                  stdin=text)
        assert got == want, dev
    assert run(jax_cli.main, ["-t1", "-c", files["g"], "-"],
               stdin=text) == want


@pytest.mark.parametrize("loop", ["native", "python"])
def test_forced_bails(files, monkeypatch, loop):
    want = jax_gaf(files, ["-c"])
    _bail_every(monkeypatch, 40)
    got, st, _ = port_gaf(files, MG_M_CIGAR, loop=loop)
    assert got == want
    assert st["n_perread"] >= 1, st
