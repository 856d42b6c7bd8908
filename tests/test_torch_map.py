"""GAF bytes of the port's file loops against the JAX package's: the
port with device="cpu" (seed and chain stages through the plain PyTorch
versions), the port with device=None (every read on the native host
path) and the JAX package's map_files(device=False) write the same
bytes, through the Python reader loop (the loop of a file the native
reader cannot open, e.g. stdin) and through the native file loop, each
with the host/device split pinned to send every eligible read to the
device front; so does the port's command line (the native file loop
with the split as it starts)."""
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.mapping.mapper import map_files as jax_map_files
from minigraph_tpu.options import IndexOptions as JaxIndexOptions
from minigraph_tpu.options import MapOptions as JaxMapOptions
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping.device_front import DeviceFront
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.mapping.split import ShareSplit
from minigraph_tpu_torch.options import (MG_M_SHOW_UNMAP, IndexOptions,
                                         MapOptions)
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("map")
    ref = make_reference(240_000, seed=61)
    hap = write_bubble_rgfa(ref, 62, str(d / "g.gfa"), seg_len=20_000)
    reads = simulate_reads([hap, ref], 50, seed=63, mean_len=1300,
                           min_len=200, max_len=2000)
    reads += simulate_reads([hap], 3, seed=64, mean_len=6000,
                            min_len=5000, max_len=8000)
    reads.append(("empty", ""))
    reads.append(("random", "ACGT" * 20 + "TTGCA" * 30))
    write_fasta(str(d / "r.fa"), reads)
    return str(d / "g.gfa"), str(d / "r.fa")


def _refuse(fn):
    raise OSError(f"cannot open {fn}")


def port_gaf(files, device, flag=0, loop="batch"):
    """The port's GAF text and stats.  loop="batch": the native reader
    refused, so the Python reader loop maps the file batch by batch.
    loop="native": the native file loop.  map_files for device=None; for
    a device map_reads with the host/device split pinned at share 0
    (every eligible read to the device front)."""
    gfa, fa = files
    out, st = io.StringIO(), {}
    mo = MapOptions()
    mo.flag |= flag
    with pytest.MonkeyPatch.context() as mp:
        if loop == "batch":
            mp.setattr(mapper, "NativeSeqReader", _refuse)
        if device is None:
            mapper.map_files(read_gfa(gfa), [fa], IndexOptions(), mo,
                             out=out, n_threads=2, device=device, stats=st)
            return out.getvalue(), st
        ipt = IndexOptions()
        gi = build_index(read_gfa(gfa), ipt.k, ipt.w, mo)
        front = DeviceFront(gi, mo, device=device)
        front._split_state = ShareSplit(share=0.0)
        mapper.map_reads(gi, mo, [fa], out, 2, front, st)
    return out.getvalue(), st


def jax_gaf(files, flag=0):
    gfa, fa = files
    out = io.StringIO()
    mo = JaxMapOptions()
    mo.flag |= flag
    jax_map_files(jax_read_gfa(gfa), [fa], JaxIndexOptions(), mo, out=out,
                  n_threads=2, device=False)
    return out.getvalue()


@pytest.mark.parametrize("flag", [0, MG_M_SHOW_UNMAP])
def test_gaf_bytes_match_jax(files, flag):
    want = jax_gaf(files, flag)
    host, _ = port_gaf(files, None, flag)
    dev, st = port_gaf(files, "cpu", flag)
    assert want.count("\n") >= 40
    assert host == want
    assert dev == want
    assert st["n_device"] >= 40, st
    assert set(st["stage_ms"]) == {"sketch", "collect", "chain",
                                   "backtrack", "pack"}
    assert "n_arena" not in st, st          # the Python loop, not the native
    assert st["n_share_host"] == 0, st      # the pin held


@pytest.mark.parametrize("flag", [0, MG_M_SHOW_UNMAP])
def test_native_loop_gaf_bytes_match_jax(files, flag):
    want = jax_gaf(files, flag)
    host, st_host = port_gaf(files, None, flag, loop="native")
    dev, st = port_gaf(files, "cpu", flag, loop="native")
    assert want.count("\n") >= 40
    assert host == want
    assert dev == want
    assert st_host["n_arena"] >= 1 and st["n_arena"] >= 1
    assert st["n_device"] >= 40, st
    assert st["n_share_host"] == 0, st      # the pin held
    assert set(st["stage_ms"]) == {"sketch", "collect", "chain",
                                   "backtrack", "pack"}


def test_cli_matches_host_path(files):
    gfa, fa = files
    r = subprocess.run([sys.executable, "-m", "minigraph_tpu_torch",
                        "--device", "cpu", "-t", "2", gfa, fa],
                       cwd=REPO, capture_output=True, text=True,
                       env=dict(os.environ, OMP_NUM_THREADS="1"),
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout == port_gaf(files, None)[0]


def test_unsupported_options_raise(files):
    # --write-mz is ported: spliced chains (no preset of the command line
    # sets the flag) are the one flag the port refuses
    from minigraph_tpu_torch.options import MG_M_SPLICE
    with pytest.raises(NotImplementedError):
        port_gaf(files, None, MG_M_SPLICE)


def test_write_mz_matches_jax(files):
    """--write-mz (MG_M_WRITE_MZ with MG_M_WRITE_LCHAIN) through
    map_files: the -S lines with each chain's minimizer span and position
    deltas, the JAX package's bytes.  Its output shape keeps every read in
    the Python reader loop, on the per-read path (the device front's
    chains with a front)."""
    from minigraph_tpu_torch.options import (MG_M_WRITE_LCHAIN,
                                             MG_M_WRITE_MZ)
    flag = MG_M_WRITE_MZ | MG_M_WRITE_LCHAIN
    gfa, fa = files
    out = io.StringIO()
    mo = JaxMapOptions()
    mo.flag |= flag
    jax_map_files(jax_read_gfa(gfa), [fa], JaxIndexOptions(), mo, out=out,
                  n_threads=1, device=False)
    want = out.getvalue()
    # chain lines with the span and both delta lists: 12 fields
    mz = [ln for ln in want.splitlines()
          if ln.startswith("*\t") and ln.count("\t") == 11]
    assert len(mz) >= 40
    host, st_host = port_gaf(files, None, flag, loop="native")
    dev, st = port_gaf(files, "cpu", flag, loop="native")
    assert host == want and dev == want
    assert "n_arena" not in st_host and "n_arena" not in st
    assert st["n_device"] >= 40, st


def test_debug_bit_keeps_reads_on_per_read_path(files, monkeypatch):
    """A debug bit (--no-kalloc's, which writes nothing) keeps every read
    off the native file loop, the native batch and the device front, as in
    the JAX package: the bytes stay the host run's."""
    from minigraph_tpu_torch.options import DBG, MG_DBG_NO_KALLOC
    want, _ = port_gaf(files, None, loop="native")
    assert want.count("\n") >= 40
    monkeypatch.setitem(DBG, "flag", MG_DBG_NO_KALLOC)
    calls = []
    monkeypatch.setattr(DeviceFront, "submit",
                        lambda *a, **k: calls.append("front"))
    monkeypatch.setattr(mapper, "map_batch_native",
                        lambda *a, **k: calls.append("batch"))
    for device in (None, "cpu"):
        got, st = port_gaf(files, device, loop="native")
        assert got == want
        assert "n_arena" not in st and st.get("n_device", 0) == 0, st
    assert calls == []
