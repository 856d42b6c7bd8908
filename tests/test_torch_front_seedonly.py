"""The seed-only device front: with --rmq, -F or a preset that turns
the device chain off (asm), the front runs the sketch and the seed
collection only and hands each read's raw anchors to the native tail,
which chains them in mode 2 (RMQ) or mode 1 (banded DP).  Held, with
exact equality: the front's per-read anchors, rep_len, minimizer
positions and minimizer count against the JAX front's (k = 17; the JAX
package's join tables take no wider keys) and against the native host
collect (`collect_native`), read for read, a batch of long reads
included; the GAF bytes of both file loops with every eligible read on
the front against the host-only run; and the flat hand-off to the
native tail against the per-read one."""
import io

import numpy as np
import pytest
import torch

from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.index.midx import build_index as jax_build_index
from minigraph_tpu.mapping.device_front import DeviceFront as JaxFront
from minigraph_tpu.options import MapOptions as JaxMapOptions
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.mapping.device_front import DeviceFront
from minigraph_tpu_torch.mapping.seeds import collect_native
from minigraph_tpu_torch.mapping.split import ShareSplit
from minigraph_tpu_torch.options import (MG_M_RMQ, IndexOptions, MapOptions,
                                         opt_set)
from minigraph_tpu_torch.tools.synth import (make_haplotype, make_reference,
                                             simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

BUCKETS = ((2048, 32),)
# options that turn the device chain off, with the native tail's chain
# mode they take: --rmq (2), -F (1)
SEED_ONLY = {"rmq": dict(flag=MG_M_RMQ), "frag_len": dict(max_frag_len=1500)}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("seedonly")
    ref = make_reference(200_000, seed=101)
    hap = write_bubble_rgfa(ref, 102, str(d / "g.gfa"), seg_len=20_000)
    reads = simulate_reads([hap, ref], 40, seed=103, mean_len=1200,
                           min_len=300, max_len=2000)
    reads.append(("random", "ACGT" * 20 + "TTGCA" * 30))
    write_fasta(str(d / "r.fa"), reads)
    return str(d / "g.gfa"), str(d / "r.fa"), [s for _, s in reads], hap


def same_as_native(gi, mo, reads, got):
    """Every read the front delivered equals the native collect's."""
    n = 0
    for i, (seq, fr) in enumerate(zip(reads, got)):
        if fr is None:
            continue
        ax, ay, rep_len, mini_pos, n_mv = collect_native(gi, mo,
                                                         mo.occ_max1, seq)
        np.testing.assert_array_equal(fr.ax, ax, err_msg=f"read {i} ax")
        np.testing.assert_array_equal(fr.ay, ay, err_msg=f"read {i} ay")
        np.testing.assert_array_equal(
            np.asarray(fr.mini_pos, dtype=np.int64), mini_pos,
            err_msg=f"read {i} mini_pos")
        assert (fr.rep_len, fr.n_mv) == (rep_len, n_mv), i
        assert fr.u is None
        n += 1
    return n


@pytest.mark.parametrize("kind", list(SEED_ONLY))
def test_seed_only_front_matches_jax_and_native(data, kind):
    gfa, _, reads, _ = data
    mo = MapOptions(**SEED_ONLY[kind])
    jmo = JaxMapOptions(**SEED_ONLY[kind])
    gi = build_index(read_gfa(gfa), 17, 11, mo)
    jgi = jax_build_index(jax_read_gfa(gfa), 17, 11, jmo)
    pf = DeviceFront(gi, mo, device="cpu", buckets=BUCKETS)
    jf = JaxFront(jgi, jmo, buckets=BUCKETS, use_pallas=False)
    assert not pf.chain_enabled and not jf.chain_enabled
    assert pf.eligible(mo, 1, 1000)
    want = jf.gather(jf.submit(reads))
    got = pf.gather(pf.submit(reads))
    for i, (a, b) in enumerate(zip(want, got)):
        assert (a is None) == (b is None), i
        if a is None:
            continue
        for name in ("ax", "ay", "mini_pos"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, name)).astype(np.int64),
                np.asarray(getattr(b, name)).astype(np.int64),
                err_msg=f"read {i} {name}")
        assert (a.rep_len, a.n_mv) == (b.rep_len, b.n_mv), i
        assert a.u is None and b.u is None
    assert (jf.n_device, jf.n_fallback, jf.n_chain_unsure) == \
        (pf.n_device, pf.n_fallback, pf.n_chain_unsure)
    assert same_as_native(gi, mo, reads, got) >= 35
    # the stage timer has no chain or backtrack stage
    assert set(pf.timer.ms) == {"sketch", "collect", "pack"}


def test_asm_front_matches_native(data):
    """asm (k = 19, w = 10): the hash join with the wide-key check, and a
    batch of long reads that overflowed the flat planes of half the
    padded size the front once had (its anchors then came from the
    padded planes), handed on as views like every other chunk."""
    gfa, _, _, hap = data
    io_, mo = IndexOptions(), MapOptions()
    opt_set("asm", io_, mo)
    gi = build_index(read_gfa(gfa), io_.k, io_.w, mo)
    pf = DeviceFront(gi, mo, device="cpu", buckets=BUCKETS)
    assert pf.hashed and pf.ji.tag_hi is not None
    assert not pf.chain_enabled
    asm_hap = make_haplotype(hap, 104, sv_per_mb=30)
    short = [s for _, s in simulate_reads([asm_hap], 30, seed=105,
                                          mean_len=600, min_len=300,
                                          max_len=900, sub=0.001,
                                          indel=0.0001)]
    long_ = [s for _, s in simulate_reads([asm_hap], 30, seed=106,
                                          mean_len=1900, min_len=1700,
                                          max_len=2048, sub=0.001,
                                          indel=0.0001)]
    got = pf.gather(pf.submit(short))
    assert same_as_native(gi, mo, short, got) >= 25
    got = pf.gather(pf.submit(long_))
    assert same_as_native(gi, mo, long_, got) >= 20


def _refuse(fn):
    raise OSError(f"cannot open {fn}")


@pytest.mark.parametrize("loop", ["native", "python"])
@pytest.mark.parametrize("kind", list(SEED_ONLY))
def test_tail_modes_on_device_anchors(data, kind, loop):
    """Native tail modes 2 (--rmq) and 1 (-F) on the front's anchors,
    every eligible read on the front, write the host-only run's bytes:
    through the native file loop and through the Python reader loop
    (the native reader refused, as for stdin)."""
    gfa, fa, reads, _ = data
    host = io.StringIO()
    mapper.map_files(read_gfa(gfa), [fa], IndexOptions(),
                     MapOptions(**SEED_ONLY[kind]), out=host, n_threads=2,
                     device=None)
    mo = MapOptions(**SEED_ONLY[kind])
    gi = build_index(read_gfa(gfa), 17, 11, mo)
    front = DeviceFront(gi, mo, device="cpu")
    front._split_state = ShareSplit(share=0.0)
    out, st = io.StringIO(), {}
    with pytest.MonkeyPatch.context() as mp:
        if loop == "python":
            mp.setattr(mapper, "NativeSeqReader", _refuse)
        mapper.map_reads(gi, mo, [fa], out, 2, front, st)
    assert out.getvalue() == host.getvalue()
    assert host.getvalue().count("\n") >= 35
    assert st["n_device"] >= 35, st
    assert st["n_share_host"] == 0, st
    assert ("n_arena" in st) == (loop == "native")
    assert set(st["stage_ms"]) == {"sketch", "collect", "pack"}


@pytest.mark.parametrize("kind", list(SEED_ONLY))
def test_flat_blob_matches_per_read_handoff(data, kind):
    """map_batch_native on a blob of the reads: the seed-only front's
    chunks handed on as flat blobs (no U: the reads keep mode 2 for
    --rmq, mode 1 for -F) write the same GAF bytes as the same anchors
    handed on per read (items with a FrontResult), and as the workers'
    own collect."""
    from minigraph_tpu_torch.mapping.native_tail import map_batch_native
    gfa, _, reads, _ = data
    mo = MapOptions(**SEED_ONLY[kind])
    gi = build_index(read_gfa(gfa), 17, 11, mo)
    front = DeviceFront(gi, mo, device="cpu", buckets=BUCKETS)
    n = len(reads)
    seqs = np.frombuffer("".join(reads).encode(), dtype=np.uint8)
    names = np.frombuffer("".join(f"r{i}" for i in range(n)).encode(),
                          dtype=np.uint8)
    sq_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(s) for s in reads], out=sq_off[1:])
    nm_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(f"r{i}") for i in range(n)], out=nm_off[1:])

    flat = front.gather_flat(front.submit(reads))
    assert flat and all("U" not in fb for _, fb in flat)
    per_read = front.gather(front.submit(reads))
    mapped = [i for i, fr in enumerate(per_read) if fr is not None]
    assert sorted(np.concatenate([p for p, _ in flat]).tolist()) == mapped
    skip = np.setdiff1d(np.arange(n), mapped)

    def tail(**kw):
        return map_batch_native(gi, mo, None, 2,
                                blob=(n, seqs.ctypes.data, sq_off,
                                      names.ctypes.data, nm_off, skip),
                                **kw)
    got = tail(fr_flat=flat)
    want = map_batch_native(gi, mo, [(i, f"r{i}", reads[i], per_read[i])
                                     for i in mapped], 2)
    host = tail()
    assert got == want == host
    assert sum(v is not None and v.count("\t") > 10
               for v in got.values()) >= 30
