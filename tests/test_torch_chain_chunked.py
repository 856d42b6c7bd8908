"""The port's chunked-walk chain DP (minigraph_tpu_torch/ops/chain_chunked.py)
against the JAX package's: the plain PyTorch version bitwise against the
TPU kernel itself (ops/chain_chunked_pallas.py in interpret mode) on f,
p and sure of every read, and against the XLA full-window chain
(ops/chain_exact.lchain_dp_exact_win) on the sure flags and on f and p
of sure reads; the JAX kernel's preconditions; and the device front
with the chunked chain switched on against the front without it, and
the file loops with the switch on against the host path, the split
pinned at share 0: the Python reader loop (the loop of a file the
native reader cannot open) and the native file loop.  Integer outputs
and flags: tolerance 0."""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigraph_tpu.ops.chain_chunked_pallas import lchain_dp_chunked_pallas
from minigraph_tpu.ops.chain_exact import lchain_dp_exact_win as jax_chain
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping.device_front import DeviceFront
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.mapping.split import ShareSplit
from minigraph_tpu_torch.ops.chain_chunked import (lchain_dp_chunked,
                                                   lchain_dp_chunked_ref)
from minigraph_tpu_torch.options import IndexOptions, MapOptions
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)
from test_chain_exact_pallas import (BW, MAX_SKIP, MDX, MDY, PEN_GAP,
                                     PEN_SKIP, synth_planes)
from test_torch_chain import to_torch

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

MAX_ITER = 5000
MDX_T = 600     # a tighter x-window: shallower walks, as the JAX test's


def run_port(planes, mdx, W, T, max_iter=MAX_ITER, walk=None):
    f, p, sure = lchain_dp_chunked_ref(
        *to_torch(planes), mdx, MDY, BW, MAX_SKIP, max_iter, PEN_GAP,
        PEN_SKIP, window=W, tile=T, walk=walk)
    return f.numpy(), p.numpy(), sure.numpy()


def planes_for(B, A, seed, scramble):
    """synth_planes; with scramble > 0 that share of each read's anchors
    trade query positions, which breaks chains up: the top chunk's best
    then stays low and the walk goes below it (on synth_planes' long
    co-linear chains the block bound stops every walk at once)."""
    rng = np.random.default_rng(seed)
    planes = synth_planes(B, A, rng, dense_frac=0.5)
    if not scramble:
        return planes
    axh, axl, ayh, ayl, n_a = (np.asarray(a).copy() for a in planes)
    for b, n in enumerate(n_a.tolist()):
        sel = rng.choice(n, int(n * scramble), replace=False)
        ayl[b, sel] = rng.permutation(ayl[b, sel])
    return tuple(jnp.asarray(a) for a in (axh, axl, ayh, ayl, n_a))


# the first three: synth_planes as they are; the last two walk deep
# blocks (scrambled), and W=128 < A lets the window overflow
@pytest.mark.parametrize("W,T,A,B,mdx,scramble", [
    (128, 64, 128, 8, MDX_T, 0), (128, 32, 128, 8, MDX, 0),
    (256, 16, 256, 8, MDX_T, 0), (256, 16, 256, 8, MDX, 1.0),
    (128, 16, 256, 8, MDX, 0.3)])
def test_chunked_ref_matches_pallas_interpret(W, T, A, B, mdx, scramble):
    planes = planes_for(B, A, W + T + mdx, scramble)
    f, p, sure = lchain_dp_chunked_pallas(
        *planes, mdx, MDY, BW, MAX_SKIP, MAX_ITER, PEN_GAP, PEN_SKIP,
        window=W, tile=T, interpret=True)
    walk = {}
    got = run_port(planes, mdx, W, T, walk=walk)
    for name, a, b in zip(("f", "p", "sure"), (f, p, sure), got):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    assert got[2].any()
    if scramble:
        assert walk["blocks"] > 0
    if A > W:
        assert not got[2].all(), "want window-overflow reads"


# the XLA chain unrolls its tile loop (compile time grows with T): T=16
@pytest.mark.parametrize("W,mdx,scramble", [(128, MDX, 0.3),
                                            (256, MDX_T, 0),
                                            (256, MDX, 1.0)])
def test_chunked_ref_matches_full_window(W, mdx, scramble):
    T = 16
    n_sure = 0
    for trial in range(2):
        planes = planes_for(8, 256, 11 + W + trial, scramble)
        axh, axl, ayh, ayl, n_a = planes
        ax = (axh.astype(jnp.uint64) << jnp.uint64(32)) \
            | axl.astype(jnp.uint64)
        ay = (ayh.astype(jnp.uint64) << jnp.uint64(32)) \
            | ayl.astype(jnp.uint64)
        f0, p0, _v, sure0 = jax_chain(
            ax, ay, n_a, jnp.int32(mdx), jnp.int32(MDY), jnp.int32(BW),
            jnp.int32(MAX_SKIP), jnp.int32(MAX_ITER), jnp.float32(PEN_GAP),
            jnp.float32(PEN_SKIP), window=W, tile=T)
        f1, p1, sure1 = run_port(planes, mdx, W, T)
        sure0 = np.asarray(sure0)
        np.testing.assert_array_equal(sure0, sure1)
        for b in np.nonzero(sure0)[0]:
            n = int(np.asarray(n_a)[b])
            np.testing.assert_array_equal(np.asarray(f0)[b, :n], f1[b, :n])
            np.testing.assert_array_equal(np.asarray(p0)[b, :n], p1[b, :n])
        n_sure += int(sure0.sum())
    assert n_sure >= 4, n_sure


@pytest.mark.parametrize("W,T,max_iter", [(128, 64, 40), (160, 32, MAX_ITER),
                                          (64, 16, MAX_ITER),
                                          (256, 256, MAX_ITER)])
def test_chunked_rejects_bad_shapes(W, T, max_iter):
    planes = to_torch(synth_planes(8, 256, np.random.default_rng(5)))
    for fn in (lchain_dp_chunked_ref, lchain_dp_chunked):
        with pytest.raises(ValueError):
            fn(*planes, MDX, MDY, BW, MAX_SKIP, max_iter, PEN_GAP, PEN_SKIP,
               window=W, tile=T)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    d = tmp_path_factory.mktemp("chunked")
    ref = make_reference(240_000, seed=71)
    hap = write_bubble_rgfa(ref, 72, str(d / "g.gfa"), seg_len=20_000)
    reads = simulate_reads([hap, ref], 40, seed=73, mean_len=1300,
                           min_len=300, max_len=2000)
    reads += simulate_reads([hap], 2, seed=74, mean_len=5000,
                            min_len=4000, max_len=6000)
    write_fasta(str(d / "r.fa"), reads)
    return str(d / "g.gfa"), str(d / "r.fa"), [s for _, s in reads]


def test_front_chunked_matches_full_window(graph, monkeypatch):
    gfa, _, reads = graph
    mo = MapOptions()
    gi = build_index(read_gfa(gfa), 17, 11, mo)
    monkeypatch.setenv("MGT_CHAIN_CHUNKED", "1")
    on = DeviceFront(gi, mo, device="cpu", buckets=((2048, 32),))
    off = DeviceFront(gi, mo, device="cpu", buckets=((2048, 32),),
                      chain_chunked=False)
    assert on.chain_chunked and not off.chain_chunked
    want = off.gather(off.submit(reads))
    got = on.gather(on.submit(reads))
    n_dev = 0
    for i, (a, b) in enumerate(zip(want, got)):
        assert (a is None) == (b is None), i
        if a is None:
            continue
        n_dev += 1
        for name in ("ax", "ay", "u", "mini_pos"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=f"read {i} {name}")
        assert (a.rep_len, a.n_mv) == (b.rep_len, b.n_mv), i
    assert (off.n_device, off.n_fallback, off.n_chain_unsure) == \
        (on.n_device, on.n_fallback, on.n_chain_unsure)
    assert n_dev >= 30
    monkeypatch.delenv("MGT_CHAIN_CHUNKED")
    assert not DeviceFront(gi, mo, device="cpu").chain_chunked


def test_map_files_chunked_matches_host(graph, monkeypatch):
    """The Python reader loop (the native reader refused) with the switch
    on and a CPU front whose split is pinned at share 0, against
    map_files on the host path."""
    gfa, fa, _ = graph

    def refuse(fn):
        raise OSError(f"cannot open {fn}")
    monkeypatch.setattr(mapper, "NativeSeqReader", refuse)
    monkeypatch.setenv("MGT_CHAIN_CHUNKED", "1")
    host = io.StringIO()
    mapper.map_files(read_gfa(gfa), [fa], IndexOptions(), MapOptions(),
                     out=host, n_threads=2, device=None)
    mo, ipt = MapOptions(), IndexOptions()
    gi = build_index(read_gfa(gfa), ipt.k, ipt.w, mo)
    front = DeviceFront(gi, mo, device="cpu")
    assert front.chain_chunked
    front._split_state = ShareSplit(share=0.0)
    buf, st = io.StringIO(), {}
    mapper.map_reads(gi, mo, [fa], buf, 2, front, st)
    assert buf.getvalue() == host.getvalue()
    assert host.getvalue().count("\n") >= 35
    assert st["n_device"] >= 35, st
    assert "n_arena" not in st, st


def test_native_loop_chunked_matches_host(graph, monkeypatch):
    """The native file loop with the switch on and a CPU front whose
    split is pinned at share 0 (every eligible read to the device)
    against map_files on the host path."""
    gfa, fa, _ = graph
    monkeypatch.setenv("MGT_CHAIN_CHUNKED", "1")
    host = io.StringIO()
    mapper.map_files(read_gfa(gfa), [fa], IndexOptions(), MapOptions(),
                     out=host, n_threads=2, device=None)
    mo, ipt = MapOptions(), IndexOptions()
    gi = build_index(read_gfa(gfa), ipt.k, ipt.w, mo)
    front = DeviceFront(gi, mo, device="cpu")
    assert front.chain_chunked
    front._split_state = ShareSplit(share=0.0)
    buf, st = io.StringIO(), {}
    mapper.map_reads(gi, mo, [fa], buf, 2, front, st)
    assert buf.getvalue() == host.getvalue()
    assert host.getvalue().count("\n") >= 35
    assert st["n_device"] >= 35, st
    assert st["n_share_host"] == 0, st      # the pin held
