"""Base-level alignment (-c) of the port against the JAX package's on the
CPU: the host WFA entry points (align/wfa.py wfa_auto, wfa_chain,
wfa_cmp) on seeded pairs; gchain_cigar and gchain_gen_ds
(align/cigar.py) on the chains of mapped reads, through the native walk
and, with the native walk stubbed out, through the Python walk; the gap
pool (align/cigar_device.py DeviceWfaPool.run, its plain versions on
the CPU) against the JAX pool with the same small buckets, result for
result with the same n_device/n_host; and harvest_read + the pool +
finalize_read against gchain_cigar.  Tolerance: exact equality."""
import copy

import numpy as np
import pytest
import torch

import minigraph_tpu.align.cigar as jax_cigar
from minigraph_tpu.align import wfa as jax_wfa
from minigraph_tpu.align.cigar_device import DeviceWfaPool as JaxPool
from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.index.midx import build_index as jax_build_index
from minigraph_tpu.mapping.mapper import map_frag as jax_map_frag
from minigraph_tpu.options import MapOptions as JaxMapOptions
from minigraph_tpu.seqio.gaf import write_gaf as jax_write_gaf
import minigraph_tpu_torch.align.cigar as port_cigar
from minigraph_tpu_torch.align import wfa
from minigraph_tpu_torch.align.cigar_device import (CigarSink, DeviceWfaPool,
                                                    finalize_read,
                                                    harvest_read)
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping.mapper import map_frag
from minigraph_tpu_torch.options import (MG_M_CIGAR, MG_M_PRINT_2ND,
                                         MapOptions)
from minigraph_tpu_torch.seqio.gaf import write_gaf
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

# the pool's two buckets cut to CPU size: jobs of 64-192 bp on the
# "device" (the plain versions), the rest and the over-budget ones on the
# host
SMALL_BUCKETS = ((64, 80, 8), (192, 240, 8))


def _rand(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()


def _mutate(rng, seq, sub, indel):
    out = bytearray()
    for c in seq:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out += _rand(rng, int(rng.integers(1, 4)))
        out += _rand(rng, 1) if rng.random() < sub else bytes([c])
    return bytes(out)


def gap_jobs(seed, n):
    """(target, query) gaps of 1-260 bp at 1-40% divergence, a few
    indel-only and identical ones."""
    rng = np.random.default_rng(seed)
    jobs = []
    for k in range(n):
        t = _rand(rng, int(rng.integers(1, 260)))
        if k % 11 == 0:
            q = t
        else:
            q = _mutate(rng, t, float(rng.choice([0.01, 0.1, 0.4])),
                        float(rng.choice([0.0, 0.02, 0.1]))) or b"A"
        jobs.append((t, q))
    return jobs


@pytest.mark.parametrize("seed", [1, 2])
def test_wfa_entry_points_match_jax(seed):
    for t, q in gap_jobs(seed, 40):
        a, b = wfa.wfa_auto(t, q), jax_wfa.wfa_auto(t, q)
        assert (a.s, a.cigar) == (b.s, b.cigar)
        a, b = wfa.wfa_cmp(t, q), jax_wfa.wfa_cmp(t, q)
        assert (a.s, a.n_iter) == (b.s, b.n_iter)
        for step in (0, 5000):
            a = wfa.wfa_chain(wfa.WfOpt(cigar=True, step=step), t, q)
            b = jax_wfa.wfa_chain(jax_wfa.WfOpt(cigar=True, step=step), t, q)
            assert (a.s, a.cigar) == (b.s, b.cigar)


def test_wfa_chain_long_gaps_match_jax():
    """The chain heuristic on gaps of 10-14 kb: shared k-mer anchors
    with exact WFA between them, and an unrelated pair (k-mer
    similarity below 0.02: one deletion and one insertion)."""
    rng = np.random.default_rng(5)
    base = _rand(rng, 12000)
    cases = [(base, _mutate(rng, base, 0.05, 0.01)),
             (base, _rand(rng, 14000)),
             (base[:3000] + base[5000:], base)]
    for t, q in cases:
        for cig in (True, False):
            a = wfa.wfa_chain(wfa.WfOpt(cigar=cig, step=5000), t, q)
            b = jax_wfa.wfa_chain(jax_wfa.WfOpt(cigar=cig, step=5000), t, q)
            assert (a.s, a.cigar) == (b.s, b.cigar)
    assert wfa._ksim(cases[1][0], cases[1][1], 13) < 0.02


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    """Chains of reads mapped without -c on both sides (a 200 kb bubble
    graph, reads with 2% substitutions and 1% indels)."""
    d = tmp_path_factory.mktemp("cigar")
    ref = make_reference(200_000, seed=81)
    hap = write_bubble_rgfa(ref, 82, str(d / "g.gfa"), seg_len=20_000)
    reads = simulate_reads([hap, ref], 24, seed=83, mean_len=2500,
                           min_len=500, max_len=6000)
    write_fasta(str(d / "r.fa"), reads)
    opt = MapOptions(flag=MG_M_PRINT_2ND)
    gi = build_index(read_gfa(str(d / "g.gfa")), 17, 11, opt)
    jopt = JaxMapOptions(flag=MG_M_PRINT_2ND)
    jgi = jax_build_index(jax_read_gfa(str(d / "g.gfa")), 17, 11, jopt)
    out = []
    for name, seq in reads:
        gcs = map_frag(gi, [len(seq)], [seq], opt, name)
        jgcs = jax_map_frag(jgi, [len(seq)], [seq], jopt, name)
        out.append((name, seq, gcs, jgcs))
    assert sum(len(g.gc) for _, _, g, _ in out) >= 24
    return gi, jgi, out


def _p_fields(gc):
    p, ds = gc.p, gc.ds
    return (p.n_cigar, p.mlen, p.blen, p.aplen, p.ss, p.ee, list(p.cigar),
            ds.ds, ds.len, ds.n_off, [int(x) for x in ds.off])


def _stub_every(mod, monkeypatch, k):
    """mod._gchain_cigar_native declines every k-th chain (the Python
    walk, or the pool, takes it); counts shared by both packages' stubs
    through their own closures."""
    real = mod._gchain_cigar_native
    n = [0]

    def stub(*args):
        n[0] += 1
        return False if n[0] % k == 0 else real(*args)
    monkeypatch.setattr(mod, "_gchain_cigar_native", stub)


@pytest.mark.parametrize("every", [0, 1, 3])
def test_gchain_cigar_and_ds_match_jax(mapped, monkeypatch, every):
    gi, jgi, reads = mapped
    if every:
        _stub_every(port_cigar, monkeypatch, every)
        _stub_every(jax_cigar, monkeypatch, every)
    flag = MG_M_PRINT_2ND | MG_M_CIGAR
    n = 0
    for name, seq, gcs, jgcs in reads:
        gcs, jgcs = copy.deepcopy(gcs), copy.deepcopy(jgcs)
        port_cigar.gchain_cigar(gi.g, gi.es, seq, gcs, name)
        port_cigar.gchain_gen_ds(gi.g, gi.es, seq, gcs)
        jax_cigar.gchain_cigar(jgi.g, jgi.es, seq, jgcs, name)
        jax_cigar.gchain_gen_ds(jgi.g, jgi.es, seq, jgcs)
        for a, b in zip(gcs.gc, jgcs.gc):
            assert _p_fields(a) == _p_fields(b), name
            n += 1
        assert write_gaf(gi.g, gcs, 1, [len(seq)], name, flag) \
            == jax_write_gaf(jgi.g, jgcs, 1, [len(seq)], name, flag)
    assert n >= 24


def test_pool_matches_jax_pool():
    jobs = gap_jobs(3, 60)
    pool = DeviceWfaPool(buckets=SMALL_BUCKETS, device="cpu")
    jpool = JaxPool(buckets=SMALL_BUCKETS)
    got, want = pool.run(jobs), jpool.run(jobs)
    assert got == want
    assert (pool.n_device, pool.n_host) == (jpool.n_device, jpool.n_host)
    assert pool.n_device >= 20 and pool.n_host >= 20
    # every job equals the host engine's CIGAR
    for i, (t, q) in enumerate(jobs):
        assert got[i] == (wfa.wfa_auto(t, q).cigar or [])
    # the default buckets and lengths
    assert pool.run([]) == {} and DeviceWfaPool(device="cpu").buckets \
        == ((768, 1024, 64), (2048, 3072, 16))


def test_pool_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        DeviceWfaPool()


@pytest.mark.parametrize("every", [1, 2])
def test_harvest_pool_finalize_matches_gchain_cigar(mapped, monkeypatch,
                                                    every):
    """Harvested chains (the native walk declined for every `every`-th
    chain) aligned by the pool and stitched by finalize_read equal
    gchain_cigar's, on both packages."""
    from minigraph_tpu.align.cigar_device import (finalize_read as j_fin,
                                                  harvest_read as j_harv)
    gi, jgi, reads = mapped
    ref = []
    for name, seq, gcs, _ in reads:
        g = copy.deepcopy(gcs)
        port_cigar.gchain_cigar(gi.g, gi.es, seq, g, name)
        port_cigar.gchain_gen_ds(gi.g, gi.es, seq, g)
        ref.append(g)
    _stub_every(port_cigar, monkeypatch, every)
    _stub_every(jax_cigar, monkeypatch, every)
    sink, jjobs, jpend = CigarSink(), [], []
    got = [copy.deepcopy(gcs) for _, _, gcs, _ in reads]
    jgot = [copy.deepcopy(jgcs) for _, _, _, jgcs in reads]
    for (name, seq, _, _), g, jg in zip(reads, got, jgot):
        sink.pending.append(harvest_read(gi.g, gi.es, seq, g, name,
                                         sink.jobs))
        jpend.append(j_harv(jgi.g, jgi.es, seq, jg, name, jjobs))
    assert sink.jobs == jjobs and len(sink.jobs) >= 50
    pool = DeviceWfaPool(buckets=SMALL_BUCKETS, device="cpu")
    jpool = JaxPool(buckets=SMALL_BUCKETS)
    res, jres = pool.run(sink.jobs), jpool.run(jjobs)
    assert res == jres and pool.n_device == jpool.n_device > 0
    for pr, jpr in zip(sink.pending, jpend):
        finalize_read(pr, res)
        j_fin(jpr, jres)
    for g, jg, r in zip(got, jgot, ref):
        for a, b, c in zip(g.gc, jg.gc, r.gc):
            assert _p_fields(a) == _p_fields(b) == _p_fields(c)
