"""The port's join probes (minigraph_tpu_torch/ops/probe.py) against the
JAX package's: the plain bucketed probe against
ops/anchors_bucketed.probe_xla and the interpret-mode Pallas kernel
ops/probe_pallas.probe_bucketed_pallas, the plain flat probe against
probe_flat_traced (interpret mode), at nb=4, qb=8, KB=512, B=8.

Tolerance: 0 on present slots (feature 8 is 1 for a query, -1 for the
flat probe's unused slots), which match at most one key.  An empty
spread slot has all-zero features and matches every key of its bucket;
its output is the bucket's payload column sum, which here exceeds 2^24
and so depends on the order of summation: the JAX versions sum in
float32, the port exactly and rounds once.  Those slots are held to a
relative tolerance of KB * 2^-24, the bound on the error of a float32
sum of KB non-negative terms in any order.

The CUDA kernel computes D with fused multiply-adds; the guard at the
end checks, on the tables and queries that the port builds from a
graph, that this is exact: every product and partial sum is an integer
below 2^24, and the fused sum equals the separately rounded one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigraph_tpu.ops.anchors_bucketed import probe_xla
from minigraph_tpu.ops.probe_pallas import (probe_bucketed_pallas,
                                            probe_flat_traced)
from minigraph_tpu_torch.ops.probe import (NF, probe_bucketed,
                                           probe_bucketed_ref, probe_flat,
                                           probe_flat_ref)

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

NB, QB, KB, B, OCC = 4, 8, 512, 8, 4
EXT = 2 + 3 * OCC


def chunks(keys):
    return np.stack([((keys >> (9 * i)) & 0x1FF) for i in range(4)], -1) \
        .astype(np.float32)


def features(keys):
    """(n, 9) join features of 36-bit minimizers."""
    c = chunks(keys)
    cols = []
    for i in range(4):
        cols += [c[:, i] * c[:, i], c[:, i]]
    return np.stack(cols + [np.ones(len(keys), np.float32)], -1)


def tables(rng, nb, kb, n_keys):
    """Unique keys per bucket (bucket = low bits), keymat/keyext laid
    out as BucketedJoinIndex; payload integers below 2^23."""
    km = np.zeros((nb, 9, kb), np.float32)
    km[:, 8, :] = 1.0
    ke = np.zeros((nb, EXT, kb), np.float32)
    keys = []
    for v in range(nb):
        kv = np.unique(rng.integers(0, (1 << 34) // nb, 4 * n_keys) * nb + v)
        kv = rng.permutation(kv)[:n_keys]
        c = chunks(kv)
        for i in range(4):
            km[v, 2 * i, :n_keys] = 1.0
            km[v, 2 * i + 1, :n_keys] = -2.0 * c[:, i]
        km[v, 8, :n_keys] = (c ** 2).sum(1)
        ke[v, :, :n_keys] = rng.integers(0, 1 << 23, (EXT, n_keys))
        ke[v, 1, :n_keys] = 1.0
        keys.append(kv)
    return km, ke, keys


def queries(rng, keys, qb):
    """(9, B, nb*qb): per read and bucket, a few hits, a few misses,
    empty slots after them."""
    nb = len(keys)
    sq = np.zeros((9, B, nb * qb), np.float32)
    for b in range(B):
        for v in range(nb):
            n = int(rng.integers(0, qb + 1)) if b else 0
            q = np.where(rng.random(n) < 0.6, rng.choice(keys[v], n),
                         rng.integers(0, 1 << 30, n) * nb + v)
            sq[:, b, v * qb: v * qb + n] = features(q).T
    return sq


def check(want, got, present, kb):
    want = np.asarray(want)
    np.testing.assert_array_equal(want[:, present], got[:, present])
    np.testing.assert_allclose(got[:, ~present], want[:, ~present],
                               rtol=kb * 2.0 ** -24, atol=0)


@pytest.fixture(scope="module")
def bucketed():
    rng = np.random.default_rng(17)
    km, ke, keys = tables(rng, NB, KB, 400)
    sq = queries(rng, keys, QB)
    return km, ke, sq


def test_bucketed_ref_matches_jax(bucketed):
    km, ke, sq = bucketed
    got = probe_bucketed_ref(torch.from_numpy(sq), torch.from_numpy(km),
                             torch.from_numpy(ke)).numpy()
    present = sq[8] != 0
    assert 20 < present.sum() < present.size - 20
    # ext[1] counts the matching keys of a present slot: 0 or 1
    assert set(np.unique(got[1][present])) == {0.0, 1.0}
    sf = np.concatenate([sq, np.zeros((2,) + sq.shape[1:], np.float32)])
    check(probe_xla(jnp.asarray(km), jnp.asarray(ke), jnp.asarray(sf)),
          got, present, KB)
    check(probe_bucketed_pallas(jnp.asarray(sq), jnp.asarray(km),
                                jnp.asarray(ke), NB, bb=8, kc=256,
                                interpret=True), got, present, KB)
    # empty slots hold the column sums, beyond 2^24
    assert got[2][~present].min() > 2 ** 24
    wrap = probe_bucketed(torch.from_numpy(sq), torch.from_numpy(km),
                          torch.from_numpy(ke))
    assert torch.equal(wrap, torch.from_numpy(got))


def test_flat_ref_matches_jax():
    rng = np.random.default_rng(19)
    km, ke, keys = tables(rng, 1, KB, 450)
    qcap = 24
    sq = queries(rng, keys, qcap)
    # the flat probe's unused query slots carry -1 features
    sq = np.where(sq[8:9] == 0, np.float32(-1), sq)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        want = jax.jit(lambda a, b, c: probe_flat_traced(
            a, b, c, interpret=True))(jnp.asarray(sq), jnp.asarray(km),
                                      jnp.asarray(ke))
        want = np.asarray(want)
    finally:
        jax.config.update("jax_enable_x64", x64)
    got = probe_flat_ref(torch.from_numpy(sq), torch.from_numpy(km),
                         torch.from_numpy(ke))
    np.testing.assert_array_equal(want, got.numpy())
    assert (got[1].numpy() == 1).sum() > 10
    wrap = probe_flat(torch.from_numpy(sq), torch.from_numpy(km[0]),
                      torch.from_numpy(ke[0]))
    assert torch.equal(wrap, got)


def test_probe_checks_shapes(bucketed):
    km, ke, sq = bucketed
    t = [torch.from_numpy(a) for a in (sq, km, ke)]
    with pytest.raises(ValueError):
        probe_bucketed(t[0][:, :, :-1], t[1], t[2])   # SB % nb
    with pytest.raises(TypeError):
        probe_bucketed(t[0].double(), t[1], t[2])
    with pytest.raises(ValueError):
        probe_flat(t[0], t[1], t[2])                  # four buckets


@pytest.fixture(scope="module")
def graph_probes(tmp_path_factory):
    """(key matrix, queries) of the flat and the bucketed probe, as the
    port builds them on a synthetic bubble graph and reads off it."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.ops.anchors import (JoinIndex, flat_queries,
                                                 step_queries)
    from minigraph_tpu_torch.ops.anchors_bucketed import (BucketedJoinIndex,
                                                          spread_queries)
    from minigraph_tpu_torch.ops.sketch import encode_batch, sketch_planes
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa)
    path = str(tmp_path_factory.mktemp("fma") / "g.gfa")
    ref = make_reference(60_000, seed=61)
    hap = write_bubble_rgfa(ref, 62, path, seg_len=20_000)
    gi = build_index(read_gfa(path), 17, 11)
    reads = [s for _, s in simulate_reads([hap, ref], 8, seed=63,
                                          mean_len=700, min_len=200,
                                          max_len=1000)]
    codes, lens = encode_batch(reads, pad_to=1024)
    sp = sketch_planes(torch.from_numpy(codes), torch.from_numpy(lens), 11,
                       17)
    flat = JoinIndex.from_host(gi, 16, "cpu")
    bkt = BucketedJoinIndex.from_host(gi, 16, "cpu")
    qhh, qhl, _, _, qvalid = step_queries(*sp[:6], 256)
    sf, _, _ = spread_queries(*sp[:6], bkt.keymat.shape[0], qcap=256)
    return {"flat": (flat.km_p, flat_queries(qhh, qhl, qvalid)),
            "bucketed": (bkt.keymat, sf[:9])}


@pytest.mark.parametrize("kind", ["flat", "bucketed"])
def test_fused_distance_is_exact(graph_probes, kind):
    km, sq = (t.numpy() for t in graph_probes[kind])
    nb, _, KB = km.shape
    _, B, SB = sq.shape
    q = sq.reshape(NF, B, nb, SB // nb).transpose(2, 0, 1, 3) \
        .reshape(nb, NF, -1)
    assert np.array_equal(km, np.rint(km)) and np.array_equal(q, np.rint(q))
    lim = float(1 << 24)
    matches = 0
    for v in range(nb):
        for c0 in range(0, q.shape[2], 256):
            qv = q[v, :, c0: c0 + 256]                      # (9, n)
            exact = np.zeros((qv.shape[1], KB))
            fused = unfused = None
            for f in range(NF):
                prod = np.outer(qv[f].astype(np.float64), km[v, f])
                exact += prod
                assert np.abs(prod).max() < lim and np.abs(exact).max() < lim
                p32 = (qv[f][:, None] * km[v, f][None, :]).astype(np.float32)
                if f == 0:
                    fused = unfused = p32
                else:
                    # one rounding of the exact a*b + c: float64 holds it
                    fused = (prod + fused.astype(np.float64)).astype(
                        np.float32)
                    unfused = unfused + p32
            np.testing.assert_array_equal(fused, unfused)
            np.testing.assert_array_equal(fused, exact.astype(np.float32))
            matches += int((fused == 0).sum())
    assert matches > 50
