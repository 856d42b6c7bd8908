"""The collectors of the port's batched map step against the JAX
package's, on the graph, reads and tables of tests/test_torch_pipeline.py:
the bucketed tables and the padded flat tables, `spread_queries`,
`finish_anchors`, `collect_anchors_bucketed`, `collect_anchors_join`,
`collect_anchors_hash` and `collect_anchors_flat` (interpret-mode
Pallas probe on the JAX side), at roomy caps and at caps tight enough
that the qcap, bucket-run and acap overflow flags fire.  Every output:
tolerance 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigraph_tpu.ops import anchors_bucketed as jab
from minigraph_tpu.ops.anchors_hash import collect_anchors_hash as jhash
from minigraph_tpu.ops.anchors_jax import collect_anchors_join as jjoin
from minigraph_tpu.ops.anchors_jax import \
    collect_anchors_flat_pallas_traced as jflat
from minigraph_tpu_torch.ops.anchors import (collect_anchors_flat,
                                             collect_anchors_hash,
                                             collect_anchors_join)
from minigraph_tpu_torch.ops.anchors_bucketed import (
    BucketedJoinIndex, collect_anchors_bucketed, finish_anchors,
    spread_queries)
from test_torch_pipeline import MAX_OCC, OCC, make_data

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

# (qcap, qb, acap): roomy caps, then caps at which the qcap, bucket-run
# and acap overflow flags fire
CAPS = [(256, 24, 512), (64, 2, 128)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("bucketed"))


def jplanes(data):
    return [jnp.asarray(a) for a in data["sp"]]


def tplanes(data):
    return [torch.from_numpy(a.astype(np.int64)) for a in data["sp"]]


def assert_same(want, got, names):
    for name, a, b in zip(names, want, got):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy().astype(np.int64),
                                      err_msg=name)


PLANES = ("axh", "axl", "ayh", "ayl", "n_a", "overflow")


def test_tables_match_jax(data):
    jb, pb = data["jt"]["bucketed"], data["pt"]["bucketed"]
    built = BucketedJoinIndex.host_arrays(data["gi"], OCC)
    for name in ("keymat", "keyext"):
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                      built[name])
    assert (pb.b_bits, pb.kb, pb.occ_cap) == (jb.b_bits, jb.kb, OCC)
    assert pb.keymat.shape[0] == 64
    jj, pj = data["jt"]["join"], data["pt"]["join"]
    np.testing.assert_array_equal(np.asarray(jj.km_p), pj.km_p.numpy())
    np.testing.assert_array_equal(np.asarray(jj.ke_p), pj.ke_p.numpy())


@pytest.mark.parametrize("qcap,qb,acap", CAPS)
def test_bucketed_stages_match_jax(data, qcap, qb, acap):
    jb, pb = data["jt"]["bucketed"], data["pt"]["bucketed"]
    want = jab.spread_queries(*jplanes(data), 64, qcap=qcap, qb=qb)
    got = spread_queries(*tplanes(data), 64, qcap=qcap, qb=qb)
    assert_same(want, got, ("sf", "n_q", "q_overflow"))
    # finish_anchors on the JAX probe's output
    ext = jab.probe_xla(jb.keymat, jb.keyext, want[0])
    fin = jab.finish_anchors(ext, want[0], jnp.int32(MAX_OCC), OCC,
                             acap=acap, return_planes=True)
    assert_same(fin, finish_anchors(torch.from_numpy(np.array(ext)),
                                    got[0], MAX_OCC, OCC, acap=acap), PLANES)
    # the whole collect, with the port's own probe
    want = jab.collect_anchors_bucketed(
        jb.keymat, jb.keyext, *jplanes(data), jnp.int32(MAX_OCC), OCC,
        qcap=qcap, qb=qb, acap=acap, return_planes=True)
    got = collect_anchors_bucketed(pb, *tplanes(data), MAX_OCC, OCC,
                                   qcap=qcap, qb=qb, acap=acap)
    assert_same(want, got, PLANES)
    flags = np.asarray(want[-1])
    assert flags.any() if qcap == 64 else (~flags).sum() >= 6


@pytest.mark.parametrize("qcap,qb,acap", CAPS)
def test_join_hash_flat_collects_match_jax(data, qcap, qb, acap):
    jt, pt = data["jt"], data["pt"]
    args = (jnp.int32(MAX_OCC),)
    want = jjoin(jt["join"].keymat, jt["join"].keyext, *jplanes(data), *args,
                 occ_cap=OCC, qcap=qcap, acap=acap, return_planes=True)
    assert_same(want, collect_anchors_join(
        pt["join"], *tplanes(data), MAX_OCC, OCC, qcap=qcap, acap=acap),
        PLANES)
    h = jt["hash"]
    want = jhash(h.tag, h.pay, h.p_rid, h.p_sel, *jplanes(data), *args,
                 hbits=h.hbits, occ_cap=OCC, qcap=qcap, acap=acap,
                 return_planes=True)
    assert_same(want, collect_anchors_hash(
        pt["hash"], *tplanes(data), MAX_OCC, OCC, qcap=qcap, acap=acap),
        PLANES)
    # the flat probe kernel's path: the JAX side must trace x64-free
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        want = jax.jit(lambda *a: jflat(
            jt["join"], *a, occ_cap=OCC, qcap=qcap, acap=acap,
            interpret=True))(*jplanes(data), jnp.int32(MAX_OCC))
        want = [np.asarray(a) for a in want]
    finally:
        jax.config.update("jax_enable_x64", x64)
    got = collect_anchors_flat(pt["join"], *tplanes(data), MAX_OCC, OCC,
                               qcap=qcap, acap=acap)
    assert_same(want, got, PLANES)
    if qcap == 64:
        assert want[-1].any()


