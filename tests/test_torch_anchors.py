"""The port's seed collection (minigraph_tpu_torch/ops/anchors.py) against
the JAX package's: index tables built by both `from_host`s are equal,
`tables_from_numpy` carries the JAX tables over, and both collectors
(flat join and cuckoo hash) give bitwise-equal outputs on the same
sketch planes and tables, including the qcap/acap overflow and the
occ_cap truncation flags.  Tolerance 0."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.index.midx import build_index as jax_build_index
from minigraph_tpu.ops.anchors_hash import HashJoinIndex as JaxHash
from minigraph_tpu.ops.anchors_hash import collect_anchors_exact_hash as jhash
from minigraph_tpu.ops.anchors_jax import JoinIndex as JaxJoin
from minigraph_tpu.ops.anchors_jax import collect_anchors_exact as jflat
from minigraph_tpu.ops.sketch_jax4 import sketch_planes as jax_sketch
from minigraph_tpu.options import MapOptions as JaxMapOptions
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.ops.anchors import (HashJoinIndex, JoinIndex,
                                             collect_anchors_exact,
                                             collect_anchors_exact_hash,
                                             tables_from_numpy)
from minigraph_tpu_torch.ops.sketch import encode_batch
from minigraph_tpu_torch.options import MapOptions
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa)

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

OUT = ("axh", "axl", "ayh", "ayl", "n_a", "overflow", "q_cnt", "q_meta",
       "n_q")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("anchors") / "g.gfa")
    ref = make_reference(150_000, seed=21)
    hap = write_bubble_rgfa(ref, 22, path, seg_len=20_000)
    jmo = JaxMapOptions()
    jgi = jax_build_index(jax_read_gfa(path), 17, 11, jmo)
    mo = MapOptions()
    gi = build_index(read_gfa(path), 17, 11, mo)
    reads = [s for _, s in simulate_reads([hap, ref], 30, seed=23,
                                          mean_len=500, min_len=100,
                                          max_len=1000)]
    reads[0] = ""
    reads[1] = ref[1000:1000 + 800]
    codes, lens = encode_batch(reads, pad_to=1024)
    sp = jax.jit(partial(jax_sketch, w=11, k=17))(codes, lens)
    sp_np = [np.asarray(a) for a in sp[:6]]
    return jgi, gi, jmo, mo, sp_np


def planes_torch(sp_np):
    return [torch.from_numpy(a.astype(np.int64)) for a in sp_np]


def compare(want, got):
    for k in OUT:
        np.testing.assert_array_equal(
            np.asarray(want[k]).astype(np.int64),
            got[k].numpy().astype(np.int64), err_msg=k)


def test_index_matches_jax(data):
    jgi, gi, jmo, mo, _ = data
    for name in ("keys", "key_start", "key_cnt", "pos"):
        np.testing.assert_array_equal(getattr(jgi, name), getattr(gi, name))
    assert (jmo.occ_max1, jmo.lc_max_occ) == (mo.occ_max1, mo.lc_max_occ)


@pytest.mark.parametrize("occ_cap", [16, 3])
def test_join_tables_match_jax(data, occ_cap):
    jgi, gi, _, _, _ = data
    want = JaxJoin.from_host(jgi, occ_cap=occ_cap)
    got = JoinIndex.host_arrays(gi, occ_cap)
    np.testing.assert_array_equal(np.asarray(want.keymat), got["keymat"])
    np.testing.assert_array_equal(np.asarray(want.keyext), got["keyext"])
    ji = JoinIndex.from_host(gi, occ_cap, "cpu")
    assert ji.occ_cap == occ_cap
    np.testing.assert_array_equal(ji.keys.numpy(),
                                  np.asarray(gi.keys, dtype=np.int64))


def test_hash_tables_match_jax(data):
    jgi, gi, _, _, _ = data
    want = JaxHash.from_host(jgi, occ_cap=51)
    got = HashJoinIndex.host_arrays(gi)
    assert want.hbits == got["hbits"]
    for k in ("tag", "pay", "p_rid", "p_sel"):
        np.testing.assert_array_equal(np.asarray(getattr(want, k)), got[k],
                                      err_msg=k)


# (occ_cap, qcap, acap): roomy caps, then caps tight enough that the
# qcap/acap overflow and the occ_cap truncation flags fire
CAPS = [(16, 256, 512), (3, 64, 128)]


@pytest.mark.parametrize("occ_cap,qcap,acap", CAPS)
def test_flat_collect_matches_jax(data, occ_cap, qcap, acap):
    jgi, _, jmo, _, sp_np = data
    jji = JaxJoin.from_host(jgi, occ_cap=occ_cap)
    want = jax.jit(partial(jflat, occ_cap=occ_cap, qcap=qcap, acap=acap))(
        jji.keymat, jji.keyext, *(jnp.asarray(a) for a in sp_np),
        jnp.int32(jmo.occ_max1))
    ji = tables_from_numpy("join", {"keymat": np.asarray(jji.keymat),
                                    "keyext": np.asarray(jji.keyext)},
                           "cpu")
    got = collect_anchors_exact(ji, *planes_torch(sp_np), jmo.occ_max1,
                                occ_cap, qcap=qcap, acap=acap)
    compare(want, got)
    flags = np.asarray(want["overflow"])
    if qcap == 64:
        assert flags.any(), "want flagged reads at the tight caps"
    else:
        assert (~flags).sum() >= 5


@pytest.mark.parametrize("occ_cap,qcap,acap", CAPS)
def test_hash_collect_matches_jax(data, occ_cap, qcap, acap):
    jgi, _, jmo, _, sp_np = data
    jhi = JaxHash.from_host(jgi, occ_cap=occ_cap)
    want = jax.jit(partial(jhash, hbits=jhi.hbits, occ_cap=occ_cap,
                           qcap=qcap, acap=acap))(
        jhi.tag, jhi.pay, jhi.p_rid, jhi.p_sel,
        *(jnp.asarray(a) for a in sp_np), jnp.int32(jmo.occ_max1))
    hi = tables_from_numpy("hash", {k: np.asarray(getattr(jhi, k))
                                    for k in ("tag", "pay", "p_rid",
                                              "p_sel", "hbits")},
                           "cpu", occ_cap=occ_cap)
    got = collect_anchors_exact_hash(hi, *planes_torch(sp_np),
                                     jmo.occ_max1, occ_cap, qcap=qcap,
                                     acap=acap)
    compare(want, got)
    if qcap == 64:
        assert np.asarray(want["overflow"]).any()


def test_tables_from_numpy_rejects_unknown_kind():
    with pytest.raises(ValueError):
        tables_from_numpy("sorted", {}, "cpu")
