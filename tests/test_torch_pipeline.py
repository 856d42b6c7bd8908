"""The port's batched map step (minigraph_tpu_torch/ops/pipeline.py)
against the JAX package's, on a ~200 kb synthetic bubble graph with 8
reads padded to 1024 (an empty read, an exact slice, a tandem repeat)
and the JAX tables carried over with `tables_from_numpy`:
`make_map_step_v3` against the JAX `make_map_step_v3(...,
pallas_interpret=True)` for the hashed, bucketed and flat indexes, and
`make_map_step_v2` / `make_map_pipeline_v2` against theirs (the JAX v2
step runs the XLA sketch and the tiled chain).  All six outputs:
tolerance 0.  The collectors the step runs are held against theirs in
tests/test_torch_bucketed.py."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.index.midx import build_index as jax_build_index
from minigraph_tpu.ops import pipeline as jpipe
from minigraph_tpu.ops.anchors_bucketed import BucketedJoinIndex as JaxBkt
from minigraph_tpu.ops.anchors_hash import HashJoinIndex as JaxHash
from minigraph_tpu.ops.anchors_jax import JoinIndex as JaxJoin
from minigraph_tpu.ops.sketch_jax4 import sketch_planes as jax_sketch
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.ops import pipeline
from minigraph_tpu_torch.ops.anchors import tables_from_numpy
from minigraph_tpu_torch.ops.sketch import encode_batch
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa)

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

W, K, MAX_OCC, OCC = 11, 17, 50, 16


def make_data(tmp_dir) -> dict:
    """Graph, reads, JAX sketch planes and both packages' tables."""
    path = str(tmp_dir / "g.gfa")
    ref = make_reference(200_000, seed=31)
    hap = write_bubble_rgfa(ref, 32, path, seg_len=20_000)
    jgi = jax_build_index(jax_read_gfa(path), K, W)
    gi = build_index(read_gfa(path), K, W)
    reads = [s for _, s in simulate_reads([hap, ref], 8, seed=33,
                                          mean_len=700, min_len=200,
                                          max_len=1000)]
    reads[0] = ""
    reads[1] = ref[5000:6000]        # exact slice: many anchors
    reads[2] = "ACGTTGCA" * 120      # tandem repeat: ties
    codes, lens = encode_batch(reads, pad_to=1024)
    sp = jax.jit(partial(jax_sketch, w=W, k=K))(codes, lens)
    jt = {"join": JaxJoin.from_host(jgi, occ_cap=OCC),
          "hash": JaxHash.from_host(jgi, occ_cap=OCC),
          "bucketed": JaxBkt.from_host(jgi, occ_cap=OCC)}
    arrays = {"join": ("keymat", "keyext"), "bucketed": ("keymat", "keyext"),
              "hash": ("tag", "pay", "p_rid", "p_sel", "hbits")}
    pt = {kind: tables_from_numpy(
        kind, {a: np.asarray(getattr(jt[kind], a)) for a in names}, "cpu",
        occ_cap=OCC) for kind, names in arrays.items()}
    return {"gi": gi, "codes": codes, "lens": lens, "jt": jt, "pt": pt,
            "sp": [np.asarray(a) for a in sp[:6]]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("pipeline"))


OUT = ("f", "p", "best", "best_anchor", "n_anchors", "overflow")


def compare_steps(want, got):
    assert set(want) == set(got) == set(OUT)
    for k in OUT:
        assert got[k].dtype == (torch.bool if k == "overflow"
                                else torch.int32), k
        np.testing.assert_array_equal(want[k], got[k].numpy(), err_msg=k)


@pytest.mark.parametrize("kind", ["hash", "bucketed", "join"])
def test_map_step_v3_matches_jax(data, kind):
    kw = dict(w=W, k=K, acap=512, qcap=256, window=32)
    want = jpipe.make_map_step_v3(data["jt"][kind], pallas_interpret=True,
                                  **kw)(jnp.asarray(data["codes"]),
                                        jnp.asarray(data["lens"]))
    got = pipeline.make_map_step_v3(data["pt"][kind], **kw)(
        data["codes"], data["lens"])
    compare_steps({k: np.asarray(v) for k, v in want.items()}, got)
    assert int(got["n_anchors"].sum()) > 300
    assert (got["p"] >= 0).sum() > 200


def test_map_step_v2_matches_jax(data):
    """v2 runs the XLA sketch and the tiled chain (tile 8) in JAX; the
    port runs the same stages as v3."""
    kw = dict(w=W, k=K, acap=512, qcap=256, window=64)
    want = jax.jit(jpipe.make_map_step_v2(data["jt"]["join"], **kw))(
        jnp.asarray(data["codes"]), jnp.asarray(data["lens"]))
    got = pipeline.make_map_step_v2(data["pt"]["join"], **kw)(
        data["codes"], data["lens"])
    compare_steps({k: np.asarray(v) for k, v in want.items()}, got)


def test_map_pipeline_v2_matches_jax(data):
    kw = dict(w=W, k=K, acap=512, qcap=256, window=16, tile=128, bw=300)
    want = jpipe.make_map_pipeline_v2(data["jt"]["bucketed"],
                                      pallas_interpret=True, **kw)(
        jnp.asarray(data["codes"]), jnp.asarray(data["lens"]))
    got = pipeline.make_map_pipeline_v2(data["pt"]["bucketed"], **kw)(
        data["codes"], data["lens"])
    compare_steps({k: np.asarray(v) for k, v in want.items()}, got)


def test_map_step_checks(data):
    step = pipeline.make_map_step_v3(data["pt"]["hash"], w=W, k=K, acap=384)
    with pytest.raises(ValueError, match="multiple of the chain tile"):
        step(data["codes"], data["lens"])
    with pytest.raises(TypeError):
        pipeline.make_map_pipeline_v2(data["pt"]["join"], w=W, k=K,
                                      max_dist=10)
    with pytest.raises(TypeError):
        pipeline.make_map_step_v3(object(), w=W, k=K)
