"""The port's v1 batched map step against the JAX package's, on the CPU:
ops/sketch_v2.py `sketch_device_v2` (JAX ops/sketch_jax2.py),
ops/pipeline.py `collect_anchors_device` and `make_map_step` (JAX
ops/pipeline.py) and ops/chain.py `lchain_dp_device` (JAX
ops/chain_jax.py; the port's plain K4, `lchain_dp_tiled_ref`).

Inputs from tools/synth.py: a 60 kb bubble graph, reads off it with N
runs, a tandem repeat, a strand-symmetric repeat and empty lanes; caps
that bind and caps that do not; k = 28, whose minimizer records
hash<<8|span reach bit 63, so the int64 bit patterns of the port are
negative there.  The chain is also held on a fuzz of anchors crowded
into a few hundred bases of two keys.  The JAX
records are uint64; the port's are int64 with the same bits.
Tolerance: exact equality."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigraph_tpu.ops import pipeline as jpipe
from minigraph_tpu.ops.chain_jax import lchain_dp_device as jax_chain
from minigraph_tpu.ops.sketch_jax2 import sketch_device_v2 as jax_sketch
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.ops import pipeline, u64
from minigraph_tpu_torch.ops.chain import lchain_dp_device
from minigraph_tpu_torch.ops.sketch import encode_batch
from minigraph_tpu_torch.ops.sketch_v2 import sketch_device_v2
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa)

torch.set_num_threads(1)

CHAIN = (5000, 5000, 500, 0.1827, 0.00913)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("v1") / "g.gfa")
    ref = make_reference(60_000, seed=71)
    hap = write_bubble_rgfa(ref, 72, path, seg_len=10_000)
    reads = [s for _, s in simulate_reads([hap], 6, seed=73, mean_len=700,
                                          min_len=300, max_len=1000)]
    reads[1] = reads[1][:200] + "N" * 40 + reads[1][240:]
    reads += ["", ref[3000:4000], "ACGTTGCA" * 120, "AT" * 300]
    codes, lens = encode_batch(reads, pad_to=1024)
    return {"path": path, "codes": codes, "lens": lens,
            "gi": {}}


def index(data, k, w):
    if (k, w) not in data["gi"]:
        data["gi"][k, w] = build_index(read_gfa(data["path"]), k, w)
    return data["gi"][k, w]


def u64_equal(want, got):
    want = np.asarray(want)
    assert want.dtype == np.uint64 and got.dtype == torch.int64
    np.testing.assert_array_equal(want, u64.to_numpy(got))


@pytest.mark.parametrize("w,k,cap", [(11, 17, 128), (11, 17, 4096),
                                     (10, 19, 64), (5, 28, 300),
                                     (3, 15, 100_000)])
def test_sketch_v2_matches_jax(data, w, k, cap):
    """Records and counts; cap 128 and 64 bind on most reads, 100_000
    exceeds the 2wL + 1 slots (the output is then that wide)."""
    codes, lens = data["codes"], data["lens"]
    rid = np.arange(len(lens), dtype=np.uint64) * np.uint64(3)
    jx, jy, jn = jax_sketch(codes, lens, w, k, cap, jnp.asarray(rid))
    tx, ty, tn = sketch_device_v2(torch.from_numpy(codes),
                                  torch.from_numpy(lens), w, k, cap,
                                  u64.from_numpy(rid, "cpu"))
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    u64_equal(jx, tx)
    u64_equal(jy, ty)
    assert tn.dtype == torch.int32
    if k == 28:     # records with bit 63 set
        assert (u64.to_numpy(tx) >> np.uint64(63)).any()
        assert ((tx < 0) & (tx != u64.U64MAX)).any()


@pytest.mark.parametrize("k,w,occ_cap,acap", [(17, 11, 16, 512),
                                              (17, 11, 4, 64),
                                              (28, 5, 16, 2048)])
def test_collect_anchors_matches_jax(data, k, w, occ_cap, acap):
    """Anchors, their sort order (stable on x, U64MAX rows last) and
    n_a; acap 64 binds; empty lanes give all-U64MAX rows."""
    gi = index(data, k, w)
    dix = pipeline.DeviceIndex.from_host(gi, "cpu")
    codes, lens = data["codes"], data["lens"]
    mx, my, n_mv = sketch_device_v2(torch.from_numpy(codes),
                                    torch.from_numpy(lens), w, k, 256)
    seg_len = np.asarray([s.len for s in gi.g.seg], np.int32)
    want = jpipe.collect_anchors_device(
        jnp.asarray(gi.keys), jnp.asarray(gi.key_start, jnp.int32),
        jnp.asarray(gi.key_cnt, jnp.int32), jnp.asarray(gi.pos),
        jnp.asarray(seg_len), jnp.asarray(u64.to_numpy(mx)),
        jnp.asarray(u64.to_numpy(my)), jnp.asarray(n_mv.numpy()),
        50, occ_cap, acap)
    got = pipeline.collect_anchors_device(
        dix.keys, dix.key_start, dix.key_cnt, dix.pos, dix.seg_len,
        mx, my, n_mv, 50, occ_cap, acap)
    u64_equal(want[0], got[0])
    u64_equal(want[1], got[1])
    np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
    n_a = got[2].numpy()
    assert n_a[6] == 0 and (got[0][6] == u64.U64MAX).all()
    assert n_a.max() > 0
    if acap == 64:
        assert (n_a == acap).sum() >= 3


def fuzz_anchors(seed, B=6, A=256):
    """Anchors crowded into 300 bases of two keys, sorted by x, U64MAX
    after the n_a live ones."""
    rng = np.random.default_rng(seed)
    ax = np.full((B, A), 0xFFFFFFFFFFFFFFFF, np.uint64)
    ay = np.full((B, A), 0xFFFFFFFFFFFFFFFF, np.uint64)
    n_a = rng.integers(0, A + 1, B).astype(np.int32)
    n_a[0] = A
    for b in range(B):
        n = int(n_a[b])
        key = rng.integers(0, 2, n).astype(np.uint64)
        tpos = rng.integers(0, 300, n).astype(np.uint64)
        x = np.sort((key << np.uint64(32)) | tpos)
        span = rng.choice([15, 17], n).astype(np.uint64)
        qpos = rng.integers(0, 300, n).astype(np.uint64)
        ax[b, :n] = x
        ay[b, :n] = (span << np.uint64(32)) | qpos
    return ax, ay, n_a


@pytest.mark.parametrize("window", [64, 32])
@pytest.mark.parametrize("src", ["collect", "fuzz"])
def test_lchain_dp_device_matches_jax(data, window, src):
    """f and p of the chain: the port's plain K4 on the u64 anchors'
    planes against the JAX scan."""
    if src == "collect":
        gi = index(data, 17, 11)
        dix = pipeline.DeviceIndex.from_host(gi, "cpu")
        mx, my, n_mv = sketch_device_v2(torch.from_numpy(data["codes"]),
                                        torch.from_numpy(data["lens"]),
                                        11, 17, 256)
        ax, ay, n_a = pipeline.collect_anchors_device(
            dix.keys, dix.key_start, dix.key_cnt, dix.pos, dix.seg_len,
            mx, my, n_mv, 50, 16, 512)
        ax_n, ay_n = u64.to_numpy(ax), u64.to_numpy(ay)
    else:
        ax_n, ay_n, n_np = fuzz_anchors(window)
        ax, ay = u64.from_numpy(ax_n, "cpu"), u64.from_numpy(ay_n, "cpu")
        n_a = torch.from_numpy(n_np)
    wf, wp = jax_chain(jnp.asarray(ax_n), jnp.asarray(ay_n),
                       jnp.asarray(n_a.numpy()), jnp.int32(5000),
                       jnp.int32(5000), jnp.int32(500),
                       jnp.float32(0.1827), jnp.float32(0.00913),
                       window=window)
    f, p = lchain_dp_device(ax, ay, n_a, *CHAIN, window=window)
    np.testing.assert_array_equal(np.asarray(wf), f.numpy())
    np.testing.assert_array_equal(np.asarray(wp), p.numpy())
    assert (p >= 0).sum() > 100
    if src == "fuzz":
        # the crowded anchors chain: many extend a predecessor
        assert (f > 17).sum() > 100


@pytest.mark.parametrize("window", [64, 32])
def test_map_step_matches_jax(data, window):
    """make_map_step end to end: f, p, best, best_anchor, n_anchors."""
    gi = index(data, 17, 11)
    jdix = jpipe.DeviceIndex(
        keys=jnp.asarray(gi.keys), key_start=jnp.asarray(gi.key_start,
                                                         jnp.int32),
        key_cnt=jnp.asarray(gi.key_cnt, jnp.int32), pos=jnp.asarray(gi.pos),
        seg_len=jnp.asarray([s.len for s in gi.g.seg], jnp.int32),
        k=gi.k, w=gi.w)
    codes, lens = data["codes"], data["lens"]
    want = jax.jit(jpipe.make_map_step(jdix, 256, 512, window=window))(
        jnp.asarray(codes), jnp.asarray(lens))
    got = pipeline.make_map_step(pipeline.DeviceIndex.from_host(gi, "cpu"),
                                 256, 512, window=window)(codes, lens)
    assert set(want) == set(got)
    for key in want:
        a = np.asarray(want[key])
        assert a.dtype == got[key].numpy().dtype, key
        np.testing.assert_array_equal(a, got[key].numpy(), err_msg=key)
    assert int(got["best"].max()) > 300
