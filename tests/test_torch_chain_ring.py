"""The port's ring-buffer chain DP (minigraph_tpu_torch/ops/chain.py)
against the JAX package's: the plain PyTorch version bitwise against
ops/chain_jax.lchain_dp_tiled and the interpret-mode Pallas kernel
ops/chain_pallas.lchain_dp_pallas, on anchors with predecessor ties,
dead lanes, key changes and qpos jumps beyond max_dist_x; plus the
semantics each JAX version pins (the dq test, the smallest-index tie
break, dead anchors).  Integer outputs: tolerance 0."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigraph_tpu.ops.chain_jax import lchain_dp_tiled
from minigraph_tpu.ops.chain_pallas import lchain_dp_pallas
from minigraph_tpu_torch.ops.chain import (NEG_BIG, lchain_dp_planes,
                                           lchain_dp_tiled_ref)

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

MDX = MDY = 5000
BW = 500
PEN_GAP, PEN_SKIP = 0.1827, 0.00913
U = 0xFFFFFFFF


def synth_planes(rng, B, A):
    """Sorted anchor planes like seed hits: 1-3 keys, near-diagonal,
    exact duplicates (equal-score predecessors), a qpos jump past
    max_dist_x, n_a = 0 and n_a = A lanes."""
    planes = [np.full((B, A), U, np.int64) for _ in range(4)]
    n_a = rng.integers(1, A + 1, B).astype(np.int32)
    n_a[0], n_a[-1] = 0, A
    for b in range(B):
        n = int(n_a[b])
        if n == 0:
            continue
        nv = int(rng.integers(1, 4))
        vid = np.sort(rng.integers(0, 50, n) % nv)
        qpos = np.sort(rng.integers(0, 3000, n))
        # a jump in qpos alone: pairs across it fail dq > max_dist_x
        qpos[n // 2:] += 6000 if b % 2 else 0
        tpos = qpos + rng.integers(0, 300, nv)[vid] + rng.integers(-40, 40, n)
        if b % 3 == 1 and n > 40:               # repeat pileup
            lo = int(rng.integers(0, n // 2))
            tpos[lo: lo + 30] = tpos[lo] + rng.integers(0, 5, len(tpos[lo: lo + 30]))
        tpos = np.maximum(tpos, 1)
        span = rng.integers(15, 24, n)
        order = np.lexsort((tpos, vid))
        vid, tpos, qpos, span = vid[order], tpos[order], qpos[order], \
            span[order]
        # exact duplicates: equal sc + f from two predecessors
        dup = rng.random(n) < 0.1
        dup[0] = False
        for i in np.nonzero(dup)[0]:
            vid[i], tpos[i], qpos[i], span[i] = vid[i - 1], tpos[i - 1], \
                qpos[i - 1], span[i - 1]
        planes[0][b, :n] = vid
        planes[1][b, :n] = tpos
        planes[2][b, :n] = span | (int(rng.integers(0, 64)) << 24)
        planes[3][b, :n] = qpos
    return planes, n_a


def to_torch(planes, n_a):
    return [torch.from_numpy(p) for p in planes] + [torch.from_numpy(n_a)]


def u64(hi, lo):
    return jnp.asarray((hi.astype(np.uint64) << np.uint64(32))
                       | lo.astype(np.uint64))


def run_tiled(planes, n_a, W, T, mdx=MDX, mdy=MDY):
    f, p = jax.jit(partial(lchain_dp_tiled, window=W, tile=T))(
        u64(planes[0], planes[1]), u64(planes[2], planes[3]),
        jnp.asarray(n_a), jnp.int32(mdx), jnp.int32(mdy), jnp.int32(BW),
        jnp.float32(PEN_GAP), jnp.float32(PEN_SKIP))
    return np.asarray(f), np.asarray(p)


def run_port(planes, n_a, W, T, mdx=MDX, mdy=MDY):
    f, p = lchain_dp_tiled_ref(*to_torch(planes, n_a), mdx, mdy, BW, PEN_GAP,
                               PEN_SKIP, window=W, tile=T)
    return f.numpy(), p.numpy()


@pytest.mark.parametrize("W", [16, 32])
def test_ring_ref_matches_jax(W):
    rng = np.random.default_rng(40 + W)
    planes, n_a = synth_planes(rng, 8, 256)
    want_t = run_tiled(planes, n_a, W, 8)
    f1, p1 = lchain_dp_pallas(u64(planes[0], planes[1]),
                              u64(planes[2], planes[3]), jnp.asarray(n_a),
                              MDX, MDY, BW, PEN_GAP, PEN_SKIP, window=W,
                              tile=64, interpret=True)
    got = run_port(planes, n_a, W, 64)
    for name, a, b, c in zip(("f", "p"), want_t, (f1, p1), got):
        np.testing.assert_array_equal(a, c, err_msg=f"{name} vs tiled")
        np.testing.assert_array_equal(np.asarray(b), c,
                                      err_msg=f"{name} vs pallas")
    f, p = got
    # dead anchors and lanes
    dead = np.arange(256)[None, :] >= n_a[:, None]
    assert (f[dead] == NEG_BIG).all() and (p[dead] == -1).all()
    chained = (p >= 0).sum()
    assert chained > 200, "want chains to form"
    # a duplicate anchor ties with the one it copies: the predecessor
    # is the smaller index, so some p points two or more back
    assert ((p >= 0) & (p < np.arange(256)[None, :] - 1)).any()


def test_ring_dq_limits_not_dr():
    """max_dist_x limits dq, not dr: with max_dist_x = 300 a pair with
    dr = 320, dq = 290 chains, a pair with dq = 320 does not."""
    planes = [np.full((2, 8), U, np.int64) for _ in range(4)]
    # read 0: dr = 320, dq = 290; read 1: dr = 320, dq = 320
    for b, qp1 in ((0, 390), (1, 420)):
        planes[0][b, :2] = 3
        planes[1][b, :2] = (100, 420)
        planes[2][b, :2] = 17
        planes[3][b, :2] = (100, qp1)
    n_a = np.array([2, 2], np.int32)
    want = run_tiled(planes, n_a, 4, 8, mdx=300)
    got = run_port(planes, n_a, 4, 8, mdx=300)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    assert got[1][0, 1] == 0 and got[1][1, 1] == -1
    assert got[0][0, 1] > 17 and got[0][1, 1] == 17


def test_ring_key_change_and_window():
    """A predecessor on another key, or beyond W anchors back, is
    refused."""
    planes = [np.full((1, 8), U, np.int64) for _ in range(4)]
    planes[0][0, :4] = (0, 1, 1, 1)
    planes[1][0, :4] = (100, 150, 300, 450)
    planes[2][0, :4] = 17
    planes[3][0, :4] = (100, 150, 300, 450)
    n_a = np.array([4], np.int32)
    for W in (1, 2):
        want = run_tiled(planes, n_a, W, 8)
        got = run_port(planes, n_a, W, 8)
        np.testing.assert_array_equal(want[1], got[1])
        np.testing.assert_array_equal(want[0], got[0])
        assert got[1][0, 1] == -1          # key 0 -> key 1
        assert got[1][0, 3] == 2
    assert got[1][0, 2] == 1


def test_ring_wrapper_on_cpu_and_checks():
    rng = np.random.default_rng(5)
    planes, n_a = synth_planes(rng, 4, 64)
    t = to_torch(planes, n_a)
    f, p = lchain_dp_planes(*t, window=32, tile=32)
    want = lchain_dp_tiled_ref(*t, MDX, MDY, BW, PEN_GAP, PEN_SKIP, window=32,
                               tile=32)
    assert torch.equal(f, want[0]) and torch.equal(p, want[1])
    with pytest.raises(ValueError):
        lchain_dp_planes(*t, window=32, tile=48)    # 64 % 48
    with pytest.raises(ValueError):
        lchain_dp_planes(*t, window=0, tile=32)
