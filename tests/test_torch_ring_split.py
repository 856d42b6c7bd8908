"""A model of the ring chain kernel's split (csrc/chain_ring.cu) held
bitwise against the plain version (ops/chain.py lchain_dp_tiled_ref)
on the CPU: part A's table of comput_sc(i, j) at column j mod W (a
refused pair, a key change or j < 0 as REFUSED), then warp 0's step on
32 lanes of SPL ring slots each: a select that keeps a refused or empty
slot at NEG_BIG, a lane's best over its slots (ties to the smaller
anchor index), one max reduction for f, one min reduction over the
lanes holding the max for the predecessor, and the owner lane's slot
update.  At W = 1, 31, 32, 33, 64 and 256, with tied predecessors,
refused pairs, n_a = 0 and n_a = A.  Integer outputs: tolerance 0."""
import numpy as np
import pytest
import torch

from minigraph_tpu_torch.ops import u32
from minigraph_tpu_torch.ops.chain import NEG_BIG, lchain_dp_tiled_ref
from minigraph_tpu_torch.ops.chain_exact import _sc_valid

torch.set_num_threads(1)

ARGS = (5000, 5000, 500, 0.1827, 0.00913)   # mdx, mdy, bw, gap, skip
U = 0xFFFFFFFF
REFUSED = -0x80000000
NO_J = 0x7FFFFFFF


def planes(rng, B, A):
    """Sorted anchors of 1-3 keys near one diagonal, a qpos jump beyond
    max_dist_x, repeat pileups and exact duplicates (tied sc + f), in
    one read a run of them."""
    pl = [np.full((B, A), U, np.int64) for _ in range(4)]
    n_a = rng.integers(1, A + 1, B).astype(np.int32)
    n_a[0], n_a[-1] = 0, A
    for b in range(B):
        n = int(n_a[b])
        if n == 0:
            continue
        vid = np.sort(rng.integers(0, 3, n))
        qpos = np.sort(rng.integers(0, 3000, n))
        qpos[n // 2:] += 6000 if b % 2 else 0
        tpos = np.maximum(qpos + rng.integers(0, 300, 3)[vid]
                          + rng.integers(-40, 40, n), 1)
        if b % 3 == 1 and n > 40:
            lo = int(rng.integers(0, n // 2))
            tpos[lo: lo + 30] = tpos[lo] + rng.integers(0, 5, len(tpos[lo: lo + 30]))
        span = rng.integers(15, 24, n)
        order = np.lexsort((tpos, vid))
        vid, tpos, qpos, span = (a[order] for a in (vid, tpos, qpos, span))
        dup = rng.random(n) < 0.1
        if b % 4 == 3 and n > 100:
            # a run of 40 equal anchors: equal sc + f 32 slots apart,
            # a tie inside one lane of a W > 32 ring
            dup[n // 2 + 5: n // 2 + 45] = True
        for i in np.nonzero(dup)[0]:
            if i:
                vid[i], tpos[i], qpos[i], span[i] = \
                    vid[i - 1], tpos[i - 1], qpos[i - 1], span[i - 1]
        pl[0][b, :n], pl[1][b, :n], pl[3][b, :n] = vid, tpos, qpos
        pl[2][b, :n] = span | (int(rng.integers(0, 64)) << 24)
    return [torch.from_numpy(p) for p in pl] + [torch.from_numpy(n_a)]


def split_model(axh, axl, ayh, ayl, n_a, W):
    B, A = axh.shape
    SPL = (W + 31) // 32
    xh = axh.numpy()
    tp, qp = u32.as_i32(axl), u32.as_i32(ayl)
    sp = (ayh & 0xFF).to(torch.int32)
    f = np.full((B, A), NEG_BIG, np.int64)
    p = np.full((B, A), -1, np.int64)
    lane = np.arange(32)[:, None]
    live = lane + 32 * np.arange(SPL)[None, :] < W
    for b in range(B):
        n = int(n_a[b])
        if n == 0:
            continue
        # part A: the whole read's table (the kernel fills it a group
        # of anchors at a time, ahead of warp 0)
        i = torch.arange(n)[:, None]
        c = torch.arange(W)[None, :]
        j = i - W + c
        jc = j.clamp(min=0)
        sc, ok = _sc_valid(tp[b, i], qp[b, i], tp[b, jc], qp[b, jc],
                           sp[b, jc], *ARGS)
        ok = ok & (j >= 0) & torch.from_numpy(xh[b][jc.numpy()]
                                              == xh[b][i.numpy()])
        tab = np.full((n, 32 * SPL), REFUSED, np.int64)
        rows = np.broadcast_to(i.numpy(), (n, W))
        tab[rows, ((i + c) % W).numpy()] = \
            torch.where(ok, sc, REFUSED).numpy()
        # warp 0
        wf = np.full((32, SPL), NEG_BIG, np.int64)
        wai = np.full((32, SPL), NO_J, np.int64)
        slot = 0
        for ii in range(n):
            S = tab[ii].reshape(SPL, 32).T            # S[l, s] = slot l + 32 s
            tot = np.where(live & (S != REFUSED), S + wf, NEG_BIG)
            v = np.full(32, NEG_BIG, np.int64)
            vj = np.full(32, NO_J, np.int64)
            for s in range(SPL):
                upd = (tot[:, s] > v) | ((tot[:, s] == v) & (wai[:, s] < vj))
                v = np.where(upd, tot[:, s], v)
                vj = np.where(upd, wai[:, s], vj)
            best = v.max()
            pj = np.where(v == best, vj, NO_J).min()
            use = best > int(sp[b, ii])
            f_i = best if use else int(sp[b, ii])
            wf[slot % 32, slot // 32] = f_i
            wai[slot % 32, slot // 32] = ii
            slot = (slot + 1) % W
            f[b, ii] = f_i
            p[b, ii] = pj if use else -1
    return f, p


@pytest.mark.parametrize("W,A,B", [(1, 64, 6), (31, 128, 8), (32, 256, 8),
                                   (33, 128, 6), (64, 192, 8),
                                   (256, 320, 8)])
def test_split_matches_ref(W, A, B):
    pl = planes(np.random.default_rng(W), B, A)
    f_ref, p_ref = lchain_dp_tiled_ref(*pl, *ARGS, window=W, tile=A)
    f, p = split_model(*pl, W)
    np.testing.assert_array_equal(f, f_ref.numpy())
    np.testing.assert_array_equal(p, p_ref.numpy())
    assert (p_ref.numpy() >= 0).sum() > 10
