"""A CPU model of the chunked-walk chain kernel's two-pass design
(minigraph_tpu_torch/csrc/chain_chunked.cu), held bitwise on f, p and
sure against the port's plain version (ops/chain_chunked.py
lchain_dp_chunked_ref) and the TPU kernel itself
(minigraph_tpu/ops/chain_chunked_pallas.py, interpret mode).

The kernel takes the anchors of a tile in groups.  Part A of group k
runs while group k - 1 is being chained: for every anchor i of the group
it writes the valid rows of the top chunk [i - 128, i) as a bitmask,
tests the chunk's deepest row (may the walk go on?) and the overflow
row i0 - W, reduces the (sc + f, row) maximum over the top rows below
fb (the start of group k - 1, below which f is final) and stores the
scores of the rows [fb, i).  The sequential step then scores only those
rows with the f values just written, counts the skip rows of the chunk
as popcounts of (valid mask & marked mask) at step time, and walks the
deep blocks.  The per-tile prefix block maxima that bound the walk are
computed in the group the kernel computes them in: blocks 0 .. W/64 - 2
by part A of the tile's group 0, the top block [i0 - 64, i0) by part A
of its group 1.  The model runs part A of group k before the step of
group k - 1, with f of the rows not yet written set to a poison value,
and asserts that nothing it reads is poison.  Integer outputs and
flags: tolerance 0."""
import numpy as np
import pytest
import torch

from minigraph_tpu.ops.chain_chunked_pallas import lchain_dp_chunked_pallas
from minigraph_tpu_torch.ops.chain_chunked import (BLK, TOP,
                                                   lchain_dp_chunked_ref)
from minigraph_tpu_torch.ops.chain_exact import NEG_BIG, _planes, _sc_valid
from test_chain_exact_pallas import BW, MAX_SKIP, MDX, MDY, PEN_GAP, PEN_SKIP
from test_torch_chain import to_torch
from test_torch_chain_chunked import MAX_ITER, MDX_T, planes_for
from test_torch_chain_split import groups_of, wrap32

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

KERNEL_GROUP = 32           # chain_chunked.cu G
POISON = 0x5A5A5A5          # f of rows not yet written
INT_MIN = -(1 << 31)
REFUSED = (NEG_BIG, INT_MIN)    # a refused row in the (value, row) max


class Read:
    """One read's planes as numpy, and comput_sc against its rows."""

    def __init__(self, planes, b, mdx):
        axh, axl, ayh, ayl, _ = planes
        xh, xl, tp, qp, sp = _planes(axh, axl, ayh, ayl)
        self.xh, self.xl = xh[b].numpy(), xl[b].numpy()
        self.tp, self.qp, self.sp = tp[b], qp[b], sp[b]
        self.mdx = mdx

    def cand(self, i, rows):
        """Same vertex and (tpos_i - tpos_j) mod 2^32 <= mdx; rows below
        0 are never candidates."""
        r = np.maximum(rows, 0)
        dx = (self.xl[i] - self.xl[r]) & 0xFFFFFFFF
        return (rows >= 0) & (self.xh[r] == self.xh[i]) & (dx <= self.mdx)

    def score(self, i, rows):
        r = torch.from_numpy(np.maximum(rows, 0))
        sc, ok = _sc_valid(self.tp[i: i + 1], self.qp[i: i + 1], self.tp[r],
                           self.qp[r], self.sp[r], self.mdx, MDY, BW,
                           PEN_GAP, PEN_SKIP)
        return sc.numpy().astype(np.int64), ok.numpy()


def part_a(rd, i, i0, W, fb, f):
    """Part A for anchor i: reads f only below fb."""
    j = np.arange(i - TOP, i)
    cand = rd.cand(i, j)
    sc, ok = rd.score(i, j)
    valid = cand & ok
    below = j < fb
    best = max([(INT_MIN, INT_MIN)] + [
        (wrap32(sc[k] + f[j[k]]), int(j[k])) if valid[k] else REFUSED
        for k in np.nonzero(below)[0]])
    assert all(f[j[k]] != POISON for k in np.nonzero(below & valid)[0])
    vmask = sum(1 << k for k in np.nonzero(valid)[0].tolist())
    table = {int(j[k]): (bool(valid[k]), int(sc[k]))
             for k in np.nonzero(~below)[0]}
    r0 = np.array([i0 - W])
    return dict(best=best, vmask=vmask, table=table, cand_lo=bool(cand[0]),
                ovf=bool(rd.cand(i, r0)[0]))


def block_max(rd, f, rows, xf, xl):
    """max f over `rows` with x-hi xf and with xl (NEG_BIG if none); every
    row must be final."""
    rows = rows[rows >= 0]
    assert (f[rows] != POISON).all(), "block max reads an unwritten row"
    return [max([NEG_BIG] + f[rows[rd.xh[rows] == xv]].tolist())
            for xv in (xf, xl)]


def chain_read(rd, n, A, W, T, group, max_skip, events):
    f = np.full(A, POISON, np.int64)
    p = np.full(A, -1, np.int64)
    marked = 0                  # bit j: row j has a child (cnt > 0)
    unc = False
    NB, GT = W // BLK, min(group, T)
    # tile parity -> x-hi of the tile's first and last anchor and the
    # prefix block maxima, each as (value, phase it was written in)
    pm = {}
    gs = groups_of(n, T, GT)
    pre_next = None
    for k in range(len(gs) + 1):
        # phase k: part A of group k, then the step of group k - 1
        pre_b = pre_next
        if k < len(gs):
            i0, g0, gn = gs[k]
            fb = gs[k - 1][1] if k else g0
            par = (i0 // T) & 1
            if g0 == i0:
                xf, xl = int(rd.xh[i0]), int(rd.xh[i0 + T - 1])
                pm[par] = dict(x=(xf, xl), f=[None] * NB, l=[None] * NB)
                m1 = m2 = NEG_BIG
                for bk in range(NB - 1):
                    lo = i0 - W + BLK * bk
                    a, b = block_max(rd, f, np.arange(lo, lo + BLK), xf, xl)
                    m1, m2 = max(m1, a), max(m2, b)
                    pm[par]["f"][bk], pm[par]["l"][bk] = (m1, k), (m2, k)
            elif g0 == i0 + GT:
                e = pm[par]
                a, b = block_max(rd, f, np.arange(i0 - BLK, i0), *e["x"])
                e["f"][NB - 1] = (max(e["f"][NB - 2][0], a), k)
                e["l"][NB - 1] = (max(e["l"][NB - 2][0], b), k)
            pre_next = (gs[k], fb, [part_a(rd, g0 + t, i0, W, fb, f)
                                    for t in range(gn)])
        if pre_b is None:
            continue
        (i0, g0, gn), fb, pre = pre_b
        e = pm[(i0 // T) & 1]
        xf, xl = e["x"]
        for t in range(gn):
            i, a = g0 + t, pre[t]
            best = a["best"]
            for j in range(fb, i):
                valid, sc = a["table"][j]
                best = max(best, (wrap32(sc + f[j]), j) if valid else REFUSED)
            M, idx = best
            idx = -1 if idx == INT_MIN else idx
            mk = marked >> (i - TOP) if i >= TOP else marked << (TOP - i)
            vm = a["vmask"] & mk & ((1 << TOP) - 1)
            cnt_seen = vm.bit_count()
            sh = idx - (i - TOP) + 1
            cnt_above = (vm >> sh if sh > 0 else vm).bit_count()
            rows_below = W - TOP + (i - i0)
            if a["cand_lo"] and rows_below > 0:
                x_i = rd.xh[i]
                for bk in range((rows_below - 1) // BLK, -1, -1):
                    pmb = e["f"] if x_i == xf else e["l"] if x_i == xl \
                        else None
                    bound = 0x3FFFFFFF
                    if pmb is not None:
                        # written by part A of an earlier phase
                        assert pmb[bk] is not None and pmb[bk][1] < k
                        bound = pmb[bk][0]
                    if not wrap32(bound + 31) > M:
                        break
                    events["blocks"] += 1
                    if bk == NB - 1:
                        events["top_block"] += 1
                    jb = i0 - W + BLK * bk
                    j = np.arange(jb, jb + BLK)
                    cand = rd.cand(i, j) & (j < i - TOP)
                    sc, ok = rd.score(i, j)
                    valid = cand & ok
                    assert (f[j[valid]] != POISON).all()
                    mb, ib = max([(INT_MIN, INT_MIN)] + [
                        (wrap32(sc[q] + f[j[q]]), int(j[q])) if valid[q]
                        else REFUSED for q in range(BLK)])
                    ib = -1 if ib == INT_MIN else ib
                    skip = [int(j[q]) for q in np.nonzero(valid)[0]
                            if marked >> int(j[q]) & 1]
                    if mb > M:
                        events["takeover"] += 1
                        M, idx = mb, ib
                        cnt_above = cnt_seen + sum(x > ib for x in skip)
                    cnt_seen += len(skip)
                    if not cand[0]:
                        break
            sp_i = int(rd.sp[i])
            is_best = M > sp_i
            f[i] = M if is_best else sp_i
            p[i] = idx if is_best else -1
            unc = unc or (is_best and cnt_above > max_skip) or a["ovf"]
            if p[i] >= 0:
                marked |= 1 << int(p[i])
    f[n:] = 0
    return f, p, not unc


def split_chain(planes_t, mdx, W, T, group, events):
    """The model over a batch: (B, A) planes -> (f, p, sure) numpy."""
    B, A = planes_t[0].shape
    out = [chain_read(Read(planes_t, b, mdx), int(planes_t[4][b]), A, W, T,
                      group, MAX_SKIP, events) for b in range(B)]
    return (np.stack([o[0] for o in out]).astype(np.int32),
            np.stack([o[1] for o in out]).astype(np.int32),
            np.array([o[2] for o in out]))


def assert_same(want, got):
    for name, a, b in zip(("f", "p", "sure"), want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


# the shapes of test_torch_chain_chunked.py, scrambled (A = W = 128
# leaves no row below the top chunk, and the tight x-window at W = 256
# stops every walk on this data), then two 128-row tiles, whose anchors at t >= 65 walk into
# the tile's top block [i0 - 64, i0), one with walked blocks that take
# over M, and several groups a tile; `expect` names the walk events the
# case must show
@pytest.mark.parametrize("W,T,A,mdx,scramble,group,expect", [
    (128, 64, 128, MDX_T, 1.0, KERNEL_GROUP, ()),
    (128, 32, 128, MDX, 0.3, KERNEL_GROUP, ()),
    (256, 16, 256, MDX_T, 0.3, KERNEL_GROUP, ()),
    (256, 16, 256, MDX, 1.0, KERNEL_GROUP, ("blocks",)),
    (128, 16, 256, MDX, 0.3, KERNEL_GROUP, ("blocks",)),
    (128, 128, 384, MDX, 1.0, KERNEL_GROUP, ("blocks", "top_block")),
    (256, 128, 512, MDX, 0.5, KERNEL_GROUP,
     ("blocks", "top_block", "takeover")),
    (192, 64, 320, MDX, 1.0, 5, ("blocks",))])
def test_chunked_split_matches_ref_and_pallas(W, T, A, mdx, scramble, group,
                                              expect):
    planes = planes_for(8, A, W + T + A + mdx, scramble)
    pt = to_torch(planes)
    events = dict(blocks=0, top_block=0, takeover=0)
    got = split_chain(pt, mdx, W, T, group, events)
    walk = {}
    ref = lchain_dp_chunked_ref(*pt, mdx, MDY, BW, MAX_SKIP, MAX_ITER,
                                PEN_GAP, PEN_SKIP, window=W, tile=T,
                                walk=walk)
    assert_same([r.numpy() for r in ref], got)
    pal = lchain_dp_chunked_pallas(*planes, mdx, MDY, BW, MAX_SKIP,
                                   MAX_ITER, PEN_GAP, PEN_SKIP, window=W,
                                   tile=T, interpret=True)
    assert_same(pal, got)
    assert events["blocks"] == walk["blocks"]
    assert (got[1] >= 0).any() and got[2].any()
    for name in expect:
        assert events[name] > 0, (name, events)
