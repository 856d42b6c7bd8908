"""A CPU model of the exact chain kernel's two-pass design
(minigraph_tpu_torch/csrc/chain_exact.cu), held bitwise on f, p and
sure against the port's plain version (ops/chain_exact.py
lchain_dp_exact_win_ref) and the TPU kernel itself
(minigraph_tpu/ops/chain_exact_pallas.py, interpret mode).

The kernel takes the anchors of a tile in groups.  Part A reduces, for
every anchor of group k, the rows below group k - 1 (whose f is final
while group k - 1 is still being chained) and computes everything that
does not depend on f over the whole window [lo, i): the distance and
window counts, the overflow row, the valid rows as a bitmask, and the
scores of the rows of groups k - 1 and k.  A sequential pass then scores
only those rows with the f values just written, takes the max_ii
candidate's score from before its maxima (a max_ii replaced at the step
cannot apply), and both skip counts as popcounts of (valid mask & marked
mask), the chosen row left out of the count above max_ii.  The model
below runs part A of group k before the pass of group k - 1, with f of
the rows not yet written set to a poison value.  Integer outputs and
flags: tolerance 0."""
import numpy as np
import pytest
import torch

from minigraph_tpu.ops.chain_exact_pallas import lchain_dp_exact_pallas
from minigraph_tpu_torch.ops.chain_exact import (NEG_BIG, _planes, _sc_valid,
                                                 lchain_dp_exact_win_ref)
from test_chain_exact_pallas import (BW, MAX_SKIP, MDX, MDY, PEN_GAP,
                                     PEN_SKIP)
from test_torch_chain import to_torch
from test_torch_chain_chunked import planes_for

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

KERNEL_GROUP = 32           # chain_exact.cu G
POISON = 0x5A5A5A5          # f of rows not yet written
FLOOR = (NEG_BIG, -1)       # the kernel's (value, row) max starts here


def wrap32(x):
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def score(tp, qp, sp, i, rows, mdx):
    """comput_sc of anchor i against `rows` -> (sc, ok) numpy."""
    r = torch.from_numpy(rows)
    sc, ok = _sc_valid(tp[i: i + 1], qp[i: i + 1], tp[r], qp[r], sp[r], mdx,
                       MDY, BW, PEN_GAP, PEN_SKIP)
    return sc.numpy().astype(np.int64), ok.numpy()


def part_a(planes, i, lo, fb, f, max_iter, mdx):
    """Part A for anchor i: reads f only below fb, the start of the
    group before its own."""
    xh, xl, tp, qp, sp = planes
    j = np.arange(max(lo, 0), i)
    dx = xl[i] - xl[j]
    dist = (xh[j] == xh[i]) & (dx >= 0) & (dx <= mdx)
    win = dist & (j >= i - max_iter)
    sc, ok = score(tp, qp, sp, i, j, mdx)
    valid = win & ok
    below = j < fb
    assert (f[j[below]] != POISON).all()
    best = max([FLOOR] + [(wrap32(sc[k] + f[j[k]]), int(j[k]))
                          for k in np.nonzero(valid & below)[0]])
    fmax = max([FLOOR] + [(int(f[j[k]]), int(j[k]))
                          for k in np.nonzero(win & below)[0]])
    vmask = 0
    for jj in j[valid].tolist():
        vmask |= 1 << (jj - lo)
    # rows [max(fb, lo), i): window, valid, score and its validity
    table = {int(j[k]): (bool(win[k]), bool(valid[k]), bool(ok[k]),
                         int(sc[k])) for k in np.nonzero(~below)[0]}
    return dict(best=best, fmax=fmax, c_dist=int(dist.sum()),
                c_win=int(win.sum()), ovf=bool(dist[j == lo].any()),
                vmask=vmask, table=table)


def groups_of(n, T, group):
    """(tile start, group start, group length) in the kernel's order."""
    out = []
    for i0 in range(0, n, T):
        i1 = min(i0 + T, n)
        out += [(i0, g0, min(group, i1 - g0)) for g0 in range(i0, i1, group)]
    return out


def chain_read(planes, n, max_iter, W, T, group, max_skip, mdx):
    """One read through the kernel's phases: part A of group k runs
    before the sequential pass of group k - 1, so the f of group k - 1
    is still unwritten (poison) when part A reads the rows."""
    xh, xl, tp, qp, sp = planes
    A = len(xh)
    f = np.full(A, POISON, np.int64)
    p = np.full(A, -1, np.int64)
    marked = 0                  # bit j: row j has a child (cnt > 0)
    max_ii, f_mii, unc = -1, 0, False
    gs = groups_of(n, T, min(group, T))
    pre_next = None
    for k in range(len(gs) + 1):
        pre_b = pre_next
        if k < len(gs):         # part A of group k
            i0, g0, gn = gs[k]
            fb = gs[k - 1][1] if k else g0
            pre_next = (gs[k], fb, [part_a(planes, g0 + t, i0 - W, fb, f,
                                             max_iter, mdx)
                                    for t in range(gn)])
        if pre_b is None:
            continue
        (i0, g0, gn), fb, pre = pre_b    # pass (b) of group k - 1
        lo = i0 - W
        for t in range(gn):
            i, a = g0 + t, pre[t]
            st_dist, st_win = i - a["c_dist"], i - a["c_win"]
            stale = max_ii < 0 or max_ii < st_dist
            # the current max_ii's score, before this step's maxima; a
            # max_ii replaced at the step is a window row whose sc + f
            # the best covers, so it cannot apply
            tmp = NEG_BIG
            if not stale and max_ii >= lo:
                if max_ii >= fb:
                    _, _, ok0, sc = a["table"][max_ii]
                else:
                    sc, ok0 = score(tp, qp, sp, i, np.array([max_ii]), mdx)
                    sc, ok0 = int(sc[0]), bool(ok0[0])
                if ok0:
                    tmp = sc
            best, fmax = a["best"], a["fmax"]
            for j in range(max(fb, lo), i):
                win, valid, _, sc = a["table"][j]
                if win:
                    fmax = max(fmax, (int(f[j]), j))
                if valid:
                    best = max(best, (wrap32(sc + f[j]), j))
            M, idx = best
            sp_i = int(sp[i])
            is_best = M > sp_i
            max_f = M if is_best else sp_i
            max_j = idx if is_best else -1
            if stale:
                max_ii = fmax[1] if a["c_win"] > 0 else -1
                f_mii = fmax[0] if a["c_win"] > 0 else 0
            has_mii = max_ii >= 0
            mk = marked >> lo if lo >= 0 else marked << -lo
            vm = a["vmask"] & mk
            # the argmax row is not a skip row when it is taken
            vm_mii = vm & ~(1 << (idx - lo)) if is_best else vm

            def above(m, x):
                k = x - lo + 1
                return (m >> k if k > 0 else m).bit_count()

            cnt_above_idx = above(vm, idx)
            cnt_above_mii = above(vm_mii, max_ii)
            step_unc = (is_best and cnt_above_idx > max_skip) or a["ovf"]
            cand_ok = has_mii and tmp > NEG_BIG
            tsum = wrap32(tmp + f_mii)
            delta = cand_ok and max_f < tsum
            fire_sure = has_mii and max_ii < st_win - 1
            fire_maybe = has_mii and not fire_sure \
                and cnt_above_mii > max_skip
            apply = fire_sure and delta
            step_unc = step_unc or (fire_maybe and delta)
            f_i = tsum if apply else max_f
            p_i = max_ii if apply else max_j
            if max_ii < 0 or f_mii < f_i:
                max_ii, f_mii = i, f_i
            unc = unc or step_unc
            f[i], p[i] = f_i, p_i
            if p_i >= 0:
                marked |= 1 << p_i
    f[n:] = 0
    return f, p, not unc


def split_chain(planes_t, max_iter, W, T, group, max_skip=MAX_SKIP,
                mdx=MDX):
    """The model over a batch: (B, A) planes -> (f, p, sure) numpy."""
    axh, axl, ayh, ayl, n_a = planes_t
    xh, xl, tp, qp, sp = _planes(axh, axl, ayh, ayl)
    out = [chain_read((xh[b].numpy(), xl[b].numpy(), tp[b], qp[b], sp[b]),
                      int(n_a[b]), max_iter, W, T, group, max_skip, mdx)
           for b in range(axh.shape[0])]
    return (np.stack([o[0] for o in out]).astype(np.int32),
            np.stack([o[1] for o in out]).astype(np.int32),
            np.array([o[2] for o in out]))


def assert_same(want, got):
    for name, a, b in zip(("f", "p", "sure"), want, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("T", [8, 16])
@pytest.mark.parametrize("W", [0, 32, 64])
@pytest.mark.parametrize("clamp", [True, False])
def test_split_matches_ref_and_pallas(T, W, clamp):
    """max_iter below W + T (the clamp binds inside the window) and far
    above it; scrambled query positions break chains up."""
    max_iter = (W + T) // 2 + 1 if clamp else 5000
    planes = planes_for(8, 128, 31 * T + W + clamp, 0.3)
    pt = to_torch(planes)
    got = split_chain(pt, max_iter, W, T, KERNEL_GROUP)
    ref = lchain_dp_exact_win_ref(*pt, MDX, MDY, BW, MAX_SKIP, max_iter,
                                  PEN_GAP, PEN_SKIP, window=W, tile=T)
    assert_same([r.numpy() for r in ref], got)
    # the TPU kernel's buffer shift slices [T:W+T) and so needs W > 0
    if W:
        pal = lchain_dp_exact_pallas(*planes, MDX, MDY, BW, MAX_SKIP,
                                     max_iter, PEN_GAP, PEN_SKIP, window=W,
                                     tile=T, interpret=True)
        assert_same(pal, got)
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("W,T,group,scramble", [(64, 16, 4, 0.3),
                                                (32, 16, 5, 1.0),
                                                (64, 8, 3, 0.0)])
def test_split_groups_within_a_tile(W, T, group, scramble):
    """Several groups a tile (the kernel's G is 32; a tile of T > G is
    cut the same way)."""
    planes = planes_for(8, 256, 7 * W + group, scramble)
    pt = to_torch(planes)
    ref = lchain_dp_exact_win_ref(*pt, MDX, MDY, BW, MAX_SKIP, 5000,
                                  PEN_GAP, PEN_SKIP, window=W, tile=T)
    got = split_chain(pt, 5000, W, T, group)
    assert_same([r.numpy() for r in ref], got)
    assert got[2].any()


def test_split_flags_overflow_and_skips():
    """A narrow window over dense planes: the model flags reads (window
    overflow, skip counts) exactly where the reference does."""
    planes = planes_for(8, 256, 5, 0.3)
    pt = to_torch(planes)
    ref = lchain_dp_exact_win_ref(*pt, MDX, MDY, BW, 2, 5000, PEN_GAP,
                                  PEN_SKIP, window=32, tile=16)
    want = [r.numpy() for r in ref]
    assert not want[2].all() and want[2].any()
    assert_same(want, split_chain(pt, 5000, 32, 16, KERNEL_GROUP,
                                  max_skip=2))
