"""A numpy model of the banded gap-score kernel's layout
(csrc/wfa_banded.cu) held bitwise against the plain version
(ops/wfa_banded.py banded_score_ref) on the CPU: a block's pairs handed
to its lane groups by rank of their end anti-diagonal, G lanes a pair,
C contiguous band slots a lane, width-G shifts for the slot that
crosses lanes, t and q windows of C + 1 and C bases sliding by one base
each pair of steps (clamped loads), no cell masked outside the table
(the plain version sets those to INF), lanes frozen after their pair's
end anti-diagonal and the end slot read after the warp's last step.
Tolerance 0."""
import numpy as np
import pytest
import torch

from minigraph_tpu_torch.ops.wfa_banded import (INF, banded_score_ref,
                                                encode_pairs)

torch.set_num_threads(1)

# (G, C) of each band width, as mgt_cuda_wfa_banded picks them
LAYOUT = {32: (8, 4), 64: (8, 8), 96: (16, 6), 128: (16, 8)}
NP = 32             # pairs a block
PENS = (4, 4, 2, 15, 1)


def block_order(tl, ql):
    """The pair each lane group of a block takes: its block's NP pairs
    ranked by end anti-diagonal (ties by position), a missing pair past
    the batch's end ranked last."""
    B = len(tl)
    nblk = -(-B // NP)
    bo = np.arange(nblk * NP)
    ko = np.where(bo < B, (tl + ql)[np.minimum(bo, B - 1)], 0x7FFFFFFF)
    order = np.empty_like(bo)
    for blk in range(nblk):
        k = ko[blk * NP: (blk + 1) * NP]
        g = np.arange(NP)
        rank = ((k[None, :] < k[:, None])
                | ((k[None, :] == k[:, None]) & (g[None, :] < g[:, None]))
                ).sum(1)
        order[blk * NP + rank] = bo[blk * NP: (blk + 1) * NP]
    return order


def kernel_model(tseq, qseq, tl, ql, wa, pens=PENS):
    """Every lane's registers as (pairs, G, C) arrays; the warp is the
    whole batch (it runs to its longest pair)."""
    G, C = LAYOUT[wa]
    order = block_order(tl.numpy(), ql.numpy())
    B0 = tseq.shape[0]
    live = order < B0
    sel = torch.from_numpy(np.minimum(order, B0 - 1))
    tseq, qseq, tl, ql = tseq[sel], qseq[sel], tl[sel], ql[sel]
    x, o1, e1, o2, e2 = pens
    o1e1, o2e2 = o1 + e1, o2 + e2
    t = tseq.numpy().astype(np.int64)
    q = qseq.numpy().astype(np.int64)
    B, L = t.shape
    tl = tl.numpy().astype(np.int64)[:, None, None]
    ql = ql.numpy().astype(np.int64)[:, None, None]
    K = np.where(live[:, None, None], tl + ql, -1)
    half = G * C // 2
    gl = np.arange(G)[None, :, None]
    a0 = gl * C
    a = a0 + np.arange(C)[None, None, :]
    rows = np.arange(B)[:, None, None]

    def load(seq, idx):
        return seq[rows, np.clip(idx, 0, L - 1)]

    full = np.broadcast_to(a, (B, G, C))
    h1 = np.full(full.shape, INF, np.int64)
    e1s, f1s, e2s, f2s = (h1.copy() for _ in range(4))
    h2 = np.where(full == half, 0, INF)
    tw = load(t, a0 + np.arange(C + 1)[None, None, :] - half)
    qr = load(q, half - a)
    edge_hi = gl == G - 1
    edge_lo = gl == 0

    def shift_in(v, P):
        """The slot a lane takes from its group neighbour (width-G
        shuffle; the group's edge lane takes INF)."""
        if P == 1:
            nb = np.roll(v[:, :, 0], -1, axis=1)
            return np.where(edge_hi[:, :, 0], INF, nb)
        nb = np.roll(v[:, :, C - 1], 1, axis=1)
        return np.where(edge_lo[:, :, 0], INF, nb)

    for m in range(int(K.max()) // 2 + 1):
        nt = load(t, np.full((B, G, 1), m + 1 - half) + a0 + C)
        nq = load(q, np.full((B, G, 1), m + 1 + half) - a0)
        for P in (0, 1):
            k = 2 * m + P
            if k > K.max():
                break
            xh, x1, x2 = (shift_in(v, P) for v in (
                (h1, e1s, e2s) if P == 1 else (h1, f1s, f2s)))
            xh, x1, x2 = xh[:, :, None], x1[:, :, None], x2[:, :, None]
            if P == 1:
                he = np.concatenate([h1[:, :, 1:], xh], 2)
                ee1 = np.concatenate([e1s[:, :, 1:], x1], 2)
                ee2 = np.concatenate([e2s[:, :, 1:], x2], 2)
                hf, ff1, ff2 = h1, f1s, f2s
            else:
                he, ee1, ee2 = h1, e1s, e2s
                hf = np.concatenate([xh, h1[:, :, :-1]], 2)
                ff1 = np.concatenate([x1, f1s[:, :, :-1]], 2)
                ff2 = np.concatenate([x2, f2s[:, :, :-1]], 2)
            e1n = np.minimum(ee1 + e1, he + o1e1)
            e2n = np.minimum(ee2 + e2, he + o2e2)
            f1n = np.minimum(ff1 + e1, hf + o1e1)
            f2n = np.minimum(ff2 + e2, hf + o2e2)
            sub = np.where(tw[:, :, P: P + C] != qr, x, 0)
            hn = np.minimum(np.minimum(np.minimum(e1n, f1n), e2n),
                            np.minimum(f2n, h2 + sub))
            upd = k <= K                       # lanes frozen past K
            h2 = np.where(upd, h1, h2)
            h1 = np.where(upd, hn, h1)
            e1s = np.where(upd, e1n, e1s)
            f1s = np.where(upd, f1n, f1s)
            e2s = np.where(upd, e2n, e2s)
            f2s = np.where(upd, f2n, f2s)
        tw = np.concatenate([tw[:, :, 1:], nt], 2)
        qr = np.concatenate([nq, qr[:, :, :-1]], 2)
    a_end = (tl - ql + (2 * half - (K & 1))) >> 1
    sc = np.where(full == a_end, h1, INF).min((1, 2))
    out = np.full(B0, -7, np.int64)
    out[order[live]] = sc[live]
    assert (out != -7).all()            # every pair taken once
    return out.astype(np.int32)


def rnd(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()


def edge_pairs(rng, wa):
    """Length skews of wa - 3 .. wa either way (the end cell leaves the
    band among them), empty sequences, one length 0, diverged copies and
    unrelated pairs; an odd count, so the last warp is part full."""
    pairs = [(b"", b""), (b"", b"ACG"), (b"ACGTA", b""), (b"A", b"A"),
             (b"A", b"C")]
    for d in (wa - 3, wa - 2, wa - 1, wa):
        n = int(rng.integers(20, 120))
        pairs.append((rnd(rng, n + d), rnd(rng, n)))
        pairs.append((rnd(rng, n), rnd(rng, n + d)))
    for _ in range(8):
        t = rnd(rng, int(rng.integers(30, 300)))
        q = bytearray(t)
        for p in rng.integers(0, len(q), 6):
            q[p] = int(rng.choice(np.frombuffer(b"ACGT", np.uint8)))
        p = int(rng.integers(0, len(q) - 5))
        del q[p: p + int(rng.integers(1, 5))]
        pairs.append((t, bytes(q)))
    for _ in range(4):
        n = int(rng.integers(40, 200))
        pairs.append((rnd(rng, n), rnd(rng, n + int(rng.integers(-6, 7)))))
    if len(pairs) % 2 == 0:
        pairs.append((b"ACGT" * 30, b"ACGT"))
    return pairs


@pytest.mark.parametrize("wa", [32, 64, 96, 128])
def test_kernel_layout_matches_ref(wa):
    planes = encode_pairs(edge_pairs(np.random.default_rng(wa), wa))
    ref = banded_score_ref(*planes, wa=wa).numpy()
    got = kernel_model(*planes, wa)
    np.testing.assert_array_equal(got, ref)
    assert (ref < 1 << 28).sum() >= 10 and (ref >= 1 << 28).any()
