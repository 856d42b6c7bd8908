"""The batched exact WFA of the -c gap pool (ops/wfa_exact.py) against
the JAX package's ops/wfa_jax.py on the CPU: encode_pairs, the plain
wfa_device (score, the whole tb planes, done, end_d, no_ext), the plain
wfa_tb_walk (ops, fin_i, fin_k) and decode_walk, bitwise; the decoded
CIGARs against the native host engine (align/wfa.py wfa_exact).  Then a
numpy model of the CUDA kernels' schedule (csrc/wfa_exact.cu: one pair
at a time that stops at its own score, per-diagonal greedy extension,
the first end diagonal by a min over (diagonal << 1 | not extended),
rings of only the depths each array is read back, waves before 0 and
diagonals off the plane read as NEG_INF, tb rows past the score left
unwritten) held bitwise against the plain version: score, end_d and
no_ext whole, tb on the rows below each pair's score, and the walk's
ops and fin_i/fin_k whole when it runs on the model's tb, whose
unwritten rows hold garbage.  Tolerance: exact equality."""
import numpy as np
import pytest
import torch

from minigraph_tpu.ops import wfa_jax
from minigraph_tpu_torch.align.wfa import WfOpt, wfa_exact
from minigraph_tpu_torch.ops import wfa_exact as wx

torch.set_num_threads(1)

PENS = (4, 4, 2, 15, 1)
D_CAP, S_CAP = 192, 400


def make_pairs(seed, n=20, max_len=160):
    """Pairs of 5-160 bp at 5%, 20% and 50% substitutions with length
    skews, plus a tiny pair against a homopolymer and an exact pair
    (tests/test_device_wfa.py's set)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        n1 = int(rng.integers(5, max_len))
        n2 = max(1, n1 + int(rng.integers(-12, 12)))
        base = rng.choice(list(b"ACGT"),
                          size=max(n1, n2) + 4).astype(np.uint8)
        s1 = base[:n1].tobytes()
        s2 = bytearray(base[:n2].tobytes())
        div = rng.choice([0.05, 0.2, 0.5])
        for p in rng.integers(0, max(n2, 1), size=max(1, int(n2 * div))):
            s2[p] = b"ACGT"[int(rng.integers(0, 4))]
        pairs.append((s1, bytes(s2)))
    pairs.append((b"ACGT", b"ACGT"))
    pairs.append((b"A", b"TTTTTTTT"))
    return pairs


def run_jax(pairs, d_cap=D_CAP, s_cap=S_CAP):
    ts, tl, qs, ql = wfa_jax.encode_pairs(pairs, L=d_cap)
    score, tb, done, end_d, no_ext = wfa_jax.wfa_device(
        ts, tl, qs, ql, PENS, d_cap=d_cap, s_cap=s_cap)
    ops, fi, fk = wfa_jax.wfa_tb_walk(ts, tl, qs, ql, tb, score, end_d,
                                      no_ext, PENS, d_cap=d_cap,
                                      t_cap=2 * d_cap + 4)
    return [np.asarray(x) for x in (score, tb, done, end_d, no_ext, ops,
                                    fi, fk)]


def run_plain(pairs, d_cap=D_CAP, s_cap=S_CAP):
    enc = wx.encode_pairs(pairs, L=d_cap)
    score, tb, done, end_d, no_ext = wx.wfa_device(
        *enc, PENS, d_cap=d_cap, s_cap=s_cap)
    ops, fi, fk = wx.wfa_tb_walk(*enc, tb, score, end_d, no_ext, PENS,
                                 d_cap=d_cap, t_cap=2 * d_cap + 4)
    return [x.numpy() for x in (score, tb, done, end_d, no_ext, ops, fi,
                                fk)]


@pytest.fixture(scope="module", params=[8, 9])
def case(request):
    pairs = make_pairs(request.param)
    return pairs, run_jax(pairs), run_plain(pairs)


def test_encode_pairs_match_jax():
    pairs = make_pairs(3)
    got = wx.encode_pairs(pairs, L=D_CAP)
    want = wfa_jax.encode_pairs(pairs, L=D_CAP)
    for g, w in zip(got, want):
        assert g.dtype == {np.dtype("uint8"): torch.uint8,
                           np.dtype("int32"): torch.int32}[np.asarray(w)
                                                            .dtype]
        assert np.array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        wx.encode_pairs([(b"A" * 10, b"A")], L=8)


NAMES = ("score", "tb", "done", "end_d", "no_ext", "ops", "fin_i", "fin_k")


@pytest.mark.parametrize("out", range(len(NAMES)), ids=NAMES)
def test_plain_matches_jax(case, out):
    _, want, got = case
    assert got[out].shape == want[out].shape
    assert got[out].dtype == want[out].dtype
    assert np.array_equal(got[out], want[out]), NAMES[out]


def test_decode_walk_matches_jax_and_host(case):
    pairs, want, got = case
    score, ops, fi, fk = got[0], got[5], got[6], got[7]
    checked = 0
    for i, (t, q) in enumerate(pairs):
        if score[i] < 0:
            continue
        cig = wx.decode_walk(ops[:, i], int(fi[i]), int(fk[i]))
        assert cig == wfa_jax.decode_walk(ops[:, i], int(fi[i]), int(fk[i]))
        host = wfa_exact(WfOpt(cigar=True), t, q)
        assert host.s == score[i] and cig == host.cigar, i
        checked += 1
    assert checked == len(pairs)


def test_over_budget_matches_jax():
    """A score budget below some pairs' scores: -1 there, the rest as
    before, on both sides."""
    pairs = make_pairs(11, n=12)
    want = run_jax(pairs, s_cap=60)
    got = run_plain(pairs, s_cap=60)
    assert (want[0] < 0).sum() >= 3 and (want[0] >= 0).sum() >= 3
    for out, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), NAMES[out]


# ---- the kernels' schedule ------------------------------------------
NEG = wx.NEG_INF
GARBAGE = 0xA5


def wave_model(ts, tl, qs, ql, pens, d_cap, s_cap):
    """csrc/wfa_exact.cu wfa_wave_kernel, one pair at a time."""
    px, po1, pe1, po2, pe2 = pens
    dh, de1, de2 = wx._ring_depths(pens)
    B, L = ts.shape
    D = 2 * d_cap + 1
    tb = np.full((s_cap, B, D), GARBAGE, dtype=np.uint8)
    score = np.zeros(B, np.int32)
    end_d = np.zeros(B, np.int32)
    no_ext = np.zeros(B, bool)
    rng = np.random.default_rng(0)
    for b in range(B):
        st, sq = ts[b].tobytes(), qs[b].tobytes()
        t_l, q_l = int(tl[b]), int(ql[b])
        # ring slots start as garbage: only written waves may be read
        H = rng.integers(-5, 5, (dh, D)).astype(np.int64)
        E1, F1 = (rng.integers(-5, 5, (de1, D)) for _ in range(2))
        E2, F2 = (rng.integers(-5, 5, (de2, D)) for _ in range(2))
        H[0] = NEG
        H[0, d_cap] = -1
        E1[0] = F1[0] = E2[0] = F2[0] = NEG

        def at(a, depth, w):
            """wave w padded by NEG_INF at both edges (D + 2 values)."""
            out = np.full(D + 2, NEG, np.int64)
            if w >= 0:
                out[1:-1] = a[w % depth]
            return out

        score[b], end_d[b], no_ext[b] = -1, 0, False
        for s in range(s_cap):
            Hc = H[s % dh]
            first = None
            for j in range(D):
                k = k0 = int(Hc[j])
                d = j - d_cap
                if -1 <= k < t_l and -1 <= d + k < q_l:
                    while k + 1 < t_l and d + k + 1 < q_l \
                            and st[min(k + 1, L - 1)] \
                            == sq[min(d + k + 1, L - 1)]:
                        k += 1
                    Hc[j] = k
                if k == t_l - 1 and d + k == q_l - 1 and k > NEG:
                    key = j << 1 | (k == k0)
                    first = key if first is None else min(first, key)
            if first is not None:
                score[b], end_d[b], no_ext[b] = s, first >> 1, first & 1
                break
            w = s + 1
            hx = at(H, dh, w - px)[1:-1]
            ho1, ho2 = at(H, dh, w - po1 - pe1), at(H, dh, w - po2 - pe2)
            ho1m, ho1p, ho2m, ho2p = ho1[:-2], ho1[2:], ho2[:-2], ho2[2:]
            e1m, f1p = at(E1, de1, w - pe1)[:-2], at(F1, de1, w - pe1)[2:]
            e2m, f2p = at(E2, de2, w - pe2)[:-2], at(F2, de2, w - pe2)[2:]
            nE1, nE2 = np.maximum(ho1m, e1m), np.maximum(ho2m, e2m)
            e = np.maximum(nE1, nE2)
            nF1 = np.maximum(ho1p, f1p) + 1
            nF2 = np.maximum(ho2p, f2p) + 1
            f = np.maximum(nF1, nF2)
            h = np.maximum(e, f)
            x = np.where(ho1m >= e1m, 0, 0x08) \
                | np.where(ho2m >= e2m, 0, 0x20) \
                | np.where(ho1p >= f1p, 0, 0x10) \
                | np.where(ho2p >= f2p, 0, 0x40)
            z = np.where(e >= f, np.where(nE1 >= nE2, 1, 3),
                         np.where(nF1 >= nF2, 2, 4))
            z = np.where(hx + 1 >= h, 0, z)
            tb[s, b] = x | z
            H[w % dh] = np.maximum(hx + 1, h)
            E1[w % de1], F1[w % de1] = nE1, nF1
            E2[w % de2], F2[w % de2] = nE2, nF2
    return score, tb, end_d, no_ext


def walk_model(ts, tl, qs, ql, tb, score, end_d, no_ext, pens, d_cap,
               t_cap):
    """csrc/wfa_exact.cu wfa_walk_kernel, one pair (thread) at a time."""
    px, po1, pe1, po2, pe2 = pens
    S, B, D = tb.shape
    L = ts.shape[1]
    ops = np.zeros((t_cap, B), np.uint8)
    fin_i = np.zeros(B, np.int32)
    fin_k = np.zeros(B, np.int32)

    def clamp(v, hi):
        return min(max(v, 0), hi)
    for b in range(B):
        sc = int(score[b])
        i, k, sx = int(ql[b]) - 1, int(tl[b]) - 1, sc - 1
        fi, fk = i, k
        last = 0
        if no_ext[b] and sc > 0:
            last = int(tb[clamp(sc - 1, S - 1), b,
                          clamp(int(end_d[b]), D - 1)]) & 7
        active = sc >= 0
        t = 0
        while t < t_cap and active:
            if i < 0 or k < 0:
                fi, fk = i, k
                break
            if last == 0 and ts[b, clamp(k, L - 1)] == qs[b, clamp(i, L - 1)]:
                op = 7
                i, k = i - 1, k - 1
            else:
                x = int(tb[clamp(sx, S - 1), b, clamp(i - k + d_cap, D - 1)])
                state = (x & 7) if last == 0 else last
                ext = (x >> (state + 2)) & 1 if state > 0 else 0
                op = 8 if state == 0 else 1 if state in (1, 3) else 2
                stc = min(state, 4)
                pen = px if stc == 0 else \
                    (pe1 if ext else po1 + pe1) if stc <= 2 else \
                    (pe2 if ext else po2 + pe2)
                i -= state in (0, 1, 3)
                k -= state in (0, 2, 4)
                sx -= pen
                last = state if (state > 0 and ext == 1) else 0
            ops[t, b] = op
            if i < 0 or k < 0:
                fi, fk = i, k
                active = False
            t += 1
        fin_i[b], fin_k[b] = fi, fk
    return ops, fin_i, fin_k


@pytest.mark.parametrize("s_cap", [S_CAP, 60])
def test_kernel_schedule_matches_plain(s_cap):
    pairs = make_pairs(8, n=14, max_len=120)
    d_cap = 128
    enc = wx.encode_pairs(pairs, L=d_cap)
    score, tb, _, end_d, no_ext = (x.numpy() for x in wx.wfa_device(
        *enc, PENS, d_cap=d_cap, s_cap=s_cap))
    ops, fi, fk = (x.numpy() for x in wx.wfa_tb_walk(
        *enc, torch.from_numpy(tb), torch.from_numpy(score),
        torch.from_numpy(end_d), torch.from_numpy(no_ext), PENS,
        d_cap=d_cap, t_cap=2 * d_cap + 4))
    ts, tl, qs, ql = (x.numpy() for x in enc)
    m_score, m_tb, m_end, m_noext = wave_model(ts, tl, qs, ql, PENS, d_cap,
                                               s_cap)
    assert np.array_equal(m_score, score)
    assert np.array_equal(m_end, end_d)
    assert np.array_equal(m_noext, no_ext)
    for b in range(len(pairs)):
        n = int(score[b]) if score[b] >= 0 else s_cap
        assert np.array_equal(m_tb[:n, b], tb[:n, b]), b
        assert (m_tb[n:, b] == GARBAGE).all()       # stopped at its end
    m_ops, m_fi, m_fk = walk_model(ts, tl, qs, ql, m_tb, m_score, m_end,
                                   m_noext, PENS, d_cap, 2 * d_cap + 4)
    assert np.array_equal(m_ops, ops)
    assert np.array_equal(m_fi, fi) and np.array_equal(m_fk, fk)
    if s_cap == 60:
        assert (score < 0).any() and (score >= 0).any()
