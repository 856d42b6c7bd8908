"""The batched exact WFA of the -c gap pool (ops/wfa_exact.py) against
the JAX package's ops/wfa_jax.py on the CPU: encode_pairs, the plain
wfa_device (score, the whole tb planes, done, end_d, no_ext), the plain
wfa_tb_walk (ops, fin_i, fin_k) and decode_walk, bitwise; the decoded
CIGARs against the native host engine (align/wfa.py wfa_exact).  Then a
numpy model of the CUDA kernels (csrc/wfa_exact.cu): wfa_wave one pair
at a time that stops at its own score, its ring int16 in rows with
NEG16 pads, the extension only within s diagonals of the seed's at
step s and 8-byte compares, the first end diagonal by a min over
(diagonal << 1 | not extended), the slots one barrier a step allows;
wfa_walk with its 32-base match runs and its read-ahead of the next tb
step's nine cells.  The model is held bitwise against the plain
version: score, end_d and no_ext whole, tb on the rows below each
pair's score, and the walk's ops and fin_i/fin_k whole when it runs on
the model's tb, whose unwritten rows hold garbage.  Then the 8-byte
extension against the byte loop, and the int16 encoding's edges at
the gap pool's buckets.  Tolerance: exact equality."""
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
LANES = 32


def ld8(buf, p):
    """csrc/wfa_exact.cu ld8: three aligned 4-byte words of a staged
    sequence and two funnel shifts, bytes p .. p + 7."""
    a, b, c = (int.from_bytes(buf[4 * (p >> 2) + 4 * i: 4 * (p >> 2)
                                  + 4 * i + 4], "little") for i in range(3))
    sh = (p & 3) * 8
    lo = ((b << 32 | a) >> sh) & 0xFFFFFFFF
    hi = ((c << 32 | b) >> sh) & 0xFFFFFFFF
    return lo | hi << 32


def extend_words(st, sq, k, d, tl, ql):
    """csrc/wfa_exact.cu extend: (k, compares), 8 bytes a compare, the
    first differing byte's index by the lowest set bit."""
    n = min(tl - 1 - k, ql - 1 - d - k)
    it = 0
    while n > 0:
        x = ld8(st, k + 1) ^ ld8(sq, d + k + 1)
        it += 1
        if x:
            return k + min(((x & -x).bit_length() - 1) >> 3, n), it
        if n <= 8:
            return k + n, it
        k += 8
        n -= 8
    return k, it


def extend_bytes(st, sq, k, d, tl, ql, L):
    """The byte loop of the JAX extension (clamped reads) for one
    diagonal."""
    while k + 1 < tl and d + k + 1 < ql \
            and st[min(k + 1, L - 1)] == sq[min(d + k + 1, L - 1)]:
        k += 1
    return k


def staged(row, L, rng):
    """A sequence as the kernels stage it in shared memory: the row's L
    bytes, then slack the kernel never writes (garbage here)."""
    buf = bytearray(rng.integers(0, 256, wx.seq_stride(L)).astype(
        np.uint8).tobytes())
    buf[:L] = row[:L].tobytes()
    return buf


def cell(hx, ho1m, ho1p, ho2m, ho2p, e1m, f1p, e2m, f2p):
    """csrc/wfa_exact.cu wave_cell on numpy arrays: (h, e1, f1, e2, f2,
    tb byte) of the next wave."""
    nE1, nE2 = np.maximum(ho1m, e1m), np.maximum(ho2m, e2m)
    e = np.maximum(nE1, nE2)
    nF1 = np.maximum(ho1p, f1p) + 1
    nF2 = np.maximum(ho2p, f2p) + 1
    f = np.maximum(nF1, nF2)
    h = np.maximum(e, f)
    x = np.where(ho1m >= e1m, 0, 0x08) | np.where(ho2m >= e2m, 0, 0x20) \
        | np.where(ho1p >= f1p, 0, 0x10) | np.where(ho2p >= f2p, 0, 0x40)
    z = np.where(e >= f, np.where(nE1 >= nE2, 1, 3),
                 np.where(nF1 >= nF2, 2, 4))
    z = np.where(hx + 1 >= h, 0, z)
    return np.maximum(hx + 1, h), nE1, nF1, nE2, nF2, x | z


def plane_waves(pens, n):
    """csrc/wfa_exact.cu plane_wave for waves 1 .. n: the values (h, e1,
    f1, e2, f2, tb byte) every diagonal of the plane without a seed and
    without edges holds, one row a wave (row 0: wave 0, all NEG16)."""
    px, po1, pe1, po2, pe2 = pens
    V = np.full((n + 1, 6), wx.NEG16, np.int64)

    def at(v, col):
        return V[v, col] if v >= 0 else wx.NEG16
    for v in range(1, n + 1):
        ho1, ho2 = at(v - po1 - pe1, 0), at(v - po2 - pe2, 0)
        V[v] = [int(a) for a in cell(
            np.int64(at(v - px, 0)), ho1, ho1, ho2, ho2, at(v - pe1, 1),
            at(v - pe1, 2), at(v - pe2, 3), at(v - pe2, 4))]
    return V


def wave_model(ts, tl, qs, ql, pens, d_cap, s_cap):
    """csrc/wfa_exact.cu wfa_wave_kernel, one pair at a time: the int16
    ring in shared memory (rows of ring_stride(D) slots, the diagonal j
    at slot j + 2, pads and every slot NEG16 at the start), the
    extension only within s diagonals of the seed's at step s, 8-byte
    extension compares, one barrier a step, and the far cells of wave w
    (at least w diagonals from both edges, more than w from the seed's)
    given the edgeless plane's wave (`plane_waves`), their ring values
    stored only within dh of the cells computed in full.  Beside it the
    model computes every cell in full in a second ring and checks: the
    far cells equal the plane's wave; the cells computed in full read
    only ring values of the wave they expect (a stamp a value); no value
    leaves int16; no diagonal outside the seed's band holds a k >= -1;
    the wave of step s reads no slot that step s writes or that step s +
    1's extension rewrites (the one-barrier schedule); the pads stay
    NEG16.  Returns (score, tb, end_d, no_ext, ext_compares, far
    cells)."""
    px, po1, pe1, po2, pe2 = pens
    dh, de1, de2 = wx._ring_depths(pens)
    wo1, wo2 = po1 + pe1, po2 + pe2
    B, L = ts.shape
    D = 2 * d_cap + 1
    RS = wx.ring_stride(D)
    wx.ring16_bytes(pens, L, d_cap, s_cap)
    V = plane_waves(pens, s_cap + 1)
    tb = np.full((s_cap, B, D), GARBAGE, dtype=np.uint8)
    score = np.zeros(B, np.int32)
    end_d = np.zeros(B, np.int32)
    no_ext = np.zeros(B, bool)
    n_cmp = n_far = 0
    rng = np.random.default_rng(0)
    jj = np.arange(D)
    J = jj + 2                          # diagonal j's slot
    depth = {"H": dh, "E1": de1, "F1": de1, "E2": de2, "F2": de2}
    for b in range(B):
        st, sq = staged(ts[b], L, rng), staged(qs[b], L, rng)
        t_l, q_l = int(tl[b]), int(ql[b])
        ring, full, stamp = {}, {}, {}
        for n, dp in depth.items():
            ring[n] = np.full((dp, RS), wx.NEG16, np.int16)
            full[n] = np.full((dp, RS), wx.NEG16, np.int16)
            # slot r starts as wave r - depth (before wave 0), slot 0 as
            # wave 0
            stamp[n] = np.repeat(np.arange(dp)[:, None] - dp, RS, 1)
            stamp[n][0] = 0
        ring["H"][0, d_cap + 2] = full["H"][0, d_cap + 2] = -1
        score[b], end_d[b], no_ext[b] = -1, 0, False

        def rd(name, w, idx, comp):
            """ring row of wave w at slots idx, for the cells computed in
            full (comp): each read must find wave w (pads aside)"""
            r = w % depth[name]
            got = stamp[name][r, idx]
            pad = (idx < 2) | (idx >= D + 2)
            assert ((got == w) | pad | ~comp).all(), (name, w)
            return ring[name][r, idx].astype(np.int64)

        def frow(name, w):
            return full[name][w % depth[name]].astype(np.int64)
        for s in range(s_cap):
            Hc = ring["H"][s % dh]
            # where the ring holds wave s, it holds the full ring's values
            ok = stamp["H"][s % dh][J] == s
            assert np.array_equal(Hc[J][ok], full["H"][s % dh][J][ok])
            out = np.abs(jj - d_cap) > s
            assert ok[~out].all()               # the band is held
            assert (full["H"][s % dh][J][out] < -1).all()   # and holds all
            first = None
            for j in range(max(0, d_cap - s), min(D, d_cap + s + 1)):
                k = k0 = int(Hc[j + 2])
                d = j - d_cap
                if -1 <= k < t_l and -1 <= d + k < q_l:
                    k, it = extend_words(st, sq, k, d, t_l, q_l)
                    n_cmp += it
                    Hc[j + 2] = k
                    full["H"][s % dh][j + 2] = k
                if k == t_l - 1 and d + k == q_l - 1 and k > wx.NEG16:
                    key = j << 1 | (k == k0)
                    first = key if first is None else min(first, key)
            if first is not None:
                score[b], end_d[b], no_ext[b] = s, first >> 1, first & 1
                break
            w = s + 1
            # one barrier a step: the slots this wave reads are neither
            # the one it writes nor the one step s + 1 extends
            assert all((w - o) % dh != w % dh for o in (px, wo1, wo2))
            assert (w - pe1) % de1 != w % de1
            assert (w - pe2) % de2 != w % de2
            # every cell in full, in the second ring
            want = cell(frow("H", w - px)[J], frow("H", w - wo1)[J - 1],
                        frow("H", w - wo1)[J + 1], frow("H", w - wo2)[J - 1],
                        frow("H", w - wo2)[J + 1], frow("E1", w - pe1)[J - 1],
                        frow("F1", w - pe1)[J + 1], frow("E2", w - pe2)[J - 1],
                        frow("F2", w - pe2)[J + 1])
            dist = np.abs(jj - d_cap)
            far = (jj >= w) & (jj <= D - 1 - w) & (dist > w)
            halo = far & ((jj < w + dh) | (jj > D - 1 - w - dh)
                          | (dist <= w + dh))
            comp = ~far
            n_far += int(far.sum())
            got = cell(rd("H", w - px, J, comp), rd("H", w - wo1, J - 1, comp),
                       rd("H", w - wo1, J + 1, comp),
                       rd("H", w - wo2, J - 1, comp),
                       rd("H", w - wo2, J + 1, comp),
                       rd("E1", w - pe1, J - 1, comp),
                       rd("F1", w - pe1, J + 1, comp),
                       rd("E2", w - pe2, J - 1, comp),
                       rd("F2", w - pe2, J + 1, comp))
            for g, f_, v in zip(got, want, V[w]):
                assert np.array_equal(g[comp], f_[comp])
                assert (f_[far] == v).all()         # the plane's wave
            tb[s, b] = np.where(far, V[w, 5], got[5])
            for name, g, f_, v in zip(("H", "E1", "F1", "E2", "F2"), got,
                                      want, V[w]):
                assert (f_ >= -32768).all() and (f_ <= 32767).all()
                r = w % depth[name]
                full[name][r, J] = f_
                keep = comp | halo
                ring[name][r, J[keep]] = np.where(far, v, g)[keep]
                stamp[name][r, J[keep]] = w
            for r in list(ring.values()) + list(full.values()):
                assert (r[:, :2] == wx.NEG16).all()     # off the plane
                assert (r[:, D + 2:] == wx.NEG16).all()
    return score, tb, end_d, no_ext, n_cmp, n_far


def walk_model(ts, tl, qs, ql, tb, score, end_d, no_ext, pens, d_cap,
               t_cap):
    """csrc/wfa_exact.cu wfa_walk_kernel, one pair (warp) at a time: a
    run of match steps found 32 bases a round (the first lane that
    stops: past the run's limit or a mismatch); a tb step that reads
    also reads, in lanes 1-9, the nine cells the next tb step can read,
    and the next tb step takes its byte from the lane its state and
    extension bit pick.  Returns (ops, fin_i, fin_k, rounds, round
    trips, tb steps)."""
    px, po1, pe1, po2, pe2 = pens
    S, B, D = tb.shape
    L = ts.shape[1]
    ops = np.zeros((t_cap, B), np.uint8)
    fin_i = np.zeros(B, np.int32)
    fin_k = np.zeros(B, np.int32)
    rounds = trips = reads = 0
    rng = np.random.default_rng(1)
    wo1, wo2 = po1 + pe1, po2 + pe2
    moves = [(0, 0), (px, 0), (wo1, -1), (pe1, -1), (wo1, 1), (pe1, 1),
             (wo2, -1), (pe2, -1), (wo2, 1), (pe2, 1)]

    def clamp(v, hi):
        return min(max(v, 0), hi)
    for b in range(B):
        st, sq = staged(ts[b], L, rng), staged(qs[b], L, rng)
        sc = int(score[b])
        i, k, sx = int(ql[b]) - 1, int(tl[b]) - 1, sc - 1
        fi, fk, t = i, k, 0
        x_next = None
        last = 0
        if no_ext[b] and sc > 0:
            reads += 1
            last = int(tb[clamp(sc - 1, S - 1), b,
                          clamp(int(end_d[b]), D - 1)]) & 7
        while sc >= 0 and t < t_cap:
            if i < 0 or k < 0:
                fi, fk = i, k
                break
            if last == 0:
                lim = min(min(i, k) + 1, t_cap - t)
                r = 0
                while True:
                    rounds += 1
                    stop = [u >= lim or st[k - u] != sq[i - u]
                            for u in range(r, r + LANES)]
                    if any(stop):
                        r += stop.index(True)
                        break
                    r += LANES
                ops[t: t + r, b] = 7
                i, k, t = i - r, k - r, t + r
                if i < 0 or k < 0:
                    fi, fk = i, k
                    break
                if t >= t_cap:
                    break
            reads += 1
            if x_next is not None:
                x, x_next = x_next, None
                # the lane picked read this step's own cell
                assert x == int(tb[clamp(sx, S - 1), b,
                                   clamp(i - k + d_cap, D - 1)])
            else:
                trips += 1
                lanes = [int(tb[clamp(sx - p, S - 1), b,
                                clamp(i - k + dd + d_cap, D - 1)])
                         for p, dd in moves]
                x = lanes[0]
                state = (x & 7) if last == 0 else last
                ext = (x >> (state + 2)) & 1 if state > 0 else 0
                if state <= 4:
                    x_next = lanes[1 if state == 0 else 2 * state + ext]
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
            t += 1
            if i < 0 or k < 0:
                fi, fk = i, k
                break
        fin_i[b], fin_k[b] = fi, fk
    return ops, fin_i, fin_k, rounds, trips, reads


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
    m_score, m_tb, m_end, m_noext, _, n_far = wave_model(
        ts, tl, qs, ql, PENS, d_cap, s_cap)
    assert n_far > 0
    assert np.array_equal(m_score, score)
    assert np.array_equal(m_end, end_d)
    assert np.array_equal(m_noext, no_ext)
    for b in range(len(pairs)):
        n = int(score[b]) if score[b] >= 0 else s_cap
        assert np.array_equal(m_tb[:n, b], tb[:n, b]), b
        assert (m_tb[n:, b] == GARBAGE).all()       # stopped at its end
    m_ops, m_fi, m_fk, rounds, trips, reads = walk_model(
        ts, tl, qs, ql, m_tb, m_score, m_end, m_noext, PENS, d_cap,
        2 * d_cap + 4)
    assert np.array_equal(m_ops, ops)
    assert np.array_equal(m_fi, fi) and np.array_equal(m_fk, fk)
    # the match runs took fewer rounds than the walk's match steps, the
    # tb steps fewer round trips than reads
    assert rounds < int((ops == 7).sum())
    assert trips < reads
    if s_cap == 60:
        assert (score < 0).any() and (score >= 0).any()


@pytest.mark.parametrize("pens", [(2, 4, 2, 24, 1), (6, 5, 3, 13, 2),
                                  (1, 1, 1, 2, 1)])
def test_kernel_schedule_other_penalties(pens):
    """The model of wfa_wave at other penalties (other ring depths, so
    other far cells' planes and halos of dh diagonals), bitwise against
    the plain version."""
    pairs = make_pairs(12, n=6, max_len=100)
    d_cap, s_cap = 96, 150
    enc = wx.encode_pairs(pairs, L=d_cap)
    score, tb, _, end_d, no_ext = (x.numpy() for x in wx.wfa_device(
        *enc, pens, d_cap=d_cap, s_cap=s_cap))
    ts, tl, qs, ql = (x.numpy() for x in enc)
    m_score, m_tb, m_end, m_noext, _, n_far = wave_model(
        ts, tl, qs, ql, pens, d_cap, s_cap)
    assert n_far > 0
    assert np.array_equal(m_score, score) and np.array_equal(m_end, end_d)
    assert np.array_equal(m_noext, no_ext)
    for b in range(len(pairs)):
        n = int(score[b]) if score[b] >= 0 else s_cap
        assert np.array_equal(m_tb[:n, b], tb[:n, b]), b


def test_word_extension_matches_byte_loop():
    """The 8-byte extension stops at exactly the k of the byte loop: runs
    ending at every byte of a word, at the last base of either sequence,
    at the pads (target 254, query 255: never equal), from every
    alignment of k + 1 and d + k + 1, and with the staged slack past L
    holding garbage."""
    rng = np.random.default_rng(21)
    L0 = 61
    checked = 0
    for trial in range(40):
        n1 = int(rng.integers(0, L0 + 1))
        n2 = int(rng.integers(0, L0 + 1))
        base = rng.choice(list(b"ACGT"), size=L0).astype(np.uint8)
        t = base[:n1].copy()
        q = base[:n2].copy()
        # sparse differences, so runs cross word edges
        for p in rng.integers(0, max(n2, 1), size=int(rng.integers(0, 4))):
            if p < n2:
                q[p] = b"ACGT"[int(rng.integers(0, 4))]
        if trial % 4 == 3 and n2 > 4:       # a shifted copy: d != 0 runs
            q = np.concatenate([base[:3], t])[:n2]
        ts, tl, qs, ql = (x.numpy() for x in wx.encode_pairs(
            [(t.tobytes(), q.tobytes())], L=L0))
        L = ts.shape[1]
        st, sq = staged(ts[0], L, rng), staged(qs[0], L, rng)
        for d in range(-L0, L0 + 1):
            for k in range(-1, L0 + 1):
                if not (k < tl[0] and -1 <= d + k < ql[0]):
                    continue
                want = extend_bytes(st, sq, k, d, int(tl[0]), int(ql[0]), L)
                got, _ = extend_words(st, sq, k, d, int(tl[0]), int(ql[0]))
                assert got == want, (trial, d, k)
                checked += 1
    assert checked > 20000


def enc16(v):
    """The ring's int16 encoding of int32 ring values: a reachable k >=
    -1 stays as it is, NEG_INF + d becomes NEG16 + d (csrc/wfa_exact.cu
    stores the values this way; it never converts them)."""
    v = np.asarray(v, dtype=np.int64)
    return np.where(v >= -1, v, v - NEG + wx.NEG16)


@pytest.mark.parametrize("lmax,s_cap", [(768, 1024), (2048, 3072)])
def test_ring16_encoding_edges(lmax, s_cap):
    """The int16 ring's encoding at the gap pool's buckets
    (align/cigar_device.py BUCKETS): the drifted sentinel up to delta =
    s_cap, the off-plane pad (NEG_INF), the seed (-1) and k up to L +
    s_cap keep their order, max and +1 inside int16; the wrapper's check
    passes there and refuses one step past each limit."""
    from minigraph_tpu_torch.align.cigar_device import BUCKETS
    from minigraph_tpu_torch.align.cigar_device import PENS as POOL_PENS
    assert (lmax, s_cap) in [b[:2] for b in BUCKETS] and POOL_PENS == PENS
    L = lmax + wx.PAD
    assert wx.ring16_bytes(PENS, L, lmax, s_cap) <= wx.SMEM_MAX
    drift = NEG + np.arange(s_cap + 1)
    reach = np.arange(-1, L + s_cap + 1)
    v = np.concatenate([drift, reach])
    e = enc16(v)
    assert e.min() >= -32768 and e.max() <= 32767
    assert enc16(NEG) == wx.NEG16            # the pad, unwritten slots
    assert enc16(-1) == -1                   # the seed
    assert enc16(NEG + s_cap) == wx.NEG16 + s_cap < -1
    assert enc16(L + s_cap) == L + s_cap
    assert (np.diff(e) > 0).all()               # order (v is sorted)
    step = np.concatenate([drift[:-1], reach[:-1]])
    assert np.array_equal(enc16(step + 1), enc16(step) + 1)
    rng = np.random.default_rng(5)
    a, b = rng.choice(v, 4000), rng.choice(v, 4000)
    assert np.array_equal(enc16(np.maximum(a, b)),
                          np.maximum(enc16(a), enc16(b)))
    assert np.array_equal(enc16(a) >= enc16(b), a >= b)
    # one past each limit: the zones could meet, the ring would not fit,
    # a penalty the schedule needs positive
    wx.ring16_bytes(PENS, L, lmax, 32767 - L)
    with pytest.raises(ValueError):
        wx.ring16_bytes(PENS, L, lmax, 32767 - L + 1)
    def fits(d_cap):
        try:
            return wx.ring16_bytes(PENS, L, d_cap, s_cap) <= wx.SMEM_MAX
        except ValueError:
            return False
    d_fit = lmax
    while fits(d_fit + 1):
        d_fit += 1
    assert 2048 <= d_fit < 2200             # the widest bucket fits
    with pytest.raises(ValueError):
        wx.ring16_bytes(PENS, L, d_fit + 1, s_cap)
    with pytest.raises(ValueError):
        wx.ring16_bytes((4, 4, 2, 24, 1), L, 2048, s_cap)  # 35 rows
    for bad in ((0, 4, 2, 15, 1), (4, 4, 0, 15, 1), (4, 4, 2, 15, 0),
                (4, -1, 2, 15, 1)):
        with pytest.raises(ValueError):
            wx.ring16_bytes(bad, L, lmax, s_cap)

