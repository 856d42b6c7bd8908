"""A CPU model of the fused backtrack kernel's schedule
(csrc/backtrack.cu, one block a read): the bitonic sort of the unique
64-bit candidate keys and the s_idx / r_of it leaves in the key buffer,
the walk's select over one bit a rank (a lane a 32-bit word, 1024 ranks
a ballot), the block-wide skipped-candidate flag, the ranking of at most
ucap chains by first-anchor x with build-order ties and the x-tie flag,
and the output fill (every position read from vbuf in reverse within its
chain).  Held bitwise (tolerance 0), on every output and on bt_unsure,
against the port's plain `backtrack_compact_ref` and, with the default
step budget, against the JAX package's ops/backtrack_jax
`backtrack_compact` (its budget is fixed at 8*A + 16, so the cases with
a small budget compare the two port versions only).  Inputs: the
parent-forest fuzz of tests/test_backtrack_device.py, lanes over a small
step budget, lanes with more than 64 chains, interacting equal-f ties,
two kept chains with equal first-anchor x, n_a in {0, 1, A}, and real
front planes (collect and chain of the port's DeviceFront on a small
synthetic graph) at A = 512 and at the 32 kb bucket's A = 5376."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigraph_tpu.ops.backtrack_jax import backtrack_compact as jax_bt
from minigraph_tpu_torch.ops import backtrack as bt
from test_torch_backtrack_walk import KEYS, UCAP, anchors, forest, i32

torch.set_num_threads(1)

P, CLAIMED, START, VIS, F15 = 0x3FFF, 1 << 14, 1 << 15, 1 << 16, 0x7FFF
INT_MAX, INT64_MAX, FULL = 0x7FFFFFFF, (1 << 63) - 1, 0xFFFFFFFF
ALL_KEYS = KEYS + ("steps",)


def bitonic(keys):
    """The kernel's bitonic sort, one compare-exchange pass at a time."""
    n = len(keys)
    i = np.arange(n // 2)
    k = 2
    while k <= n:
        j = k >> 1
        while j:
            lo = 2 * i - (i & (j - 1))
            hi = lo + j
            x, y = keys[lo], keys[hi]
            swap = (x > y) == ((lo & k) == 0)
            keys[lo], keys[hi] = np.where(swap, y, x), np.where(swap, x, y)
            j >>= 1
        k <<= 1
    return keys


def block_order(f, n_a, min_sc):
    """Phase 1: candidate keys (cand ? f : INT_MAX in u32 order, << 32 |
    index) sorted over the next power of two of A; s_idx from the low
    words, r_of scattered into the high words; n_z."""
    A = len(f)
    n_pow2 = 1 << (max(A, 1) - 1).bit_length()
    idx = np.arange(A, dtype=np.int64)
    cand = (idx < n_a) & (f >= min_sc)
    key32 = np.where(cand, f.astype(np.int64), INT_MAX)
    u = ((key32 & FULL) ^ 0x80000000).astype(np.uint64)
    keys = np.full(n_pow2, np.iinfo(np.uint64).max, np.uint64)
    keys[:A] = (u << np.uint64(32)) | idx.astype(np.uint64)
    keys = bitonic(keys)
    # the A keys are unique; the padding keys (all ones) sort last
    assert np.all(keys[1:A] > keys[:A - 1]) and np.all(keys[A:] == keys[-1])
    s_idx = (keys[:A] & np.uint64(FULL)).astype(np.int64)
    r_of = np.empty(A, np.int64)
    r_of[s_idx] = idx
    return s_idx, r_of, int(cand.sum())


def select(bits, k):
    """The highest rank <= k whose bit is clear: lane l tests word
    (k >> 5) - l of a 1024-rank group, the lowest lane with a clear bit
    wins, its highest clear bit is the rank."""
    wk = k >> 5
    top = wk
    while top >= 0:
        clr = []
        for lane in range(32):
            w = top - lane
            c = 0
            if w >= 0:
                c = ~bits[w] & FULL
                if w == wk:
                    c &= ((2 << (k & 31)) - 1) & FULL
            clr.append(c)
        lead = next((lane for lane in range(32) if clr[lane]), None)
        if lead is not None:
            return ((top - lead) << 5) + clr[lead].bit_length() - 1
        top -= 32
    return -1


def block(f, p, n_a, ax, min_cnt, min_sc, max_drop, ucap, max_steps):
    """One block of the fused kernel, phase by phase."""
    A = len(f)
    s_idx, r_of, nz = block_order(f, n_a, min_sc)
    fp = [[int(f[i]), int(p[i]) + 1] for i in range(A)]
    nw = max(1, (A + 31) // 32)
    bits = []
    for w in range(nw):
        lo = 32 * w
        bits.append(FULL if nz <= lo else 0 if nz >= lo + 32
                    else (FULL << (nz - lo)) & FULL)
    vbuf, usc, ucnt = [0] * A, [0] * ucap, [0] * ucap

    def claim(r):
        bits[r >> 5] |= 1 << (r & 31)

    # ---- 2. the walk
    mode, k = (0 if nz > 0 else 3), nz - 1
    pk_at = best_s = best_at = best_pos = sc0 = cut = nv0 = n_u = n_v = 0
    unsure, steps = False, 0
    while steps < max_steps and mode != 3:
        steps += 1
        fin = False
        if mode == 0:
            kf = select(bits, k)
            if kf < 0:
                mode = 3
                continue
            ci = int(s_idx[kf])
            fc, pkc = fp[ci]
            if pkc & VIS and (pkc >> 17) & F15 == fc & F15:
                unsure = True
            fp[ci][1] = i32((pkc & P) | CLAIMED | VIS | START
                            | ((fc & F15) << 17))
            claim(kf)
            vbuf[n_v] = ci
            sc0, best_s, best_at = fc, 0, ci
            best_pos = nv0 = n_v
            n_v += 1
            k, mode, pk_at = kf, 1, pkc
        elif mode == 1:
            at2 = (pk_at & P) - 1
            root = at2 < 0
            fa2, pk2 = (0, 0) if root else fp[at2]
            s = sc0 if root else sc0 - fa2
            better = s > best_s
            drop = not better and best_s - s > max_drop
            at2c = not root and bool(pk2 & CLAIMED)
            if at2c and (pk2 >> 17) & F15 == sc0 & F15:
                unsure = True
            if better:
                best_s, best_at = s, at2
            if not (drop or root or at2c):
                if better:
                    best_pos = n_v
                if pk2 & VIS and (pk2 >> 17) & F15 == sc0 & F15:
                    unsure = True
                fp[at2][1] = i32((pk2 & P) | CLAIMED | VIS
                                 | ((sc0 & F15) << 17))
                claim(int(r_of[at2]))
                vbuf[n_v] = at2
                n_v += 1
                pk_at = pk2
            else:
                cut = best_at
                keep_all = best_at == at2 or best_at < 0
                if not keep_all and n_v > best_pos:
                    mode = 2
                else:
                    fin, nv_keep = True, (n_v if keep_all else best_pos)
        else:
            u_at = vbuf[n_v - 1]
            fp[u_at][1] = i32(fp[u_at][1] & ~(CLAIMED | START))
            r = int(r_of[u_at])
            bits[r >> 5] &= ~(1 << (r & 31)) & FULL
            n_v -= 1
            if n_v <= best_pos:
                fin, nv_keep = True, n_v
        if fin:
            sc = sc0 if cut < 0 else sc0 - fp[cut][0]
            cnt = nv_keep - nv0
            acc = sc >= min_sc and cnt >= min_cnt and cnt > 0
            if acc:
                if n_u >= ucap:
                    unsure = True
                else:
                    usc[n_u], ucnt[n_u] = sc, cnt
                    n_u += 1
            n_v = nv_keep if acc else nv0
            k -= 1
            mode = 0
    unsure = unsure or mode != 3

    # ---- 3. a candidate skipped by the select (block-wide or)
    for a in range(A):
        fa, pk = fp[a]
        if (a < n_a and fa >= min_sc and pk & CLAIMED
                and (pk >> 17) & F15 == fa & F15 and not pk & START):
            unsure = True

    # ---- 4. the compaction
    coff = [sum(ucnt[:c]) for c in range(ucap)]
    kx = [INT64_MAX] * ucap
    for c in range(n_u):
        fv = min(vbuf[max(coff[c] + ucnt[c] - 1, 0)], A - 1)
        kx[c] = (int(ax[0][fv]) << 32) | int(ax[1][fv])
    perm = [0] * ucap
    for c in range(ucap):
        perm[sum(kx[j] < kx[c] or (kx[j] == kx[c] and j < c)
                 for j in range(ucap))] = c
    if any(kx[perm[r]] == kx[perm[r - 1]] for r in range(1, n_u)):
        unsure = True
    cnt_o = [ucnt[c] for c in perm]
    src_o = [coff[c] for c in perm]
    out_o = [sum(cnt_o[:r]) for r in range(ucap)]
    starts = [out_o[r] if r < n_u else INT_MAX for r in range(ucap)]
    c_ax = np.zeros((4, A), np.int64)
    for t in range(min(n_v, A)):
        lo, hi = 0, ucap
        while lo < hi:
            mid = (lo + hi) >> 1
            if starts[mid] <= t:
                lo = mid + 1
            else:
                hi = mid
        rk = min(max(lo - 1, 0), ucap - 1)
        src = src_o[rk] + cnt_o[rk] - 1 - (t - out_o[rk])
        a = min(max(vbuf[min(max(src, 0), A - 1)], 0), A - 1)
        c_ax[:, t] = [int(x[a]) for x in ax]
    return dict(c_axh=c_ax[0], c_axl=c_ax[1], c_ayh=c_ax[2], c_ayl=c_ax[3],
                u_sc=[usc[c] for c in perm], u_cnt=cnt_o, n_u=n_u, n_v=n_v,
                bt_unsure=unsure, steps=steps, pk=[v[1] for v in fp],
                vbuf=vbuf, s_idx=s_idx, r_of=r_of, n_z=nz)


def fused_model(F, Pp, NA, planes, min_cnt, min_sc, max_drop, ucap,
                max_steps):
    """The model on every lane, stacked as backtrack_compact returns."""
    B, A = F.shape
    lanes = [block(F[b], Pp[b], int(NA[b]), [x[b] for x in planes],
                   min_cnt, min_sc, max_drop, ucap, max_steps)
             for b in range(B)]
    dtypes = dict(c_axh=torch.int64, c_axl=torch.int64, c_ayh=torch.int64,
                  c_ayl=torch.int64, bt_unsure=torch.bool)
    return {key: torch.tensor(np.asarray([ln[key] for ln in lanes]),
                              dtype=dtypes.get(key, torch.int32)
                              ).reshape((B,) + np.shape(lanes[0][key]))
            for key in lanes[0]}


def check(F, Pp, NA, planes, jax_too=True, **kw):
    """The model against backtrack_compact_ref (every output, the walk's
    planes and the candidate order) and, with the default budget,
    against the JAX package.  Returns the model's outputs."""
    A = F.shape[1]
    args = dict(min_cnt=kw.get("min_cnt", 3), min_sc=kw.get("min_sc", 40),
                max_drop=kw["max_drop"], ucap=kw.get("ucap", UCAP))
    max_steps = kw.get("max_steps")
    got = fused_model(F, Pp, NA, planes, max_steps=max_steps or 8 * A + 16,
                      **args)
    tens = [torch.from_numpy(x) for x in (F, Pp, NA)]
    tplanes = [torch.from_numpy(x.astype(np.int64)) for x in planes]
    ref = bt.backtrack_compact_ref(*tens, *tplanes, max_steps=max_steps,
                                   **args)
    for key in ALL_KEYS:
        assert got[key].dtype == ref[key].dtype, key
        assert torch.equal(got[key], ref[key]), key
    # the sort's order and the walk's final planes
    f32, na32 = tens[0].to(torch.int32), tens[2].to(torch.int32)
    _, s_idx, r_of, n_z = bt.candidate_order(f32, na32, args["min_sc"])
    assert torch.equal(got["s_idx"], s_idx)
    assert torch.equal(got["r_of"], r_of)
    assert torch.equal(got["n_z"], n_z)
    w = bt.walk_ref(f32, tens[1], s_idx, r_of, n_z, args["min_cnt"],
                    args["min_sc"], args["max_drop"], args["ucap"],
                    max_steps or 8 * A + 16)
    assert torch.equal(got["pk"], w["pk"])
    assert torch.equal(got["vbuf"], w["vbuf"])
    if jax_too:
        assert max_steps is None
        want = jax_bt(jnp.asarray(F), jnp.asarray(Pp), jnp.asarray(NA),
                      *(jnp.asarray(x) for x in planes), **args)
        for key in KEYS:
            np.testing.assert_array_equal(
                np.asarray(want[key]).astype(np.int64),
                got[key].numpy().astype(np.int64), err_msg=key)
    return got


def test_bitonic_matches_stable_sort():
    """Keys with many equal f, negative f, n_a short of A and A not a
    power of two: the bitonic order is the stable (f, index) order."""
    rng = np.random.default_rng(11)
    for A in (1, 7, 32, 33, 100, 512, 777):
        f = rng.integers(-3, 4, A).astype(np.int32) * 20
        n_a = int(rng.integers(0, A + 1))
        s_idx, r_of, nz = block_order(f, n_a, 0)
        _, s_ref, r_ref, nz_ref = bt.candidate_order(
            torch.from_numpy(f)[None], torch.tensor([n_a], dtype=torch.int32),
            0)
        assert s_idx.tolist() == s_ref[0].tolist()
        assert r_of.tolist() == r_ref[0].tolist()
        assert nz == int(nz_ref[0])


def test_select_bit_a_rank():
    """The 1024-rank ballot finds the highest clear rank <= k across
    word and group edges, and -1 when every rank <= k is claimed."""
    rng = np.random.default_rng(12)
    n = 3000
    for _ in range(40):
        claimed = rng.random(n) < rng.choice([0.5, 0.99, 1.0])
        bits = [sum(int(claimed[32 * w + i]) << i for i in range(32)
                    if 32 * w + i < n) for w in range((n + 31) // 32)]
        for k in (-1, 0, 31, 32, 1023, 1024, 2047, int(rng.integers(0, n)),
                  n - 1):
            want = max((r for r in range(k + 1) if not claimed[r]),
                       default=-1)
            assert select(bits, k) == want


@pytest.mark.parametrize("max_drop", [5, 60, 500])
def test_fused_model_fuzz_forest(max_drop):
    rng = np.random.default_rng(200 + max_drop)
    F, Pp, NA = forest(rng, 16, 256)
    got = check(F, Pp, NA, anchors(rng, NA, 256), max_drop=max_drop)
    assert int(got["n_u"].sum()) > 0
    assert 0 < int(got["bt_unsure"].sum()) < 16


@pytest.mark.parametrize("max_steps", [1, 40, 200])
def test_fused_model_step_budget(max_steps):
    """Lanes over a small budget: flagged, and their n_v includes the
    chain in progress (the fill's tail past the live chains)."""
    rng = np.random.default_rng(17)
    F, Pp, NA = forest(rng, 12, 160)
    NA[0] = 0
    planes = anchors(rng, NA, 160)
    got = check(F, Pp, NA, planes, jax_too=False, max_drop=60,
                max_steps=max_steps)
    full = bt.backtrack_compact_ref(
        *(torch.from_numpy(x) for x in (F, Pp, NA)),
        *(torch.from_numpy(x.astype(np.int64)) for x in planes), min_cnt=3,
        min_sc=40, max_drop=60, ucap=UCAP)
    over = full["steps"] > max_steps
    assert over.any() and got["bt_unsure"][over].all()
    assert torch.equal(got["steps"], torch.clamp(full["steps"],
                                                 max=max_steps))
    assert not got["bt_unsure"][0] and int(got["steps"][0]) == 0


def special_lanes(rng, A=384):
    """n_a in {0, 1, A}, > 64 chains, interacting equal-f ties."""
    F = np.zeros((8, A), np.int32)
    Pp = np.full((8, A), -1, np.int32)
    NA = np.array([0, 1, A, A, 300, 300, 200, 120], np.int32)
    F[1, 0] = 55
    f2, p2, _ = forest(rng, 1, A + 1)
    F[2], Pp[2] = f2[0, :A], p2[0, :A]
    F[3] = rng.integers(0, 60, A)
    for c in range(100):
        i = 3 * c
        F[4, i: i + 3] = [5, 20, 45 + c % 10]
        Pp[4, i + 1: i + 3] = [i, i + 1]
    for lane, n in ((5, 300), (6, 200)):
        for c in range(n // 6):
            i = 6 * c
            F[lane, i: i + 6] = [10, 30, 60, 60, 61 + c % 2, 61 + c % 2]
            Pp[lane, i + 1: i + 6] = [i, i + 1, i + 1, i + 2, i + 3]
    f7, p7, _ = forest(rng, 1, 121, f_lo=40, f_hi=44, step=(0, 3))
    F[7, :120], Pp[7, :120] = f7[0, :120], p7[0, :120]
    return F, Pp, NA


def test_fused_model_special_lanes():
    rng = np.random.default_rng(13)
    F, Pp, NA = special_lanes(rng)
    got = check(F, Pp, NA, anchors(rng, NA, F.shape[1]), max_drop=60)
    assert int(got["n_u"][0]) == 0 and int(got["steps"][0]) == 0
    assert int(got["n_u"][1]) == 0 and int(got["steps"][1]) == 3
    assert int(got["n_u"][4]) == UCAP and got["bt_unsure"][4]
    assert int(got["n_v"][4]) > int(got["u_cnt"][4].sum())
    assert got["bt_unsure"][5] or got["bt_unsure"][6]
    assert got["bt_unsure"][7]


def test_fused_model_equal_first_x():
    """Three-anchor chains whose first anchors share x: two kept chains
    with equal x flag the lane and keep build order; a kept chain tying
    a rejected one does not flag it."""
    rng = np.random.default_rng(14)
    A = 96
    F = np.zeros((4, A), np.int32)
    Pp = np.full((4, A), -1, np.int32)
    NA = np.full(4, 60, np.int32)
    for b in range(4):
        for c in range(20):
            i = 3 * c
            F[b, i: i + 3] = [5, 20, 45 + (7 * c) % 20]
            Pp[b, i + 1: i + 3] = [i, i + 1]
        Pp[b, 16] = -1             # chain 5: two anchors, rejected
    planes = list(anchors(rng, NA, A))
    ax = (planes[0].astype(np.uint64) << np.uint64(32)) | planes[1]
    ax[0, 9] = ax[0, 30]           # chains 3 and 10, both kept
    ax[1, 16] = ax[1, 45]          # chains 5 (rejected) and 15
    ax[2, 3] = ax[2, 6] = ax[2, 57]    # three kept chains
    planes[0] = (ax >> np.uint64(32)).astype(np.uint32)
    planes[1] = (ax & np.uint64(FULL)).astype(np.uint32)
    got = check(F, Pp, NA, planes, max_drop=60)
    assert got["bt_unsure"].tolist() == [True, False, True, False]
    assert int(got["n_u"][1]) == 19


def front_planes(tmp_path, pad_len, bsz, n_reads, mean_len, min_len,
                 max_len, window):
    """Collect and chain outputs of the port's DeviceFront (its plain
    versions on the CPU) on a small synthetic graph."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.mapping.device_front import DeviceFront
    from minigraph_tpu_torch.ops.anchors import collect_anchors_exact
    from minigraph_tpu_torch.ops.chain_exact import lchain_dp_exact_win
    from minigraph_tpu_torch.ops.sketch import encode_batch, sketch_planes
    from minigraph_tpu_torch.options import MapOptions
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa)
    ref = make_reference(200_000, seed=91)
    hap = write_bubble_rgfa(ref, 92, str(tmp_path / "g.gfa"), seg_len=20_000)
    reads = [s for _, s in simulate_reads([hap, ref], n_reads, seed=93,
                                          mean_len=mean_len, min_len=min_len,
                                          max_len=max_len)]
    mo = MapOptions()
    gi = build_index(read_gfa(str(tmp_path / "g.gfa")), 17, 11, mo)
    fr = DeviceFront(gi, mo, device="cpu", buckets=((pad_len, bsz),),
                     chain_window=window)
    qcap, acap, win, tile = fr.caps(pad_len)
    codes, lens = encode_batch(reads + [""] * (bsz - n_reads),
                               pad_to=pad_len)
    sp = sketch_planes(torch.from_numpy(codes), torch.from_numpy(lens),
                       gi.w, gi.k)
    res = collect_anchors_exact(fr.ji, sp.hh, sp.hl, sp.meta, sp.t_hh,
                                sp.t_hl, sp.t_meta, int(mo.occ_max1),
                                fr.occ_cap, qcap=qcap, acap=acap)
    f, p, _ = lchain_dp_exact_win(
        res["axh"], res["axl"], res["ayh"], res["ayl"], res["n_a"],
        int(fr.mdx_adj), int(fr.mdy_adj), int(mo.bw), int(mo.max_lc_skip),
        int(mo.max_lc_iter), fr.chn_pen_gap, fr.chn_pen_skip, window=win,
        tile=tile)
    planes = tuple(res[k].numpy().astype(np.uint32)
                   for k in ("axh", "axl", "ayh", "ayl"))
    kw = dict(min_cnt=int(mo.min_lc_cnt), min_sc=int(mo.min_lc_score),
              max_drop=int(mo.bw), ucap=UCAP)
    return (f.numpy(), p.numpy(), res["n_a"].numpy().astype(np.int32),
            planes, kw)


@pytest.mark.parametrize("shape", ["2048x12", "32768x2"])
def test_fused_model_front_planes(tmp_path, shape):
    """Real front planes: the 2 kb bucket's A = 512, and the 32 kb
    bucket's A = 5376 with two ~25 kb reads and an empty lane."""
    if shape == "2048x12":
        F, Pp, NA, planes, kw = front_planes(tmp_path, 2048, 12, 12, 1500,
                                             400, 2000, 64)
    else:
        F, Pp, NA, planes, kw = front_planes(tmp_path, 32768, 3, 2, 25000,
                                             20000, 30000, 32)
    assert F.shape[1] == (512 if shape == "2048x12" else 5376)
    got = check(F, Pp, NA, planes, **kw)
    assert int((got["n_u"] > 0).sum()) >= (10 if shape == "2048x12" else 2)


def test_cpu_route_is_the_plain_version(monkeypatch):
    """On CPU tensors backtrack_compact is backtrack_compact_ref: no
    kernel launch, no kernel library loaded, and the kernel's clock
    buffer refused."""
    from minigraph_tpu_torch import kernels

    def no_launch(*args):
        raise AssertionError("a CPU tensor reached the kernel")
    monkeypatch.setattr(kernels, "launch", no_launch)
    rng = np.random.default_rng(15)
    F, Pp, NA = forest(rng, 4, 64)
    tens = [torch.from_numpy(x) for x in (F, Pp, NA)]
    tens += [torch.from_numpy(x.astype(np.int64))
             for x in anchors(rng, NA, 64)]
    kw = dict(min_cnt=3, min_sc=40, max_drop=60, ucap=UCAP)
    got = bt.backtrack_compact(*tens, **kw)
    ref = bt.backtrack_compact_ref(*tens, **kw)
    for key in ALL_KEYS:
        assert torch.equal(got[key], ref[key]), key
    with pytest.raises(ValueError):
        bt.backtrack_compact(*tens, clock=torch.zeros((4, 4),
                                                      dtype=torch.int64),
                             **kw)


def test_smem_bytes_widest_shape():
    """The fused kernel's block holds the main path's widest A = 5376
    and at most A = 8192 (its sort takes the next power of two)."""
    assert bt.walk_smem_bytes(5376, UCAP) <= 140_000
    assert bt.walk_smem_bytes(8192, UCAP) <= bt.SMEM_LIMIT
    assert bt.walk_smem_bytes(8193, UCAP) > bt.SMEM_LIMIT
