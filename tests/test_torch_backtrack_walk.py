"""A CPU model of a scalar backtrack walk: one state machine a lane,
the select's downward scan over 32 ranks at a time (a warp's ballot over
one byte a rank), a step counter a lane and the step budget, run in
place of the walk (step (b)) of the port's plain ops/backtrack.py
backtrack_compact_ref (tests/test_torch_backtrack_fused.py models the
fused kernel csrc/backtrack.cu).  Held bitwise, on every output and
on bt_unsure, against the port's plain walk and against the JAX
package's ops/backtrack_jax.backtrack_compact (whose step budget is
fixed at 8*A + 16, so the cases with a small budget compare the two
port versions only).  Inputs: the parent-forest fuzz of
tests/test_backtrack_device.py, lanes over a small step budget, lanes
with more than 64 chains, equal-f interacting ties, n_a in {0, 1, A},
and real front planes (collect and chain of the port's DeviceFront on
a small synthetic graph).  Tolerance 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minigraph_tpu.ops.backtrack_jax import backtrack_compact as jax_bt
from minigraph_tpu_torch.ops import backtrack as bt

torch.set_num_threads(1)

KEYS = ("c_axh", "c_axl", "c_ayh", "c_ayl", "u_sc", "u_cnt", "n_u", "n_v",
        "bt_unsure")
WALK_KEYS = ("pk", "vbuf", "u_sc", "u_cnt", "n_u", "n_v", "unsure", "steps")
P, CLAIMED, START, VIS, F15 = 0x3FFF, 1 << 14, 1 << 15, 1 << 16, 0x7FFF
UCAP = 64


def i32(v):
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def lane_walk(f, p, s_idx, r_of, nz, min_cnt, min_sc, max_drop, ucap,
              max_steps):
    """One block of the kernel: warp 0's scalar state machine."""
    A = len(f)
    pk = [int(x) + 1 for x in p]
    claimed = [i >= nz for i in range(A)]
    vbuf, usc, ucnt = [0] * A, [0] * ucap, [0] * ucap
    mode, k = (0 if nz > 0 else 3), nz - 1
    pk_at = best_s = best_at = best_pos = sc0 = cut = nv0 = n_u = n_v = 0
    unsure, steps = False, 0
    while steps < max_steps and mode != 3:
        steps += 1
        fin = False
        if mode == 0:
            kf, base = -1, k
            while base >= 0:        # 32 ranks a ballot, highest first
                clear = [lane for lane in range(32)
                         if base - lane >= 0 and not claimed[base - lane]]
                if clear:
                    kf = base - clear[0]
                    break
                base -= 32
            if kf < 0:
                mode = 3
                continue
            ci = int(s_idx[kf])
            fc, pkc = int(f[ci]), pk[ci]
            if pkc & VIS and (pkc >> 17) & F15 == fc & F15:
                unsure = True
            pk[ci] = i32((pkc & P) | CLAIMED | VIS | START
                         | ((fc & F15) << 17))
            claimed[int(r_of[ci])] = True
            vbuf[n_v] = ci
            sc0, best_s, best_at = fc, 0, ci
            best_pos = nv0 = n_v
            n_v += 1
            k, mode, pk_at = kf, 1, pkc
        elif mode == 1:
            at2 = (pk_at & P) - 1
            root = at2 < 0
            pk2 = 0 if root else pk[at2]
            s = sc0 if root else sc0 - int(f[at2])
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
                pk[at2] = i32((pk2 & P) | CLAIMED | VIS | ((sc0 & F15) << 17))
                claimed[int(r_of[at2])] = True
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
            pk[u_at] = i32(pk[u_at] & ~(CLAIMED | START))
            claimed[int(r_of[u_at])] = False
            n_v -= 1
            if n_v <= best_pos:
                fin, nv_keep = True, n_v
        if fin:
            sc = sc0 if cut < 0 else sc0 - int(f[cut])
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
    return pk, vbuf, usc, ucnt, n_u, n_v, unsure or mode != 3, steps


def walk_model(f, p, s_idx, r_of, n_z, min_cnt, min_sc, max_drop, ucap,
               max_steps):
    """The model in place of ops/backtrack.py walk_ref, lane by lane."""
    lanes = [lane_walk(*(x[b].tolist() for x in (f, p, s_idx, r_of)),
                       int(n_z[b]), min_cnt, min_sc, max_drop, ucap,
                       max_steps) for b in range(f.shape[0])]
    cols = list(zip(*lanes))

    def t(v, dt=torch.int32):
        return torch.tensor(np.asarray(v, np.int64), dtype=dt).reshape(
            (f.shape[0],) + np.asarray(v[0]).shape)
    return dict(pk=t(cols[0]), vbuf=t(cols[1]), u_sc=t(cols[2]),
                u_cnt=t(cols[3]), n_u=t(cols[4]), n_v=t(cols[5]),
                unsure=t(cols[6], torch.bool), steps=t(cols[7]))


def split(a):
    return ((a >> np.uint64(32)).astype(np.uint32),
            (a & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def forest(rng, B, N, f_lo=10, f_hi=80, step=(-40, 60)):
    """Random parent forests with f values that rise and fall
    (tests/test_backtrack_device.py's fuzz)."""
    F = np.zeros((B, N), np.int32)
    Pp = np.full((B, N), -1, np.int32)
    NA = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(20, N))
        NA[b] = n
        for i in range(n):
            if i and rng.random() < 0.9:
                j = int(rng.integers(max(0, i - 12), i))
                Pp[b, i] = j
                F[b, i] = F[b, j] + int(rng.integers(*step))
            else:
                F[b, i] = int(rng.integers(f_lo, f_hi))
    return F, Pp, NA


def anchors(rng, NA, N):
    B = len(NA)
    AX = np.zeros((B, N), np.uint64)
    AY = np.zeros((B, N), np.uint64)
    for b in range(B):
        n = int(NA[b])
        AX[b, :n] = np.sort(rng.integers(0, 1 << 33, n).astype(np.uint64))
        AY[b, :n] = rng.integers(0, 1 << 40, n).astype(np.uint64)
    return (*split(AX), *split(AY))


def run_port(F, Pp, NA, planes, walk, **kw):
    return bt._backtrack(
        walk, torch.from_numpy(F), torch.from_numpy(Pp),
        torch.from_numpy(NA),
        *(torch.from_numpy(x.astype(np.int64)) for x in planes),
        kw.get("min_cnt", 3), kw.get("min_sc", 40), kw["max_drop"],
        kw.get("ucap", UCAP), kw.get("max_steps"))


def check(F, Pp, NA, planes, jax_too=True, **kw):
    """Model against the plain walk (walk outputs and results) and, with
    the default budget, against the JAX package.  Returns the model's
    results."""
    got = run_port(F, Pp, NA, planes, walk_model, **kw)
    ref = run_port(F, Pp, NA, planes, bt.walk_ref, **kw)
    for key in KEYS + ("steps",):
        assert torch.equal(got[key], ref[key]), key
    # the walk's own planes too
    f = torch.from_numpy(F)
    cand, s_idx, r_of, n_z = bt.candidate_order(
        f, torch.from_numpy(NA), kw.get("min_sc", 40))
    args = (f, torch.from_numpy(Pp), s_idx, r_of, n_z,
            kw.get("min_cnt", 3), kw.get("min_sc", 40), kw["max_drop"],
            kw.get("ucap", UCAP),
            kw.get("max_steps") or 8 * F.shape[1] + 16)
    wm, wr = walk_model(*args), bt.walk_ref(*args)
    for key in WALK_KEYS:
        assert torch.equal(wm[key], wr[key]), key
    if jax_too:
        assert kw.get("max_steps") is None
        want = jax_bt(jnp.asarray(F), jnp.asarray(Pp), jnp.asarray(NA),
                      *(jnp.asarray(x) for x in planes),
                      min_cnt=kw.get("min_cnt", 3),
                      min_sc=kw.get("min_sc", 40),
                      max_drop=kw["max_drop"], ucap=kw.get("ucap", UCAP))
        for key in KEYS:
            np.testing.assert_array_equal(
                np.asarray(want[key]).astype(np.int64),
                got[key].numpy().astype(np.int64), err_msg=key)
    return got


@pytest.mark.parametrize("max_drop", [5, 60, 500])
def test_walk_model_fuzz_forest(max_drop):
    rng = np.random.default_rng(100 + max_drop)
    F, Pp, NA = forest(rng, 16, 256)
    got = check(F, Pp, NA, anchors(rng, NA, 256), max_drop=max_drop)
    assert int(got["n_u"].sum()) > 0
    assert 0 < int(got["bt_unsure"].sum()) < 16


@pytest.mark.parametrize("max_steps", [1, 40, 200])
def test_walk_model_step_budget(max_steps):
    """Lanes forced over a small budget are flagged, and the rest come
    out as they do with the full budget."""
    rng = np.random.default_rng(7)
    F, Pp, NA = forest(rng, 12, 160)
    NA[0] = 0
    planes = anchors(rng, NA, 160)
    got = check(F, Pp, NA, planes, jax_too=False, max_drop=60,
                max_steps=max_steps)
    full = run_port(F, Pp, NA, planes, bt.walk_ref, max_drop=60)
    over = full["steps"] > max_steps
    assert over.any()
    assert got["bt_unsure"][over].all()
    assert not got["bt_unsure"][0]
    assert torch.equal(got["steps"], torch.clamp(full["steps"],
                                                 max=max_steps))
    keep = ~over
    for key in KEYS:
        assert torch.equal(got[key][keep], full[key][keep]), key


def test_walk_model_special_lanes():
    """n_a in {0, 1, A}, a lane with more than 64 chains, lanes whose
    chains start at equal f and meet, in one batch."""
    rng = np.random.default_rng(3)
    A = 384
    F = np.zeros((8, A), np.int32)
    Pp = np.full((8, A), -1, np.int32)
    NA = np.array([0, 1, A, A, 300, 300, 200, 120], np.int32)
    F[1, 0] = 55                                  # one anchor, one start
    f2, p2, _ = forest(rng, 1, A + 1)
    F[2], Pp[2] = f2[0, :A], p2[0, :A]            # n_a = A
    F[3], Pp[3] = (rng.integers(0, 60, A).astype(np.int32),
                   np.full(A, -1, np.int32))      # roots only, n_a = A
    # 100 chains of 3 anchors, each scoring 45-54: over ucap = 64
    for c in range(100):
        i = 3 * c
        F[4, i: i + 3] = [5, 20, 45 + c % 10]
        Pp[4, i + 1: i + 3] = [i, i + 1]
    # equal-f starts whose walks meet: pairs of chains share a parent
    for lane, n in ((5, 300), (6, 200)):
        for c in range(n // 6):
            i = 6 * c
            F[lane, i: i + 6] = [10, 30, 60, 60, 61 + c % 2, 61 + c % 2]
            Pp[lane, i + 1: i + 6] = [i, i + 1, i + 1, i + 2, i + 3]
    # a small forest with few distinct f values: many interacting ties
    f7, p7, _ = forest(rng, 1, 121, f_lo=40, f_hi=44, step=(0, 3))
    F[7, :120], Pp[7, :120] = f7[0, :120], p7[0, :120]
    planes = anchors(rng, NA, A)
    got = check(F, Pp, NA, planes, max_drop=60)
    assert int(got["n_u"][0]) == 0 and int(got["steps"][0]) == 0
    assert int(got["n_u"][4]) == UCAP and got["bt_unsure"][4]
    assert got["bt_unsure"][5] or got["bt_unsure"][6]
    assert got["bt_unsure"][7]


def test_walk_model_front_planes(tmp_path):
    """Real collect and chain outputs of the port's DeviceFront (its
    plain versions on the CPU) on a small synthetic graph."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.mapping.device_front import UCAP as FRONT_UCAP
    from minigraph_tpu_torch.mapping.device_front import DeviceFront
    from minigraph_tpu_torch.ops.anchors import collect_anchors_exact
    from minigraph_tpu_torch.ops.chain_exact import lchain_dp_exact_win
    from minigraph_tpu_torch.ops.sketch import encode_batch, sketch_planes
    from minigraph_tpu_torch.options import MapOptions
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa)
    ref = make_reference(150_000, seed=81)
    hap = write_bubble_rgfa(ref, 82, str(tmp_path / "g.gfa"), seg_len=20_000)
    reads = [s for _, s in simulate_reads([hap, ref], 16, seed=83,
                                          mean_len=1500, min_len=400,
                                          max_len=2000)]
    mo = MapOptions()
    gi = build_index(read_gfa(str(tmp_path / "g.gfa")), 17, 11, mo)
    fr = DeviceFront(gi, mo, device="cpu", buckets=((2048, 16),),
                     chain_window=64)
    qcap, acap, win, tile = fr.caps(2048)
    codes, lens = encode_batch(reads, pad_to=2048)
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
    got = check(f.numpy(), p.numpy(), res["n_a"].numpy().astype(np.int32),
                planes, min_cnt=int(mo.min_lc_cnt),
                min_sc=int(mo.min_lc_score), max_drop=int(mo.bw),
                ucap=FRONT_UCAP)
    assert int((got["n_u"] > 0).sum()) >= 12
