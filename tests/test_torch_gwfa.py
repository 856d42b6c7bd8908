"""The GWFA bridge engine of the port (ops/gwfa.py) against the JAX
package's ops/gwfa_jax.py on the CPU: build_device_graph's arrays; the
plain gwfa_batch against the JAX gwfa_batch on all four outputs (s,
flags, walk, n_walk) for bridge-shaped jobs on a 300 kb bubble graph
(tools/synth.py bridge_jobs, the recipe of tests/test_device_gwfa.py) at
mutation rates 3, 8 and 25 in both query buckets, and at reduced caps
that make every capacity flag fire on both sides; unflagged jobs against
the exact host engine (align/gwfa_exact.py gwfa_ed); and a per-job model
of the CUDA kernel's schedule (csrc/gwfa.cu, a block of NT threads a
job: team appends by ballot and popcount with caps, the kernel's
sorting networks under total orders that break ties by position,
sorted-set merges cut at their caps, the walk on one thread) held
against the plain version.  The JAX side compiles each cap set once
(~8 s).  Tolerance: exact equality."""
from bisect import bisect_left

import numpy as np
import pytest
import torch

from minigraph_tpu.graph.gfa_io import read_gfa as jax_read_gfa
from minigraph_tpu.index.midx import build_index as jax_build_index
from minigraph_tpu.ops import gwfa_jax
from minigraph_tpu_torch.align.gwfa_exact import gwfa_ed
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.ops import gwfa as gw
from minigraph_tpu_torch.tools.synth import (bridge_jobs, make_reference,
                                             write_bubble_rgfa,
                                             write_star_gfa)

torch.set_num_threads(1)

DIAG_SHIFT = gw.DIAG_SHIFT
U32 = gw.U32
F_TIE, F_DCAP, F_TCAP, F_DEG, F_HOP, F_FCAP, F_STEPS = (
    gw.F_TIE, gw.F_DCAP, gw.F_TCAP, gw.F_DEG, gw.F_HOP, gw.F_FCAP,
    gw.F_STEPS)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """The 300 kb bubble graph of 5 kb segments (and a star graph with a
    vertex of degree 8), read by both packages."""
    d = tmp_path_factory.mktemp("gwfa")
    write_bubble_rgfa(make_reference(300_000, seed=5), 6, str(d / "g.gfa"),
                      seg_len=5000, bubble_every=2)
    write_star_gfa(str(d / "star.gfa"), 7)
    out = {}
    for name in ("g", "star"):
        fn = str(d / f"{name}.gfa")
        g = read_gfa(fn)
        jg = jax_read_gfa(fn)
        out[name] = (g, build_index(g, 15, 10).es, jg,
                     jax_build_index(jg, 15, 10).es)
    return out


def make_jobs(graph, seed, qcap, n=16):
    """n jobs of the bucket (256, qcap] (or [1, 256]) at mutation rates 3,
    8 and 25 in turn."""
    g, es = graph[:2]
    rng = np.random.default_rng(seed)
    lo = 0 if qcap <= 256 else 256
    jobs = []
    while len(jobs) < n:
        for mrate in (3, 8, 25):
            jobs += [j for j in bridge_jobs(g, es, rng, 8, mrate, qcap)
                     if len(j[0]) > lo]
    return jobs[:n]


def run_both(graph, jobs, qcap, degcap=6, **caps):
    g, es, jg, jes = graph
    gd, _ = gw.build_device_graph(g, es, degcap)
    args = gw.pack_jobs(jobs, qcap)
    got = gw.gwfa_batch(gd, *args, degcap=degcap, **caps)
    jgd, _ = gwfa_jax.build_device_graph(jg, jes, degcap=degcap)
    want = gwfa_jax.gwfa_batch(
        jgd, *(np.asarray(x.numpy(), dtype=np.int32) for x in args),
        degcap=degcap, **caps)
    for key in ("s", "flags", "walk", "n_walk"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    return got


def test_device_graph_matches_jax(graphs):
    for name in ("g", "star"):
        g, es, jg, jes = graphs[name]
        for degcap in (1, 6):
            gd, md = gw.build_device_graph(g, es, degcap)
            jgd, jmd = gwfa_jax.build_device_graph(jg, jes, degcap=degcap)
            assert md == jmd
            for a, b in zip(gd, jgd):
                assert a.dtype == torch.int32
                assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("qcap", [256, 1024])
def test_plain_matches_jax(graphs, qcap):
    """16 jobs a bucket, the bucket's query width, the default caps."""
    got = run_both(graphs["g"], make_jobs(graphs["g"], qcap, qcap), qcap)
    assert int((got["flags"] == 0).sum()) >= 8
    assert int((got["s"] >= 0).sum()) >= 4


@pytest.mark.parametrize("qcap,seed", [(256, 105), (1024, 102)])
def test_plain_matches_jax_ties(graphs, qcap, seed):
    """Batches where a winning lineage carries a queue-order tie (F_TIE):
    the plain version's stable sorts against lax.sort, whose order among
    same-(vd, k) candidates is unspecified."""
    got = run_both(graphs["g"], make_jobs(graphs["g"], seed, qcap), qcap)
    assert any(f & F_TIE for f in got["flags"].tolist())
    model_matches(graphs["g"], make_jobs(graphs["g"], seed, qcap), qcap)


# reduced caps, each making some flag bits fire (the kernel's constraints
# evcap <= dcap <= min(ccap, evcap * degcap) are the JAX kernel's shapes)
FLAG_CAPS = [
    (dict(degcap=1, dcap=64, evcap=64, hopcap=1), F_DEG | F_HOP),
    (dict(dcap=16, evcap=16, ccap=32, tcap=8), F_DCAP | F_TCAP),
    (dict(fcap=8, max_steps=12), F_FCAP | F_STEPS),
]


@pytest.mark.parametrize("caps,bits", FLAG_CAPS,
                         ids=["deg_hop", "dcap_tcap", "fcap_steps"])
def test_plain_matches_jax_flag_caps(graphs, caps, bits):
    got = run_both(graphs["g"], make_jobs(graphs["g"], 11, 256), 256,
                   **caps)
    fired = 0
    for f in got["flags"].tolist():
        fired |= f
    assert fired & bits == bits, (fired, bits)


def test_unflagged_match_host_engine(graphs):
    """The exact-or-flag contract: every unflagged job's (s, walk) equals
    the exact host engine's, on the bubble graph and the star graph."""
    for name, qcap, seed in (("g", 256, 21), ("g", 1024, 22),
                             ("star", 1024, 23)):
        g, es = graphs[name][:2]
        jobs = make_jobs(graphs[name], seed, qcap)
        gd, _ = gw.build_device_graph(g, es)
        res = gw.gwfa_batch(gd, *gw.pack_jobs(jobs, qcap))
        n_exact = 0
        for i, (q, v0, e0, v1, e1, med) in enumerate(jobs):
            if int(res["flags"][i]):
                continue
            sp, wp = gwfa_ed(g, es, q, v0, e0, v1, e1, med)
            sd = int(res["s"][i])
            if sp < 0:
                assert sd < 0, (name, i, sd)
            else:
                assert sd == sp, (name, i, sd, sp)
                assert res["walk"][i, : int(res["n_walk"][i])].tolist() \
                    == wp, (name, i)
            n_exact += 1
        assert n_exact >= len(jobs) // 2, (name, n_exact)


NT = 256         # csrc/gwfa.cu's threads a job


def popc(x):
    return bin(x).count("1")


def team_append(items, count, cap, NT):
    """csrc/gwfa.cu Team::append over per-position items (None where the
    predicate is false): chunks of NT positions, a ballot of the
    predicates, each item's slot the count so far plus the popcount of
    the lanes below it.  Returns ([(slot, item)], the count capped, and
    whether a slot reached the cap)."""
    out, c, over = [], count, False
    for base in range(0, len(items), NT):
        chunk = items[base: base + NT]
        mask = sum(1 << lane for lane, it in enumerate(chunk)
                   if it is not None)
        for lane, it in enumerate(chunk):
            if it is not None:
                out.append((c + popc(mask & ((1 << lane) - 1)), it))
        over |= c + popc(mask) > cap
        c += popc(mask)
    return out, min(c, cap), over


def team_append_same(items, count, cap, NT, npass):
    """Team::append_same: npass passes of one predicate; on one chunk
    one ballot serves them all (pass a's slots after a * tot), else the
    passes run one after the other.  Returns ([(slot, pass, item)],
    count, over)."""
    if len(items) > NT:
        out, over = [], False
        for a in range(npass):
            o, count, ov = team_append(items, count, cap, NT)
            out += [(slot, a, it) for slot, it in o]
            over |= ov
        return out, count, over
    mask = sum(1 << lane for lane, it in enumerate(items) if it is not None)
    tot = popc(mask)
    out = [(count + a * tot + popc(mask & ((1 << lane) - 1)), a, it)
           for lane, it in enumerate(items) if it is not None
           for a in range(npass)]
    c = count + npass * tot
    return out, min(c, cap), c > cap


def rank_sort_model(keys):
    """The kernel's rank sort: each entry's slot is the count of smaller
    keys (the keys are unique: each ends in its position)."""
    out = [None] * len(keys)
    for x in keys:
        out[sum(y < x for y in keys)] = x
    assert None not in out
    return out


def bitonic_model(keys, pad, NT):
    """Team::bitonic: the shared-memory network over the next power of
    two, pads last; one thread a pair, NT at a time (the order of a
    stage's exchanges does not matter: they touch disjoint pairs)."""
    n = len(keys)
    p2 = 1 << max(0, (n - 1).bit_length())
    a = list(keys) + [pad] * (p2 - n)
    k = 2
    while k <= p2:
        j = k >> 1
        while j > 0:
            for i in range(p2):
                ixj = i ^ j
                if ixj > i:
                    x, y = a[i], a[ixj]
                    if (y < x) if (i & k) == 0 else (x < y):
                        a[i], a[ixj] = y, x
            j >>= 1
        k <<= 1
    return a[:n]


def team_sort(keys, NT, pad):
    """The kernel's sort of one array of unique keys: by rank up to RMAX
    = 2 NT entries, else the shared-memory bitonic network."""
    if len(keys) <= 2 * NT:
        return rank_sort_model(keys)
    return bitonic_model(keys, pad, NT)


def model_job(G, q, ql, v0, off0, v1, off1, max_ed, dcap=256, ccap=2048,
              tcap=512, fcap=512, wcap=64, degcap=6, hopcap=16, evcap=128,
              max_steps=256):
    """One job as csrc/gwfa.cu runs it on a block of NT threads: the
    frontier, the hop waves, the candidates, the trace and the events in
    the kernel's arrays; every append a team append (ballot and popcount
    a chunk, the three re-interior passes from one ballot); the
    candidates grouped by vd where the kernel's hash table holds them
    (else all sorted); the events, the staged forbidden set and the
    groups sorted as the kernel sorts them (by rank up to RMAX, else its
    bitonic network) under its total orders; sorted-set merges cut at
    their caps; the walk on one thread."""
    arc_w, arc_ow, arc_cnt, seq_off, seq_len, seq = G
    n = len(arc_cnt)
    BIGK = (1 << 63) - 1
    IMAX = (1 << 31) - 1

    def cv_(v):
        return min(max(v, 0), n - 1)

    def mk(v, d):
        return (v << 32) | ((DIAG_SHIFT + d) & U32)

    def vv(vd):
        return vd >> 32

    def dd(vd):
        low = vd & U32
        if low >= 1 << 31:
            low -= 1 << 32
        return low - DIAG_SHIFT

    def extend(vd, k):
        v, d = vv(vd), dd(vd)
        max_k = min(ql - d, seq_len[v]) - 1
        base = seq_off[v]
        while k < max_k and seq[base + k + 1] == q[d + k + 1]:
            k += 1
        return k

    A = [(mk(v0, -off0), off0 - 1, 0, 0)]
    forb = []
    s = flags = 0
    found = dead = False
    end_t = end_v = -1
    end_tn = 0
    tr_v = [-1] * tcap
    tr_pre = [-1] * tcap
    tr_n = 1
    while not (found or dead) and flags == 0:
        C = [None] * ccap
        n_c = 0
        stage = []
        nf_n = 0
        vis = []

        def push(items):
            """A candidate append; items per position, None where the
            predicate is false."""
            nonlocal flags, n_c
            out, n_c, over = team_append(items, n_c, ccap, NT)
            for slot, it in out:
                if slot < ccap:
                    C[slot] = it
            if over:
                flags |= F_DCAP

        def stage_add(vd):
            nonlocal nf_n
            nf_n += 1
            if len(stage) < 4 * dcap:
                stage.append(vd)

        A = [(vd, extend(vd, k), t, tn) for vd, k, t, tn in A]
        nA = len(A)
        bnd = []
        for vd, k, t, tn in A:
            vl = seq_len[vv(vd)]
            bnd.append(k == vl - 1 or dd(vd) + k == ql - 1)
        had_a = any(bnd)
        # wavefront children: merged, then left edges, then right edges
        has_l = [p > 0 and A[p][0] == A[p - 1][0] + 1 for p in range(nA)]
        has_r = [p + 1 < nA and A[p + 1][0] == A[p][0] + 1
                 for p in range(nA)]
        out = []
        for p, (vd, k, t, tn) in enumerate(A):
            vl = seq_len[vv(vd)]
            d = dd(vd)
            if has_l[p]:
                ck, ct, cn = A[p - 1][1], A[p - 1][2], A[p - 1][3]
            else:
                ck, ct, cn = -(1 << 30), 0, 0
            if k + 1 >= ck:
                ck, ct, cn = k + 1, t, tn
            if has_r[p] and A[p + 1][1] + 1 >= ck:
                ck, ct, cn = A[p + 1][1] + 1, A[p + 1][2], A[p + 1][3]
            out.append((vd, ck, ct, cn) if d + ck < ql and ck < vl
                       else None)
            if ck == vl:
                stage_add(vd)
        push(out)
        out = []
        for p, (vd, k, t, tn) in enumerate(A):
            vl = seq_len[vv(vd)]
            d = dd(vd)
            out.append((vd - 1, k + 1, t, tn) if not has_l[p]
                       and (d - 1) + (k + 1) < ql and k + 1 < vl else None)
            if not has_l[p] and k + 1 == vl:
                stage_add(vd - 1)
        push(out)
        out = []
        for p, (vd, k, t, tn) in enumerate(A):
            vl = seq_len[vv(vd)]
            d = dd(vd)
            out.append((vd + 1, k, t, tn) if not has_r[p]
                       and (d + 1) + k < ql and k < vl else None)
            if not has_r[p] and k == vl:
                stage_add(vd + 1)
        push(out)

        # hop waves: B = (vd, k, t, tn, act)
        B = [(vd, k, t, tn, b) for (vd, k, t, tn), b in zip(A, bnd)]
        hop = 0
        while any(b[4] for b in B) and hop < hopcap:
            P = []
            for vd, k, t, tn, act in B:
                v, d = vv(vd), dd(vd)
                vc = cv_(v)
                vlh = seq_len[vc]
                i = d + k
                P.append(dict(vd=vd, v=v, d=d, k=k, t=t, tn=tn, act=act,
                              vlh=vlh, cnt=arc_cnt[vc], i=i, vc=vc,
                              vend0=k == vlh - 1, qend0=i == ql - 1))
            for x in P:
                x["qend"] = x["act"] and x["qend0"]
                x["hit"] = x["qend"] and x["v"] == v1 and x["k"] == off1
            # (a) re-interior states: three passes from one ballot
            out, n_c, over = team_append_same(
                [x if x["act"] and not x["vend0"] and not x["qend0"]
                 else None for x in P], n_c, ccap, NT, 3)
            for slot, a, x in out:
                if slot < ccap:
                    C[slot] = (mk(x["v"], x["d"] + a - 1),
                               x["k"] + (1 if a < 2 else 0), x["t"],
                               x["tn"])
            if over:
                flags |= F_DCAP
            # (b) target at query end: the first hit in position order
            hits = [x for x in P if x["hit"]]
            if hits and not found:
                end_t, end_v, end_tn = hits[0]["t"], hits[0]["v"], \
                    hits[0]["tn"]
            found = found or bool(hits)
            for x in P:
                x["qd"] = (x["qend"] and not x["hit"]
                           and x["k"] + 1 < x["vlh"] and not found)
                x["vend"] = (x["act"] and x["vend0"] and not x["qend0"]
                             and not found)
                x["qv"] = (x["qend"] and not x["hit"] and not x["qd"]
                           and x["v"] != v1 and not found)
                x["tw"] = x["t"]
                if x["vend"]:
                    stage_add(x["vd"])
                if (x["vend"] or x["qv"]) and x["cnt"] > degcap:
                    flags |= F_DEG
            push([(mk(x["v"], x["d"] - 1), x["k"] + 1, x["t"], x["tn"])
                  if x["qd"] else None for x in P])
            # (c) trace pushes; past tcap a state's trace index is tcap - 1
            out, tr_n, over = team_append(
                [x if x["vend"] or x["qv"] else None for x in P], tr_n,
                tcap, NT)
            for slot, x in out:
                if slot < tcap:
                    tr_v[slot] = x["v"]
                    tr_pre[slot] = x["t"]
                    x["tw"] = slot
                else:
                    x["tw"] = tcap - 1
            if over:
                flags |= F_TCAP
            # (d) events of the first evcap vend states, degcap a state
            out, n_cv, over = team_append(
                [p if x["vend"] else None for p, x in enumerate(P)], 0,
                evcap, NT)
            if over:
                flags |= F_DCAP
            cvp = [p for slot, p in out if slot < evcap]
            for x in P:
                x["n_ext"] = 0
            evs = []      # (key, p, w, ow, m) in event index order
            for p in cvp:
                x = P[p]
                for ai in range(degcap):
                    if ai < x["cnt"]:
                        w = arc_w[x["vc"]][ai]
                        ow = arc_ow[x["vc"]][ai]
                        m = (x["i"] + 1 < ql and ow < seq_len[w]
                             and seq[seq_off[w] + ow] == q[x["i"] + 1])
                        x["n_ext"] += m
                        evs.append(((w << 32) | (x["i"] + 1), p, w, ow, m))
                    else:
                        evs.append((BIGK, p, 0, 0, False))
            srt = [e for _, e in team_sort(
                [(ev[0], e) for e, ev in enumerate(evs)], NT, (BIGK, IMAX))]
            act = [False] * len(evs)
            for jj, e in enumerate(srt):
                key = evs[e][0]
                if key != BIGK and (jj == 0 or evs[srt[jj - 1]][0] != key):
                    ps = bisect_left(vis, key)
                    act[e] = not (ps < len(vis) and vis[ps] == key)
            new_keys = [evs[e][0] for e in srt if act[e]]
            union = sorted(vis + new_keys)
            if len(union) > 2 * dcap:
                flags |= F_FCAP
            vis = union[:2 * dcap]
            # matching winners become the next wave, in event order
            out, _, over = team_append(
                [ev if act[e] and ev[4] else None
                 for e, ev in enumerate(evs)], 0, dcap, NT)
            if over:
                flags |= F_DCAP
            newB = [(mk(ev[2], P[ev[1]]["i"] + 1 - ev[3]), ev[3],
                     P[ev[1]]["tw"], P[ev[1]]["tn"])
                    for slot, ev in out if slot < dcap]
            # mismatching winners: two cross-vertex children, sorted order
            for ddd in (0, 1):
                items = []
                for e in srt:
                    ev = evs[e]
                    x = P[ev[1]]
                    ch_d = x["i"] + ddd - ev[3]
                    items.append((mk(ev[2], ch_d), ev[3], x["tw"], x["tn"])
                                 if act[e] and not ev[4]
                                 and ch_d + ev[3] < ql else None)
                push(items)
            push([(mk(x["v"], x["d"] + 1), x["k"], x["t"], x["tn"])
                  if x["vend"] and (x["cnt"] == 0
                                    or x["n_ext"] != min(x["cnt"], degcap))
                  else None for x in P])
            # (e) query end at a non-target vertex end: one child an arc
            for ai in range(degcap):
                push([(mk(arc_w[x["vc"]][ai], x["i"] - arc_ow[x["vc"]][ai]),
                       arc_ow[x["vc"]][ai], x["tw"], x["tn"])
                      if x["qv"] and ai < x["cnt"] else None for x in P])
            # next wave
            B = [(vd, extend(vd, k), t, tn, not found)
                 for vd, k, t, tn in newB]
            if hop + 1 >= hopcap and newB and not found:
                flags |= F_HOP
            hop += 1

        if nf_n > 4 * dcap and not found:
            flags |= F_FCAP
        srt = [v for v, _ in team_sort(
            [(v, i) for i, v in enumerate(stage)], NT, (BIGK, IMAX))]
        fs = set(forb)
        new = [x for i, x in enumerate(srt)
               if (i == 0 or x != srt[i - 1]) and x not in fs]
        union = sorted(forb + new)
        if len(union) > fcap and not found:
            flags |= F_FCAP
        forb = union[:fcap]
        nxt = []
        n_keep = 0
        if not found and flags == 0:
            fs = set(forb)
            out, _, _ = team_append(
                [j if C[j][0] not in fs else None for j in range(n_c)], 0,
                n_c, NT)
            nc = len(out)
            hcap = 1
            while 2 * hcap <= 4 * dcap:
                hcap *= 2
            if 0 < nc and 1 << (2 * nc - 1).bit_length() <= hcap:
                # the hash table: groups by vd, the winner the largest
                # (k, -position), the taint against the winner, then the
                # groups sorted by vd
                groups = {}
                for _, j in out:
                    groups.setdefault(C[j][0], []).append(j)
                for vd, _ in team_sort([(vd, i) for i, vd in
                                        enumerate(groups)], NT, (BIGK, IMAX)):
                    js = groups[vd]
                    w = max(js, key=lambda j: (C[j][1], -j))
                    taint = any(C[j][2] != C[w][2]
                                and (C[j][1] == C[w][1] or not had_a)
                                for j in js)
                    nxt.append((vd, C[w][1], C[w][2], C[w][3] | int(taint)))
                n_keep, over = min(len(nxt), dcap), len(nxt) > dcap
                nxt = nxt[:dcap]
            else:
                # the sort: (vd asc, k desc, position), run heads win
                cand = [(vd, -nk, C[j][2], C[j][3], j)
                        for vd, nk, j in bitonic_model(
                            [(C[j][0], -C[j][1], j) for _, j in out],
                            (BIGK, 1 << 31, IMAX), NT)]
                heads = [jj if jj == 0 or cand[jj][0] != cand[jj - 1][0]
                         else None for jj in range(len(cand))]
                out, n_keep, over = team_append(heads, 0, dcap, NT)
                for slot, jj in out:
                    if slot >= dcap:
                        continue
                    e = jj
                    while e < len(cand) and cand[e][0] == cand[jj][0]:
                        e += 1
                    runk, runt = cand[jj][1], cand[jj][2]
                    taint = any(c[2] != runt and (c[1] == runk or not had_a)
                                for c in cand[jj:e])
                    nxt.append((cand[jj][0], cand[jj][1], cand[jj][2],
                                cand[jj][3] | int(taint)))
            if over:
                flags |= F_DCAP
        A = nxt
        if not found and n_keep == 0:
            dead = True
        if not (found or dead) and flags == 0:
            s += 1
        if s > max_ed and not found:
            dead = True
        if s >= max_steps and s <= max_ed and not found and not dead \
                and flags == 0:
            flags |= F_STEPS

    if found and end_tn != 0:
        flags |= F_TIE
    wbuf = [-1] * wcap
    wn = 0
    if found and flags == 0:
        wbuf[0] = end_v
        wn = 1
        cur = end_t
        while True:
            pv = tr_v[min(max(cur, 0), tcap - 1)]
            if cur < 0 or pv < 0:
                break
            wbuf[min(wn, wcap - 1)] = pv
            cur = tr_pre[min(max(cur, 0), tcap - 1)]
            wn += 1
    if wn > wcap:
        flags |= F_TCAP
    walk = [wbuf[min(max(wn - 1 - j, 0), wcap - 1)] if j < wn else -1
            for j in range(wcap)]
    return (s if found else -1), flags, walk, wn


def model_matches(graph, jobs, qcap, degcap=6, **caps):
    g, es = graph[:2]
    gd, _ = gw.build_device_graph(g, es, degcap)
    args = gw.pack_jobs(jobs, qcap, 16 * ((len(jobs) + 15) // 16))
    want = gw.gwfa_batch_ref(gd, *args, degcap=degcap, **caps)
    G = tuple(x.tolist() for x in gd)
    q, ql, v0, o0, v1, o1, med = (x.tolist() for x in args)
    for j in range(len(ql)):
        s, flags, walk, n_walk = model_job(
            G, q[j], ql[j], v0[j], o0[j], v1[j], o1[j], med[j],
            degcap=degcap, **caps)
        assert (s, flags, n_walk) == (int(want["s"][j]),
                                      int(want["flags"][j]),
                                      int(want["n_walk"][j])), j
        assert walk == want["walk"][j].tolist(), j


@pytest.mark.parametrize("qcap", [256, 1024])
def test_kernel_model_matches_plain(graphs, qcap):
    model_matches(graphs["g"], make_jobs(graphs["g"], qcap + 1, qcap), qcap)


@pytest.mark.parametrize("caps", [c for c, _ in FLAG_CAPS]
                         + [dict(dcap=16, evcap=16, ccap=2048, tcap=40)],
                         ids=["deg_hop", "dcap_tcap", "fcap_steps", "tcap"])
def test_kernel_model_flag_caps(graphs, caps):
    model_matches(graphs["g"], make_jobs(graphs["g"], 31, 256), 256, **caps)


def test_kernel_model_high_degree(graphs):
    rng = np.random.default_rng(13)
    g, es = graphs["star"][:2]
    jobs = bridge_jobs(g, es, rng, 24, 8, 1024)[:16]
    model_matches(graphs["star"], jobs, 1024)
    model_matches(graphs["star"], jobs, 1024, degcap=8)
