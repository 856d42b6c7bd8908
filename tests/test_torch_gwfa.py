"""The GWFA bridge engine of the port (ops/gwfa.py) against the JAX
package's ops/gwfa_jax.py on the CPU: build_device_graph's arrays; the
plain gwfa_batch against the JAX gwfa_batch on all four outputs (s,
flags, walk, n_walk) for bridge-shaped jobs on a 300 kb bubble graph
(tools/synth.py bridge_jobs, the recipe of tests/test_device_gwfa.py) at
mutation rates 3, 8 and 25 in both query buckets, and at reduced caps
that make every capacity flag fire on both sides; unflagged jobs against
the exact host engine (align/gwfa_exact.py gwfa_ed); and a per-job model
of the CUDA kernel's schedule (csrc/gwfa.cu: one job at a time, ordered
appends with caps, total-order sorts that break ties by position,
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


def model_job(G, q, ql, v0, off0, v1, off1, max_ed, dcap=256, ccap=2048,
              tcap=512, fcap=512, wcap=64, degcap=6, hopcap=16, evcap=128,
              max_steps=256):
    """One job as csrc/gwfa.cu runs it (one block a job): the frontier,
    the hop waves and the candidates as lists in push order, ordered
    appends with caps, total-order sorts (ties broken by position),
    sorted-set merges cut at their caps, the walk on one thread."""
    arc_w, arc_ow, arc_cnt, seq_off, seq_len, seq = G
    n = len(arc_cnt)

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
        C = []
        stage = []
        nf_n = 0
        vis = []

        def push(items):
            nonlocal flags
            for it in items:
                if len(C) < ccap:
                    C.append(it)
                else:
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
            if d + ck < ql and ck < vl:
                out.append((vd, ck, ct, cn))
            if ck == vl:
                stage_add(vd)
        push(out)
        out = []
        for p, (vd, k, t, tn) in enumerate(A):
            vl = seq_len[vv(vd)]
            d = dd(vd)
            if not has_l[p]:
                if (d - 1) + (k + 1) < ql and k + 1 < vl:
                    out.append((vd - 1, k + 1, t, tn))
                if k + 1 == vl:
                    stage_add(vd - 1)
        push(out)
        out = []
        for p, (vd, k, t, tn) in enumerate(A):
            vl = seq_len[vv(vd)]
            d = dd(vd)
            if not has_r[p]:
                if (d + 1) + k < ql and k < vl:
                    out.append((vd + 1, k, t, tn))
                if k == vl:
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
            # (a) re-interior states
            for ddd, kk in ((-1, 1), (0, 1), (1, 0)):
                push([(mk(x["v"], x["d"] + ddd), x["k"] + kk, x["t"],
                       x["tn"]) for x in P
                      if x["act"] and not x["vend0"] and not x["qend0"]])
            # (b) target at query end: the first hit in position order
            for x in P:
                x["qend"] = x["act"] and x["qend0"]
                x["hit"] = x["qend"] and x["v"] == v1 and x["k"] == off1
            hits = [x for x in P if x["hit"]]
            if hits and not found:
                end_t, end_v, end_tn = hits[0]["t"], hits[0]["v"], \
                    hits[0]["tn"]
            found = found or bool(hits)
            for x in P:
                x["qd"] = (x["qend"] and not x["hit"]
                           and x["k"] + 1 < x["vlh"] and not found)
            push([(mk(x["v"], x["d"] - 1), x["k"] + 1, x["t"], x["tn"])
                  for x in P if x["qd"]])
            # (c) trace pushes, the forbidden stage, degree
            for x in P:
                x["vend"] = (x["act"] and x["vend0"] and not x["qend0"]
                             and not found)
                x["qv"] = (x["qend"] and not x["hit"] and not x["qd"]
                           and x["v"] != v1 and not found)
                x["tw"] = x["t"]
                if x["vend"] or x["qv"]:
                    if tr_n < tcap:
                        tr_v[tr_n] = x["v"]
                        tr_pre[tr_n] = x["t"]
                        x["tw"] = tr_n
                        tr_n += 1
                    else:
                        flags |= F_TCAP
                        x["tw"] = tcap - 1
                if x["vend"]:
                    stage_add(x["vd"])
                    if x["cnt"] > degcap:
                        flags |= F_DEG
            # (d) events of the first evcap vend states
            cvl = [p for p, x in enumerate(P) if x["vend"]]
            if len(cvl) > evcap:
                flags |= F_DCAP
            cvl = cvl[:evcap]
            for x in P:
                x["n_ext"] = 0
            evs = []      # (key, ord, p, ai, m)
            for p in cvl:
                x = P[p]
                for ai in range(min(x["cnt"], degcap)):
                    w = arc_w[x["vc"]][ai]
                    ow = arc_ow[x["vc"]][ai]
                    m = (x["i"] + 1 < ql and ow < seq_len[w]
                         and seq[seq_off[w] + ow] == q[x["i"] + 1])
                    x["n_ext"] += m
                    evs.append(((w << 32) | (x["i"] + 1), p * degcap + ai,
                                p, ai, m, w, ow))
            evs.sort(key=lambda e: (e[0], e[1]))
            heads = [j for j in range(len(evs))
                     if j == 0 or evs[j][0] != evs[j - 1][0]]
            act = {}
            for j in heads:
                key = evs[j][0]
                ps = bisect_left(vis, key)
                if not (ps < len(vis) and vis[ps] == key):
                    act[j] = True
            new_keys = [evs[j][0] for j in sorted(act)]
            union = sorted(vis + new_keys)
            if len(union) > 2 * dcap:
                flags |= F_FCAP
            vis = union[:2 * dcap]
            na = sorted((evs[j] for j in act if evs[j][4]),
                        key=lambda e: e[1])
            if len(na) > dcap:
                flags |= F_DCAP
            na = na[:dcap]
            newB = [(mk(e[5], P[e[2]]["i"] + 1 - e[6]), e[6],
                     P[e[2]]["tw"], P[e[2]]["tn"]) for e in na]
            for ddd in (0, 1):
                out = []
                for j in range(len(evs)):
                    if j in act and not evs[j][4]:
                        e = evs[j]
                        x = P[e[2]]
                        ch_d = x["i"] + ddd - e[6]
                        if ch_d + e[6] < ql:
                            out.append((mk(e[5], ch_d), e[6], x["tw"],
                                        x["tn"]))
                push(out)
            push([(mk(x["v"], x["d"] + 1), x["k"], x["t"], x["tn"])
                  for x in P if x["vend"] and (
                      x["cnt"] == 0
                      or x["n_ext"] != min(x["cnt"], degcap))])
            # (e) query end at a non-target vertex end: one child an arc
            for ai in range(degcap):
                out = []
                for x in P:
                    if x["qv"] and ai < x["cnt"]:
                        w = arc_w[x["vc"]][ai]
                        ow = arc_ow[x["vc"]][ai]
                        out.append((mk(w, x["i"] - ow), ow, x["tw"],
                                    x["tn"]))
                push(out)
            if any(x["qv"] and x["cnt"] > degcap for x in P):
                flags |= F_DEG
            # next wave
            B = [(vd, extend(vd, k), t, tn, not found)
                 for vd, k, t, tn in newB]
            if hop + 1 >= hopcap and newB and not found:
                flags |= F_HOP
            hop += 1

        if nf_n > 4 * dcap and not found:
            flags |= F_FCAP
        new = sorted(set(stage))
        fs = set(forb)
        union = sorted(forb + [x for x in new if x not in fs])
        if len(union) > fcap and not found:
            flags |= F_FCAP
        forb = union[:fcap]
        nxt = []
        n_keep = 0
        if not found and flags == 0:
            fs = set(forb)
            cand = [(c[0], c[1], c[2], c[3], j) for j, c in enumerate(C)
                    if c[0] not in fs]
            cand.sort(key=lambda c: (c[0], -c[1], c[4]))
            j = 0
            while j < len(cand):
                e = j
                while e < len(cand) and cand[e][0] == cand[j][0]:
                    e += 1
                runk, runt = cand[j][1], cand[j][2]
                taint = any(c[2] != runt and (c[1] == runk or not had_a)
                            for c in cand[j:e])
                nxt.append((cand[j][0], cand[j][1], cand[j][2],
                            cand[j][3] | int(taint)))
                j = e
            n_keep = len(nxt)
            if n_keep > dcap:
                flags |= F_DCAP
        A = nxt[:dcap]
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
