"""The device front's hand-off to the native tail
(minigraph_tpu_torch/mapping/device_front.py): the 64-bit words that
_pack_body builds on the device and gather_flat hands on as views,
held bit for bit against the former route, kept here as the oracle:
the former pack body (flat planes of half the padded size: the leaves
axh, axl, the packed ay word occ8|tandem1|span6|qpos17, the minimizer
positions and the chain records' score and count, every leaf cast to
int64 for one copy) and the former host unpack (`_unpack`'s numpy
words, `_unpack_ay`, and per read `_chunk_results` with
`derive_query_info`, from the padded planes where a batch overflowed
the flat ones).  The front's own `_pack_body` is wrapped to capture
each bucket batch's inputs, which the oracle packs and unpacks again.
Cases: the chained front with the flat join and with the hash join, the
seed-only front (asm: its chunks now go flat too), chained and
seed-only batches past the former flat caps (the former route's padded
refetch; the planes now hold the padded size) and a chunk whose reads
are all flagged.  Also on the CPU: the words on random planes that set
every bit they keep, and the staging pool, which lends a buffer to one
batch and takes it back only once every view of it is gone.  The card's
side (pinned staging, handles in flight) is in
tests/test_torch_cuda.py."""
from typing import List, Optional

import numpy as np
import pytest
import torch

from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping import device_front as dfm
from minigraph_tpu_torch.mapping.device_front import (META_Q_MASK, UCAP,
                                                      DeviceFront,
                                                      FrontResult)
from minigraph_tpu_torch.options import IndexOptions, MapOptions, opt_set
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa)
from minigraph_tpu_torch.utils import trace

torch.set_num_threads(1)

U64 = np.uint64


# ---- the oracle: the former pack body and host unpack -----------------
def old_pack_body(full, n_a, n_q, max_occ, B, acap, qcap):
    dev = n_a.device
    cap_flat = (B * acap) // 2
    cap_mini = (B * qcap * 3) // 4
    cap_u = B * 8
    I32 = torch.int32
    n_a = n_a.to(torch.int64)

    def excl(v):
        return torch.cumsum(v, 0) - v

    ar = torch.arange(acap, device=dev)[None, :]
    valid = ar < n_a[:, None]
    prefix = excl(n_a)
    idx = torch.where(valid, prefix[:, None] + ar, cap_flat).reshape(-1)

    def flat(v, cap, ix):
        out = torch.zeros(cap + 1, dtype=v.dtype, device=dev)
        out.scatter_(0, torch.clamp(ix, max=cap), v.reshape(-1))
        return out[:cap]

    ayh, ayl = full["ayh"], full["ayl"]
    ay_pk = ((ayh >> 24) << 24) | (((ayh >> 10) & 1) << 23) \
        | ((ayh & 0x3F) << 17) | (ayl & 0x1FFFF)
    q_meta = full["q_meta"]
    qr = torch.arange(qcap, device=dev)[None, :]
    q_ok = qr < n_q[:, None]
    rep = q_ok & (full["q_cnt"] >= max_occ)
    qpos = (q_meta >> 1) & META_Q_MASK
    span = (q_meta >> 26) & 0x1F
    en = torch.where(rep, qpos + 1, 0)
    run = torch.cummax(en, 1).values
    prev_en = torch.cat([torch.zeros((B, 1), dtype=run.dtype,
                                     device=dev), run[:, :-1]], 1)
    st = qpos + 1 - span
    contrib = torch.where(
        rep, torch.clamp((qpos + 1) - torch.maximum(st, prev_en),
                         min=0), 0)
    rep_len = contrib.sum(1)
    mini_sel = q_ok & ~rep
    n_mini = mini_sel.sum(1)
    mprefix = excl(n_mini)
    mrank = torch.cumsum(mini_sel.to(torch.int64), 1) - 1
    midx = torch.where(mini_sel, mprefix[:, None] + mrank,
                       cap_mini).reshape(-1)
    out = {"f_axh": flat(full["axh"], cap_flat, idx),
           "f_axl": flat(full["axl"], cap_flat, idx),
           "f_ay": flat(ay_pk, cap_flat, idx),
           "prefix": prefix, "rep_len": rep_len, "n_mini": n_mini,
           "mprefix": mprefix,
           "f_mini": flat(qpos.to(I32), cap_mini, midx),
           "flat_ovf": (n_a.sum() > cap_flat)
           | (n_mini.sum() > cap_mini)}
    if "n_u" in full:
        n_u = full["n_u"].to(torch.int64)
        ur = torch.arange(UCAP, device=dev)[None, :]
        uprefix = excl(n_u)
        uidx = torch.where(ur < n_u[:, None], uprefix[:, None] + ur,
                           cap_u).reshape(-1)
        out.update(u_sc=flat(full["u_pad_sc"], cap_u, uidx),
                   u_cnt=flat(full["u_pad_cnt"], cap_u, uidx),
                   n_u=n_u, uprefix=uprefix)
        out["flat_ovf"] = out["flat_ovf"] | (n_u.sum() > cap_u)
    return out


def old_fetch(head, full, args):
    """The former _pack's leaves as the former _fetch read them back:
    int64 words (bool leaves as bool), the padded planes on overflow."""
    head = dict(head)
    head.update(old_pack_body(full, head["n_a"], head["n_q"], *args))
    res = {}
    for key in sorted(head):
        v = head[key]
        h = v.reshape(-1).to(torch.int64).numpy().reshape(tuple(v.shape))
        res[key] = h.astype(bool) if v.dtype == torch.bool else h
    if res["flat_ovf"]:
        res.update({k: v.numpy() for k, v in full.items()})
    return res


def derive_query_info(q_cnt, q_meta, n_q, max_occ):
    cnts = q_cnt[:n_q].astype(np.int64)
    metas = q_meta[:n_q].astype(np.uint32)
    qpos = ((metas >> 1) & META_Q_MASK).astype(np.int64)
    span = ((metas >> 26) & 0x1F).astype(np.int64)
    rep = cnts >= max_occ
    mini_pos = qpos[~rep].astype(np.int32)
    rep_st = rep_en = 0
    rep_len = 0
    for en, sp in zip((qpos[rep] + 1).tolist(), span[rep].tolist()):
        st = en - sp
        if st > rep_en:
            rep_len += rep_en - rep_st
            rep_st, rep_en = st, en
        else:
            rep_en = en
    rep_len += rep_en - rep_st
    return rep_len, mini_pos


def _unpack_ay(pk):
    pk = pk.astype(U64)
    return ((pk >> U64(24)) << U64(56)) \
        | (((pk >> U64(23)) & U64(1)) << U64(42)) \
        | (((pk >> U64(17)) & U64(0x3F)) << U64(32)) \
        | (pk & U64(0x1FFFF))


class OldUnpack:
    """The former _unpack and _chunk_results, with their counters."""

    def __init__(self, chains, occ_max1):
        self.chains = chains
        self.occ_max1 = occ_max1
        self.n_device = self.n_fallback = self.n_chain_unsure = 0
        self.n_refetch = 0

    def unpack(self, chunk, res, flat, extra):
        self.n_refetch += bool(res["flat_ovf"])
        if res["flat_ovf"] or not self.chains:
            for ri, fr in zip(chunk, self.chunk_results(chunk, res)):
                extra[ri] = fr
            return
        nb = len(chunk)
        ovf = res["overflow"][:nb]
        sure = res["sure"][:nb]
        ok = ~ovf & sure
        self.n_fallback += int(ovf.sum())
        self.n_chain_unsure += int((~sure & ~ovf).sum())
        self.n_device += int(ok.sum())
        sel = np.nonzero(ok)[0]
        if not len(sel):
            return
        AX = (res["f_axh"].astype(U64) << U64(32)) \
            | res["f_axl"].astype(U64)
        U = (res["u_sc"].astype(U64) << U64(32)) \
            | (res["u_cnt"].astype(U64) & U64(0xFFFFFFFF))
        blob = {"AX": AX, "AY": _unpack_ay(res["f_ay"]), "U": U,
                "MINI": res["f_mini"].astype(np.int64)}
        for key in ("prefix", "n_a", "uprefix", "n_u", "mprefix",
                    "n_mini", "rep_len", "n_q"):
            blob[key] = res[key][sel]
        flat.append((np.asarray([chunk[b] for b in sel]), blob))

    def chunk_results(self, chunk, res):
        out: List[Optional[FrontResult]] = [None] * len(chunk)
        padded = bool(res["flat_ovf"])
        chains = self.chains
        if padded:
            AX = (res["axh"].astype(U64) << U64(32)) \
                | res["axl"].astype(U64)
            AH = res["ayh"].astype(U64)
            AY = ((AH >> U64(24)) << U64(56)) \
                | (((AH >> U64(10)) & U64(1)) << U64(42)) \
                | ((AH & U64(0x3FF)) << U64(32)) | res["ayl"].astype(U64)
            if chains:
                U = (res["u_pad_sc"].astype(U64) << U64(32)) \
                    | (res["u_pad_cnt"].astype(U64) & U64(0xFFFFFFFF))
        else:
            AX = (res["f_axh"].astype(U64) << U64(32)) \
                | res["f_axl"].astype(U64)
            AY = _unpack_ay(res["f_ay"])
            MINI = res["f_mini"].astype(np.int64)
            if chains:
                U = (res["u_sc"].astype(U64) << U64(32)) \
                    | (res["u_cnt"].astype(U64) & U64(0xFFFFFFFF))
        for bi in range(len(chunk)):
            if res["overflow"][bi]:
                self.n_fallback += 1
                continue
            if chains and not res["sure"][bi]:
                self.n_chain_unsure += 1
                continue
            n = int(res["n_a"][bi])
            n_q = int(res["n_q"][bi])
            if padded:
                ax, ay = AX[bi, :n], AY[bi, :n]
                rep_len, mini_pos = derive_query_info(
                    res["q_cnt"][bi], res["q_meta"][bi], n_q,
                    int(self.occ_max1))
                u = U[bi, : int(res["n_u"][bi])] if chains else None
            else:
                p0, m0 = int(res["prefix"][bi]), int(res["mprefix"][bi])
                ax, ay = AX[p0: p0 + n], AY[p0: p0 + n]
                rep_len = int(res["rep_len"][bi])
                mini_pos = MINI[m0: m0 + int(res["n_mini"][bi])]
                u = None
                if chains:
                    u0 = int(res["uprefix"][bi])
                    u = U[u0: u0 + int(res["n_u"][bi])]
            out[bi] = FrontResult(ax=ax, ay=ay, rep_len=rep_len,
                                  mini_pos=mini_pos, n_mv=n_q, u=u)
            self.n_device += 1
        return out


# ---- the cases --------------------------------------------------------
@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    d = tmp_path_factory.mktemp("gather")
    ref = make_reference(200_000, seed=201)
    hap = write_bubble_rgfa(ref, 202, str(d / "g.gfa"), seg_len=20_000)
    short = [s for _, s in simulate_reads([hap, ref], 40, seed=203,
                                          mean_len=700, min_len=200,
                                          max_len=1000)]
    long_ = [s for _, s in simulate_reads([hap, ref], 16, seed=204,
                                          mean_len=1950, min_len=1850,
                                          max_len=2048)]
    # reads with a 30 bp unit five times over (tandem minimizers, flagged
    # as duplicate x), a read of no minimizer hit and an empty one
    rng = np.random.default_rng(205)
    for st in rng.integers(0, len(ref) - 800, 6).tolist():
        s = ref[st: st + 700]
        short.append(s[:100] + s[:30] * 5 + s[100:])
    short += ["ACGT" * 20 + "TTGCA" * 30, ""]
    return str(d / "g.gfa"), short, long_


def per_read(flat, extra, n):
    """(ax, ay, mini_pos, rep_len, n_mv, u) a read, None where flagged."""
    out = [None] * n
    for ri, fr in extra.items():
        if fr is not None:
            out[ri] = (fr.ax, fr.ay, np.asarray(fr.mini_pos, np.int64),
                       fr.rep_len, fr.n_mv, fr.u)
    for pos, blob in flat:
        U = blob.get("U")
        for j, ri in enumerate(pos.tolist()):
            p0, na = int(blob["prefix"][j]), int(blob["n_a"][j])
            m0, nm = int(blob["mprefix"][j]), int(blob["n_mini"][j])
            u = None
            if U is not None:
                u0, nu = int(blob["uprefix"][j]), int(blob["n_u"][j])
                u = U[u0: u0 + nu]
            out[ri] = (blob["AX"][p0: p0 + na], blob["AY"][p0: p0 + na],
                       blob["MINI"][m0: m0 + nm], int(blob["rep_len"][j]),
                       int(blob["n_q"][j]), u)
    return out


def same_array(a, b, what):
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


# name: (preset or None, k, w, which reads, bucket, chain window, past
# the former flat caps).  The long reads overflow the 2048 bucket's
# former flat planes (a window of 256 leaves their chains sure); in the
# 4096 bucket they fit, and a window of 64 leaves every chain unsure:
# all flagged
CASES = {
    "chained_flat_join": (None, 17, 11, "short", (1024, 8), 64, False),
    "chained_hash_join": (None, 19, 10, "short", (1024, 8), 64, False),
    "seed_only_asm": ("asm", 19, 10, "short", (1024, 8), 64, False),
    "chained_past_flat_caps": (None, 17, 11, "long", (2048, 8), 256, True),
    "seed_only_past_flat_caps": ("asm", 19, 10, "long", (2048, 8), 256,
                                 True),
    "all_flagged": (None, 17, 11, "long", (4096, 8), 64, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gather_words_match_host_unpack(graph, case, monkeypatch):
    """Per bucket batch: every read's anchors, minimizer positions,
    rep_len, n_mv and chains equal the former route's, word for word
    and dtype for dtype (a seed-only chunk and a chunk past the former
    flat caps went per read there, flat here); where the former route
    delivered a chained chunk flat, the blob equals its blob (the planes
    up to the former cap, zeros after it); the counters agree; every
    chunk is handed on as views, with no copy on the host."""
    preset, k, w, which, bucket, win, past_caps = CASES[case]
    gfa, short, long_ = graph
    reads = short if which == "short" else long_
    io_, mo = IndexOptions(), MapOptions()
    if preset:
        opt_set(preset, io_, mo)
    gi = build_index(read_gfa(gfa), k, w, mo)
    front = DeviceFront(gi, mo, device="cpu", buckets=(bucket,),
                        chain_window=win)
    assert front.hashed == (k == 19)
    assert front.chain_enabled == (preset is None)
    captured = []
    real = front._pack_body

    def spy(full, n_a, n_q, overflow, sure, *args):
        head = {"n_a": n_a, "n_q": n_q, "overflow": overflow}
        if sure is not None:
            head["sure"] = sure
        captured.append((head, dict(full), args))
        return real(full, n_a, n_q, overflow, sure, *args)
    monkeypatch.setattr(front, "_pack_body", spy)

    before = trace.snapshot()["span_n"]
    handle = front.submit(reads)
    flat = front.gather_flat(handle)
    spans = trace.snapshot()["span_n"]
    chunks = [entry[0] for entry in handle[1]]
    assert len(chunks) == len(captured) == front.n_batches >= 2

    old = OldUnpack(front.chain_enabled, mo.occ_max1)
    want_flat, want_extra = [], {}
    for chunk, (head, full, args) in zip(chunks, captured):
        old.unpack(chunk, old_fetch(head, full, args), want_flat,
                   want_extra)

    assert (front.n_device, front.n_fallback, front.n_chain_unsure) == \
        (old.n_device, old.n_fallback, old.n_chain_unsure)
    assert spans.get("front.copy", 0) == before.get("front.copy", 0)
    assert (old.n_refetch > 0) == past_caps
    if case == "all_flagged":
        assert front.n_device == 0 and not flat and not want_flat
        assert front.n_chain_unsure == len(reads)
    else:
        assert front.n_device >= len(reads) // 3
        assert len(flat) == front.n_batches
    # chained chunks the former route delivered flat: blob against blob
    got_by = {tuple(p.tolist()): blob for p, blob in flat}
    for pos, want in want_flat:
        got = got_by[tuple(pos.tolist())]
        assert set(got) == set(want)
        for key, wv in want.items():
            gv = got[key]
            if key in ("AX", "AY", "U", "MINI"):
                assert not gv[len(wv):].any(), key
                gv = gv[: len(wv)]
            same_array(gv, wv, key)
    got_r = per_read(flat, {}, len(reads))
    want_r = per_read(want_flat, want_extra, len(reads))
    for i, (g, wnt) in enumerate(zip(got_r, want_r)):
        assert (g is None) == (wnt is None), i
        if g is None:
            continue
        for name, a, b in zip(("ax", "ay", "mini_pos"), g[:3], wnt[:3]):
            same_array(a, b, f"read {i} {name}")
        assert g[3:5] == wnt[3:5], i
        assert (g[5] is None) == (wnt[5] is None), i
        if g[5] is not None:
            same_array(g[5], wnt[5], f"read {i} u")
    # gather() builds its FrontResults from the same blobs
    again = front.gather(front.submit(reads))
    for i, (fr, wnt) in enumerate(zip(again, want_r)):
        assert (fr is None) == (wnt is None), i
        if fr is not None:
            np.testing.assert_array_equal(fr.ax, wnt[0])
            assert (fr.rep_len, fr.n_mv) == wnt[3:5]
            assert (fr.u is None) == (wnt[5] is None)


@pytest.mark.parametrize("chains", [True, False])
def test_pack_words_on_random_planes(chains):
    """The words of _pack_body against the former leaves widened on the
    host, on random planes that set every bit the words keep: ayh's occ
    byte (past 127 too), tandem bit and span, 32-bit axl and ayl,
    negative chain scores; the per-read vectors and flags; and a batch
    with every anchor slot live (past the former flat caps) fits."""
    g = torch.Generator().manual_seed(207 + chains)
    B, acap, qcap = 4, 64, 48

    def rnd(hi, shape, dtype=torch.int64):
        return torch.randint(0, hi, shape, generator=g).to(dtype)
    full = {"axh": rnd(1 << 31, (B, acap)), "axl": rnd(1 << 32, (B, acap)),
            "ayh": rnd(1 << 32, (B, acap)), "ayl": rnd(1 << 32, (B, acap)),
            "q_cnt": rnd(256, (B, qcap)), "q_meta": rnd(1 << 32, (B, qcap))}
    n_a = rnd(acap // 2 + 1, (B,), torch.int32)
    n_q = rnd(qcap // 2 + 1, (B,), torch.int32)
    overflow = rnd(2, (B,), torch.bool)
    sure = None
    if chains:
        full.update(u_pad_sc=rnd(1 << 32, (B, UCAP)).to(torch.int32),
                    u_pad_cnt=rnd(1 << 32, (B, UCAP)).to(torch.int32),
                    n_u=rnd(9, (B,), torch.int32))
        sure = rnd(2, (B,), torch.bool)
    head = {"n_a": n_a, "n_q": n_q, "overflow": overflow}
    if chains:
        head["sure"] = sure
    want = old_fetch(head, full, (40, B, acap, qcap))
    assert not want["flat_ovf"]
    for key in ("f_axh", "f_axl", "f_ay", "f_mini", "u_sc", "u_cnt"):
        if key in want:         # the former planes, padded to the new
            cap = {"f_mini": B * qcap, "u_sc": B * UCAP,
                   "u_cnt": B * UCAP}.get(key, B * acap)
            want[key] = np.concatenate(
                [want[key], np.zeros(cap - len(want[key]), np.int64)])
    buf, lay = DeviceFront._pack_body(full, n_a, n_q, overflow, sure, 40, B,
                                      acap, qcap)
    host = buf.numpy()
    got = {k: host[o: o + n] for k, (o, n) in lay.items()}
    same_array(got["AX"].view(U64),
               (want["f_axh"].astype(U64) << U64(32))
               | want["f_axl"].astype(U64), "AX")
    same_array(got["AY"].view(U64), _unpack_ay(want["f_ay"]), "AY")
    assert ((got["AY"].view(U64) >> U64(56)) >= 128).any()
    assert ((got["AY"].view(U64) >> U64(42)) & U64(1)).any()
    same_array(got["MINI"], want["f_mini"].astype(np.int64), "MINI")
    keys = ["prefix", "n_a", "mprefix", "n_mini", "rep_len", "n_q",
            "overflow"]
    if chains:
        same_array(got["U"].view(U64),
                   (want["u_sc"].astype(U64) << U64(32))
                   | (want["u_cnt"].astype(U64) & U64(0xFFFFFFFF)), "U")
        assert (want["u_sc"] < 0).any()
        keys += ["uprefix", "n_u", "sure"]
    assert set(got) == set(keys) | {"AX", "AY", "MINI"} \
        | ({"U"} if chains else set())
    for key in keys:
        np.testing.assert_array_equal(got[key], want[key].astype(np.int64),
                                      err_msg=key)
    # every anchor slot live: the planes hold them all, in read order
    full_n = torch.full((B,), acap, dtype=torch.int32)
    buf, lay = DeviceFront._pack_body(full, full_n, n_q, overflow, sure,
                                      40, B, acap, qcap)
    head["n_a"] = full_n
    assert old_fetch(head, full, (40, B, acap, qcap))["flat_ovf"]
    off, n = lay["AX"]
    same_array(buf.numpy()[off: off + n].view(U64),
               ((full["axh"] << 32) | full["axl"]).reshape(-1).numpy()
               .view(U64), "AX")
