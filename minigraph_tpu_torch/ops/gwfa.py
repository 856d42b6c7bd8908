"""Batched GWFA (graph wavefront edit distance) with its traceback walk:
the bridge engine of gchain materialization (bridge_gwfa,
gchain1.c:349-381; wavefront machinery gfa-ed.c:56-617).

Port of the JAX package's ops/gwfa_jax.py.  Its exact-or-flag contract
carries over unchanged: a job either ends bit-identical to the host
engine (align/gwfa_exact.py) or comes back with flag bits set and is
re-run on the host.  Scores are order-free (per-(vertex, diagonal)
dedup keeps the furthest offset); the per-step visited set replays the
host queue order (hop wave, frontier position, arc index); walk ties
that the host would break by queue order taint the state, and a job is
flagged F_TIE only when the winning state carries taint.  Capacity
overflows (frontier, candidates, trace, walk, visited and forbidden
tables, degree, hop chain, steps) set flags too.

State is (vd, k, t, taint): vd = v << 32 | (0x40000000 + d) as in
gwf_gen_vd (gfa-ed.c:60).

`gwfa_batch_ref` is the plain PyTorch version, the JAX while_loops step
for step over a batch of jobs.  Where the JAX program gathers out of
range it clamps the index, which PyTorch does not: every such gather
clamps here.  Its sorts are stable, where lax.sort is not: rows that tie
on every key are BIG pads or same-(vd, k) candidates, and between those
only tainted lineages differ (tests/test_torch_gwfa.py holds the two on
fuzzed jobs).  `gwfa_batch` runs it for CPU tensors and launches the
CUDA kernel (csrc/gwfa.cu, a block of 256 threads a job) for tensors on
the card.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..mapping.native_tail import _flat_graph

I32 = torch.int32
I64 = torch.int64

DIAG_SHIFT = 1 << 30
BIG = 0x7FFFFFFFFFFFFFFF
U32 = 0xFFFFFFFF

# flag bits (returned per job)
F_TIE = 1        # the winning walk's lineage hit a queue-order tie
F_DCAP = 2       # frontier / candidate overflow
F_TCAP = 4       # trace log or walk overflow
F_DEG = 8        # vertex out-degree above degcap
F_HOP = 16       # cross-vertex hop chain longer than hopcap
F_FCAP = 32      # forbidden-band / visited table overflow
F_STEPS = 128    # hit the static step cap before max_ed was exhausted

# the kernel's clock buffer, a row a job: cycles a phase, then its
# synchronisations, waves (steps plus hop waves) and steps, and the
# cycles of the dedup phase's grouping (its hash table or its sort)
CLK_COLUMNS = ("ext", "child", "event", "forb", "dedup", "walk", "syncs",
               "waves", "steps", "dedup_group")
CLK_PHASES = CLK_COLUMNS[:6]
CLK_N = len(CLK_COLUMNS)


class GwfaGraph(NamedTuple):
    """Flat graph view (mapping/native_tail.py _flat_graph re-packed
    with a degree-capped arc table), the JAX package's layout."""
    arc_w: torch.Tensor      # (n_vtx, degcap) i32 target vertex
    arc_ow: torch.Tensor     # (n_vtx, degcap) i32 overlap on target
    arc_cnt: torch.Tensor    # (n_vtx,) i32
    seq_off: torch.Tensor    # (n_vtx,) i32 into seq blob
    seq_len: torch.Tensor    # (n_vtx,) i32
    seq: torch.Tensor        # (blob + 1,) i32 char codes; [-1] = -1 pad

    def to(self, device) -> "GwfaGraph":
        return GwfaGraph(*(x.to(device) for x in self))


def build_device_graph(g, es, degcap: int = 6, device="cpu"):
    """Pack the graph for the kernel.  Returns (GwfaGraph, max_degree)."""
    arc_start, arc_cnt, arc_w, arc_ow, seq_off, seq_len, seq_buf = \
        _flat_graph(g, es)
    n_vtx = len(arc_cnt)
    aw = np.zeros((n_vtx, degcap), dtype=np.int32)
    ao = np.zeros((n_vtx, degcap), dtype=np.int32)
    for v in range(n_vtx):
        c = min(int(arc_cnt[v]), degcap)
        st = int(arc_start[v])
        aw[v, :c] = arc_w[st: st + c].astype(np.int32)
        ao[v, :c] = arc_ow[st: st + c]
    seq = np.frombuffer(seq_buf, dtype=np.uint8).astype(np.int32)
    seq = np.concatenate([seq, np.full(1, -1, dtype=np.int32)])
    arrs = (aw, ao, arc_cnt.astype(np.int32), seq_off.astype(np.int32),
            seq_len.astype(np.int32), seq)
    gd = GwfaGraph(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in arrs))
    return gd, int(arc_cnt.max()) if n_vtx else 0


def pack_jobs(jobs, qcap: int, J: Optional[int] = None, device="cpu"):
    """(q, ql, v0, off0, v1, off1, max_ed) tensors of the kernel from
    jobs (query bytes, v0, off0, v1, off1, max_ed), padded to J rows
    (default len(jobs)) with one-base jobs at vertex 0 that change no
    real job's result.  The seven are views of one int32 buffer (the
    (J, qcap) queries, then the six job fields of J each), filled on the
    host, in pinned memory for a card, and moved in one copy."""
    J = len(jobs) if J is None else J
    dev = torch.device(device)
    host = torch.empty(J * (qcap + 6), dtype=I32,
                       pin_memory=dev.type == "cuda")
    a = host.numpy()
    q = a[: J * qcap].reshape(J, qcap)
    cols = a[J * qcap:].reshape(6, J)
    q.fill(-1)
    cols.fill(0)
    cols[0] = 1
    for i, (qb, v0, off0, v1, off1, max_ed) in enumerate(jobs):
        if len(qb) > qcap:
            raise ValueError(f"job {i}: query of {len(qb)} > qcap {qcap}")
        q[i, : len(qb)] = np.frombuffer(qb, dtype=np.uint8)
        cols[:, i] = (len(qb), v0, off0, v1, off1, max_ed)
    buf = host.to(dev, non_blocking=True)
    return (buf[: J * qcap].view(J, qcap),
            *buf[J * qcap:].view(6, J).unbind(0))


def out_views(flat, J: int, wcap: int):
    """The kernel's four outputs as views of its one int32 buffer of J *
    (3 + wcap): s, flags and n_walk (J each), then the (J, wcap) walks."""
    return {"s": flat[:J], "flags": flat[J: 2 * J],
            "n_walk": flat[2 * J: 3 * J], "walk": flat[3 * J:].view(J, wcap)}


# ----------------------------------------------------------------------
# helpers


def _mk_vd(v, d):
    # JAX: (v << 32) | u32(DIAG_SHIFT + u32(d)): the u32 sum wraps and is
    # zero-extended; int64 has no u32, so mask
    return (v.to(I64) << 32) | ((DIAG_SHIFT + d.to(I64)) & U32)


def _vd_v(vd):
    return (vd >> 32).to(I32)


def _vd_d(vd):
    low = vd & U32                              # the u32 diagonal word
    low = torch.where(low >= (1 << 31), low - (1 << 32), low)
    return (low - DIAG_SHIFT).to(I32)


def _take(x, idx):
    """x[idx] with idx clamped to [0, len - 1], as a JAX gather does."""
    return x[idx.clamp(0, x.shape[0] - 1).long()]


def _extend_runs(gd: GwfaGraph, q, ql, vd, k, valid, chunk: int = 16,
                 counts=None):
    """Landau-Vishkin exact-match extension along each state's diagonal
    (gwf_extend1, gfa-ed.c:84-96), all states in parallel."""
    v = _vd_v(vd)
    d = _vd_d(vd)
    vl = _take(gd.seq_len, v)
    base = _take(gd.seq_off, v)
    max_k = torch.minimum(ql[:, None] - d, vl) - 1
    seq_pad = gd.seq.shape[0] - 1
    offs = torch.arange(chunk, dtype=I32, device=q.device)
    Q = q.shape[-1]
    k_cur = k.clone()
    active = valid & (k < max_k)
    while bool(active.any()):
        pos = k_cur[..., None] + 1 + offs
        inb = pos <= max_k[..., None]
        tpos = torch.where(inb, base[..., None] + pos, seq_pad)
        tc = _take(gd.seq, tpos)
        qpos = (d[..., None] + pos).clamp(0, Q - 1).long()
        qc = torch.gather(q, 1, qpos.reshape(q.shape[0], -1)).reshape(
            qpos.shape)
        eq = inb & (tc == qc) & (tc >= 0)
        run = torch.cumprod(eq.to(I32), dim=-1).sum(-1).to(I32)
        if counts is not None:
            # the compares a state-at-a-time extension makes: the matches
            # and the mismatch that ends them, within the diagonal
            cmp = torch.minimum(run + 1, inb.sum(-1).to(I32))
            counts["ext"] = counts.get("ext", 0) + int(cmp[active].sum())
        k_cur = torch.where(active, k_cur + run, k_cur)
        active = active & (run == chunk)
    return k_cur


def _sorted_member(tab, x):
    """Per-row membership of x in the sorted, BIG-padded table tab."""
    pos = torch.searchsorted(tab, x.contiguous(), side="left")
    return torch.gather(tab, 1, pos.clamp(max=tab.shape[-1] - 1)) == x


def _sorted_insert(tab, new, new_valid):
    """Sorted-unique union of tab and the valid entries of new, cut to
    tab's width; and whether anything was cut."""
    cat = torch.cat([tab, torch.where(new_valid, new, BIG)], dim=-1)
    cat = torch.sort(cat, dim=-1).values
    dup = torch.zeros_like(cat, dtype=torch.bool)
    dup[..., 1:] = cat[..., 1:] == cat[..., :-1]
    cat = torch.sort(torch.where(dup, BIG, cat), dim=-1).values
    n = tab.shape[-1]
    return cat[..., :n].contiguous(), (cat[..., n:] != BIG).any(-1)


def _lexsort(keys):
    """Stable permutation ordering the rows of each key tensor (last
    dimension) lexicographically by keys[0], keys[1], ..."""
    perm = None
    for key in reversed(keys):
        kk = key if perm is None else torch.gather(key, -1, perm)
        p = torch.sort(kk, dim=-1, stable=True).indices
        perm = p if perm is None else torch.gather(perm, -1, p)
    return perm


def _bits(cond, bit):
    return torch.where(cond, bit, 0).to(I32)


# ----------------------------------------------------------------------
# the plain version


def gwfa_batch_ref(gd: GwfaGraph, q, ql, v0, off0, v1, off1, max_ed,
                   dcap=256, ccap=2048, tcap=512, fcap=512, wcap=64,
                   degcap=6, hopcap=16, evcap=128, max_steps=256,
                   counts: Optional[dict] = None):
    """Run GWFA for a batch of bridge jobs (the JAX gwfa_batch).

    q: (J, QCAP) i32 query codes (latin-1 bytes), -1 padded.
    ql, v0, off0, v1, off1, max_ed: (J,) i32.

    Returns a dict of (J,) i32 `s` (edit distance, -1 when not found
    within max_ed), `flags` (0 = exact, else F_* bits), `n_walk` and
    (J, wcap) i32 `walk` (the vertex walk in host order).  `counts`,
    when given, receives the work a job-at-a-time schedule does:
    "states", the states of live jobs summed over steps and hop waves,
    and "ext", the graph bases extension compares."""
    if dcap < evcap:
        raise ValueError("dcap must be >= evcap (as in the JAX kernel)")
    dev = q.device
    J = q.shape[0]
    rows = torch.arange(J, device=dev)[:, None]
    ql = ql.to(I32)
    ql_b = ql[:, None]
    v1b = v1.to(I32)[:, None]
    off1b = off1.to(I32)[:, None]
    max_ed = max_ed.to(I32)
    n_vtx = gd.arc_cnt.shape[0]

    def full(shape, val, dt=I32):
        return torch.full(shape, val, dtype=dt, device=dev)

    # trace log: slot 0 is the root (v=-1, pre=-1)
    tr_v = full((J, tcap + 1), -1)
    tr_pre = full((J, tcap + 1), -1)
    tr_n = full((J,), 1)

    # initial frontier (gfa_ed_init, gfa-ed.c:552-560)
    a_vd = full((J, dcap), BIG, I64)
    a_k = full((J, dcap), 0)
    a_t = full((J, dcap), 0)
    a_tn = full((J, dcap), 0)
    a_vd[:, 0] = _mk_vd(v0.to(I32), -off0.to(I32))
    a_k[:, 0] = off0.to(I32) - 1
    forb = full((J, fcap), BIG, I64)

    s = full((J,), 0)
    flags = full((J,), 0)
    found = torch.zeros(J, dtype=torch.bool, device=dev)
    dead = torch.zeros(J, dtype=torch.bool, device=dev)
    end_t = full((J,), -1)
    end_v = full((J,), -1)
    end_tn = full((J,), 0)

    st = {}     # per-step buffers, shared with the helpers below

    def push_cand(vd, k, t, tn, valid):
        """Append valid candidates compacted after slot n_c; dropped
        writes land in the +1 pad slot; overflow flags the row."""
        nonlocal flags
        vd, k, t, tn = (torch.broadcast_to(x, valid.shape)
                        for x in (vd, k, t, tn))
        slot = st["n_c"][:, None] + torch.cumsum(valid.to(I32), -1) - 1
        ok = valid & (slot < ccap)
        sl = torch.where(ok, slot, ccap).long()
        st["c_vd"].scatter_(1, sl, torch.where(ok, vd, BIG))
        st["c_k"].scatter_(1, sl, k.to(I32))
        st["c_t"].scatter_(1, sl, t.to(I32))
        st["c_n"].scatter_(1, sl, tn.to(I32))
        st["n_c"] = torch.clamp(st["n_c"] + valid.sum(-1).to(I32),
                                max=ccap).to(I32)
        flags = flags | _bits((valid & (slot >= ccap)).any(-1), F_DCAP)

    def forb_stage(vd, valid):
        """Stage finished vertex-diagonals with a rolling sorted
        truncation; nf_n counts all staged, so a cut is detectable."""
        cat = torch.cat([st["new_forb"], torch.where(valid, vd, BIG)], -1)
        st["new_forb"] = torch.sort(cat, dim=-1).values[..., :4 * dcap]
        st["nf_n"] = st["nf_n"] + valid.sum(-1).to(I32)

    def shift_r(x, fill):        # x[i - 1], fill at 0
        return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]],
                         -1)

    def shift_l(x, fill):        # x[i + 1], fill at the end
        return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)],
                         -1)

    def wavefront_children(vd, k, t, tn, valid, vl):
        """The host's in-run merge: per run of consecutive diagonals the
        child at diagonal e is max(k[e-1], k[e]+1, k[e+1]+1), merged
        before the bound filter (gwf_ed_extend_batch, gfa-ed.c:332-402),
        ties preferring parent e+1, then e, then e-1; plus one edge
        child on each side of the run."""
        d = _vd_d(vd)
        neg = -(1 << 30)
        vd_l, k_l, t_l, n_l = (shift_r(x, f) for x, f in
                               ((vd, BIG), (k, 0), (t, 0), (tn, 0)))
        va_l = shift_r(valid, False)
        has_l = valid & va_l & (vd == vd_l + 1)
        vd_r, k_r, t_r, n_r = (shift_l(x, f) for x, f in
                               ((vd, BIG), (k, 0), (t, 0), (tn, 0)))
        va_r = shift_l(valid, False)
        has_r = valid & va_r & (vd_r == vd + 1)
        cur_k = torch.where(has_l, k_l, neg)
        cur_t = torch.where(has_l, t_l, 0)
        cur_n = torch.where(has_l, n_l, 0)
        up = (k + 1) >= cur_k
        cur_k = torch.where(up, k + 1, cur_k)
        cur_t = torch.where(up, t, cur_t)
        cur_n = torch.where(up, tn, cur_n)
        up = has_r & ((k_r + 1) >= cur_k)
        cur_k = torch.where(up, k_r + 1, cur_k)
        cur_t = torch.where(up, t_r, cur_t)
        cur_n = torch.where(up, n_r, cur_n)
        ok = valid & (d + cur_k < ql_b) & (cur_k < vl)
        push_cand(vd, cur_k, cur_t, cur_n, ok)
        forb_stage(vd, valid & (cur_k == vl))
        okl = valid & ~has_l
        push_cand(vd - 1, k + 1, t, tn,
                  okl & ((d - 1) + (k + 1) < ql_b) & (k + 1 < vl))
        forb_stage(vd - 1, okl & (k + 1 == vl))
        okr = valid & ~has_r
        push_cand(vd + 1, k, t, tn, okr & ((d + 1) + k < ql_b) & (k < vl))
        forb_stage(vd + 1, okr & (k == vl))

    ecap = evcap * degcap
    col_d = torch.arange(dcap, dtype=I32, device=dev)
    while True:
        live = ~(found | dead) & (flags == 0)
        if not bool(live.any()):
            break
        st["c_vd"] = full((J, ccap + 1), BIG, I64)
        st["c_k"] = full((J, ccap + 1), 0)
        st["c_t"] = full((J, ccap + 1), 0)
        st["c_n"] = full((J, ccap + 1), 0)
        st["n_c"] = full((J,), 0)
        # staged forbidden vds: width 4 dcap bounds one step's worth
        st["new_forb"] = full((J, 4 * dcap), BIG, I64)
        st["nf_n"] = full((J,), 0)
        # per-step visited (vertex, qpos) keys (buf.ha)
        vis = full((J, 2 * dcap), BIG, I64)

        # ---- batch-extension phase over the whole frontier
        valid = (a_vd != BIG) & live[:, None]
        if counts is not None:
            counts["states"] = counts.get("states", 0) + int(valid.sum())
        k_ext = _extend_runs(gd, q, ql, a_vd, a_k, valid, counts=counts)
        v = _vd_v(a_vd)
        d = _vd_d(a_vd)
        vl = _take(gd.seq_len, v)
        i = d + k_ext
        boundary = valid & ((k_ext == vl - 1) | (i == ql_b - 1))
        # wavefront children for every state (boundary ones included:
        # the A queue holds copies, their in-run children still count)
        wavefront_children(a_vd, k_ext, a_t, a_tn, valid, vl)

        # ---- queue phase: boundary states wave by wave (the A queue)
        b_vd, b_k, b_t, b_tn, b_act = a_vd, k_ext, a_t, a_tn, boundary
        hop = 0
        while bool(b_act.any()) and hop < hopcap:
            v = _vd_v(b_vd)
            d = _vd_d(b_vd)
            vlh = _take(gd.seq_len, v)
            cnt_v = _take(gd.arc_cnt, v)   # JAX reads arc_cnt[v] unclipped
            i = d + b_k
            at_vend = b_k == vlh - 1
            at_qend = i == ql_b - 1

            # (a) re-interior states (fresh cross-vertex arrivals whose
            # extension left them mid-vertex): 3 children, no run
            inter = b_act & ~at_vend & ~at_qend
            for dd, kk in ((-1, 1), (0, 1), (1, 0)):
                push_cand(_mk_vd(v, d + dd), b_k + kk, b_t, b_tn, inter)

            # (b) target check at query end: the first hit in queue
            # order (the plane order) wins
            qend = b_act & at_qend
            hit = qend & (v == v1b) & (b_k == off1b)
            anyhit = hit.any(-1)
            first = hit.to(torch.uint8).argmax(-1)[:, None]
            now = anyhit & ~found
            end_t = torch.where(now, torch.gather(b_t, 1, first)[:, 0], end_t)
            end_v = torch.where(now, torch.gather(v, 1, first)[:, 0], end_v)
            end_tn = torch.where(now, torch.gather(b_tn, 1, first)[:, 0],
                                 end_tn)
            found = found | anyhit
            nf = ~found[:, None]
            # query end, vertex unfinished, not the target: deletion
            qd = qend & ~hit & (b_k + 1 < vlh) & nf
            push_cand(_mk_vd(v, d - 1), b_k + 1, b_t, b_tn, qd)

            # (c) expansion trace pushes: one per expanding state
            vend = b_act & at_vend & ~at_qend & nf
            qv = qend & ~hit & ~qd & (v != v1b) & nf
            exp = vend | qv
            slot = tr_n[:, None] + torch.cumsum(exp.to(I32), -1) - 1
            sok = exp & (slot < tcap)
            flags = flags | _bits((exp & (slot >= tcap)).any(-1), F_TCAP)
            sl = torch.where(sok, slot, tcap)
            tr_v.scatter_(1, sl.long(), v)
            tr_pre.scatter_(1, sl.long(), b_t)
            tr_n = torch.clamp(tr_n + exp.sum(-1).to(I32), max=tcap).to(I32)
            tw = torch.where(exp, torch.clamp(sl, max=tcap - 1), b_t)

            # finished vertex-diagonal -> forbidden band
            forb_stage(b_vd, vend)
            flags = flags | _bits((vend & (cnt_v > degcap)).any(-1), F_DEG)

            # (d) arc events with the per-step visited set (buf.ha): the
            # first (hop, frontier position, arc) event per (w, i+1) key
            # acts, later ones are dropped -- host queue order
            vord = torch.sort(torch.where(vend, col_d, 1 << 30), dim=-1,
                              stable=True).indices[..., :evcap]
            cvend = torch.gather(vend, 1, vord)
            flags = flags | _bits(vend.sum(-1) > evcap, F_DCAP)
            cv = torch.gather(v, 1, vord)
            ci = torch.gather(i, 1, vord)
            ctw = torch.gather(tw, 1, vord)
            ctn = torch.gather(b_tn, 1, vord)
            ccol = vord.to(I32)
            cvc = cv.clamp(0, n_vtx - 1).long()
            cnt_c = gd.arc_cnt[cvc]
            qch = torch.gather(q, 1, (ci + 1).clamp(0, q.shape[-1] - 1).long())
            ev = {n: full((J, evcap, degcap), 0) for n in
                  ("ord", "w", "ow", "i", "t", "n", "m")}
            ev_key = full((J, evcap, degcap), BIG, I64)
            n_ext = full((J, evcap), 0)
            for ai in range(degcap):
                w = gd.arc_w[cvc, ai]
                ow = gd.arc_ow[cvc, ai]
                has = cvend & (ai < cnt_c)
                wl = _take(gd.seq_len, w)
                wch = _take(gd.seq, _take(gd.seq_off, w) + ow)
                m = has & (ci + 1 < ql_b) & (ow < wl) & (wch == qch)
                n_ext = n_ext + m.to(I32)
                ev_key[..., ai] = torch.where(
                    has, (w.to(I64) << 32) | (ci + 1).to(I64), BIG)
                ev["ord"][..., ai] = ccol * degcap + ai
                ev["w"][..., ai] = w
                ev["ow"][..., ai] = ow
                ev["i"][..., ai] = ci
                ev["t"][..., ai] = ctw
                ev["n"][..., ai] = ctn
                ev["m"][..., ai] = m.to(I32)
            ev_key = ev_key.reshape(J, ecap)
            ev = {n: x.reshape(J, ecap) for n, x in ev.items()}
            # sort events by (key, order); winner = head not visited
            perm = _lexsort([ev_key, ev["ord"]])
            ek = torch.gather(ev_key, 1, perm)
            eo, ew, eow, ei, et, en, em = (
                torch.gather(ev[n], 1, perm)
                for n in ("ord", "w", "ow", "i", "t", "n", "m"))
            ehead = torch.ones_like(ek, dtype=torch.bool)
            ehead[:, 1:] = ek[:, 1:] != ek[:, :-1]
            ehead = ehead & (ek != BIG)
            seen = _sorted_member(vis, ek)
            act = ehead & ~seen
            vis, vovf = _sorted_insert(vis, ek, ehead)
            flags = flags | _bits(vovf, F_FCAP)
            # matching winners become next-wave queue states; more than
            # dcap winners in one wave would drop match chains: flag
            na_sel = act & (em == 1)
            flags = flags | _bits(na_sel.sum(-1) > dcap, F_DCAP)
            # ordered by host queue order (event order)
            nord = torch.sort(torch.where(na_sel, eo, 1 << 30), dim=-1,
                              stable=True).indices[..., :dcap]
            na_take = torch.gather(na_sel, 1, nord)
            na_w, na_ow, na_i, na_t, na_n = (
                torch.gather(x, 1, nord) for x in (ew, eow, ei, et, en))
            na_vd = torch.where(na_take, _mk_vd(na_w, na_i + 1 - na_ow), BIG)
            na_k = torch.where(na_take, na_ow, 0)
            # mismatching winners push the two cross-vertex children
            mm = act & (em == 0)
            for dd in (0, 1):
                ch_d = ei + dd - eow
                push_cand(_mk_vd(ew, ch_d), eow, et, en,
                          mm & (ch_d + eow < ql_b))
            # residual child (v, d+1, k) when not every arc matched;
            # n_ext lives in compacted space, scatter it back
            n_ext_full = full((J, dcap + 1), 0)
            n_ext_full.scatter_(1, torch.where(cvend, ccol, dcap).long(),
                                n_ext)
            n_ext_b = n_ext_full[..., :dcap]
            res = vend & ((cnt_v == 0)
                          | (n_ext_b != torch.clamp(cnt_v, max=degcap)))
            push_cand(_mk_vd(v, d + 1), b_k, b_t, b_tn, res)

            # (e) query end at a non-target vertex end: one child an arc,
            # NOT visited-checked (gfa-ed.c:351-357)
            vc = v.clamp(0, n_vtx - 1).long()
            for ai in range(degcap):
                w = gd.arc_w[vc, ai]
                ow = gd.arc_ow[vc, ai]
                has = qv & (ai < cnt_v)
                push_cand(_mk_vd(w, i - ow), ow, tw, b_tn, has)
            flags = flags | _bits((qv & (cnt_v > degcap)).any(-1), F_DEG)

            # next wave: extend the fresh arrivals
            na_valid = (na_vd != BIG) & ~found[:, None]
            if counts is not None:
                counts["states"] += int(na_valid.sum())
            na_k2 = _extend_runs(gd, q, ql, na_vd, na_k, na_valid,
                                 counts=counts)
            flags = flags | _bits((hop + 1 >= hopcap) & na_valid.any(-1),
                                  F_HOP)
            b_vd, b_k, b_t, b_tn, b_act = na_vd, na_k2, na_t, na_n, na_valid
            hop += 1

        flags = flags | _bits((st["nf_n"] > 4 * dcap) & ~found, F_FCAP)

        # ---- dedup + forbidden filter -> next frontier
        c_vd, c_k, c_t, c_n = (st[n][..., :ccap]
                               for n in ("c_vd", "c_k", "c_t", "c_n"))
        nfb = st["new_forb"]
        forb, fovf = _sorted_insert(forb, nfb, nfb != BIG)
        flags = flags | _bits(fovf & ~found, F_FCAP)
        cand = (c_vd != BIG) & ~found[:, None] & (flags == 0)[:, None]
        cand = cand & ~_sorted_member(forb, c_vd)
        # lexicographic (vd asc, k desc): the winner is the run head
        key1 = torch.where(cand, c_vd, BIG)
        key2 = torch.where(cand, -c_k.to(I64), BIG)
        perm = _lexsort([key1, key2])
        vd_s = torch.gather(key1, 1, perm)
        k_s, t_s, n_s = (torch.gather(x, 1, perm) for x in (c_k, c_t, c_n))
        va_s = torch.gather(cand, 1, perm)
        head = torch.ones_like(va_s)
        head[:, 1:] = vd_s[:, 1:] != vd_s[:, :-1]
        head = head & va_s
        idx = torch.arange(ccap, dtype=I64, device=dev)
        head_idx = torch.cummax(torch.where(head, idx, -1), dim=-1).values
        head_idx = head_idx.clamp(min=0)
        runk = torch.gather(k_s, 1, head_idx)
        runt = torch.gather(t_s, 1, head_idx)
        # a same-(vd, k) duplicate with a different trace means the host
        # queue order picks the surviving lineage: taint.  The host only
        # dedups on steps whose A queue was non-empty
        # (align/gwfa_exact.py); on other steps a dominated duplicate
        # survives there and can equalize via extension next step, so
        # without boundary states any dropped different-trace duplicate
        # taints the run (conservative)
        had_a = boundary.any(-1)[:, None]
        tie = va_s & (t_s != runt) & ((k_s == runk) | ~had_a)
        tie_run = full((J, ccap + 1), 0)
        tie_run.scatter_reduce_(1, torch.where(tie, head_idx, ccap),
                                torch.ones_like(k_s), reduce="amax")
        n_s = n_s | torch.gather(tie_run[..., :ccap], 1, head_idx)
        n_keep = head.sum(-1).to(I32)
        flags = flags | _bits((n_keep > dcap) & ~found, F_DCAP)
        hvd = torch.where(head, vd_s, BIG)
        ord2 = torch.sort(hvd, dim=-1, stable=True).indices[..., :dcap]
        a_vd = torch.gather(hvd, 1, ord2)
        a_k, a_t, a_tn = (torch.gather(x, 1, ord2) for x in (k_s, t_s, n_s))

        dead = dead | (~found & (n_keep == 0))
        s = torch.where(~(found | dead) & (flags == 0), s + 1, s)
        dead = dead | ((s > max_ed) & ~found)
        flags = flags | _bits((s >= max_steps) & (s <= max_ed) & ~found
                              & ~dead & (flags == 0), F_STEPS)

    # the winner's lineage carried a queue-order tie: host re-run
    flags = flags | _bits(found & (end_tn != 0), F_TIE)

    # ---- walk reconstruction (gfa_ed_step traceback)
    okw = found & (flags == 0)
    wbuf = full((J, wcap + 1), -1)
    wbuf[:, 0] = torch.where(okw, end_v, -1)
    wn = okw.to(I32)
    cur = torch.where(okw, end_t, -1)
    act = okw
    jj = torch.arange(J, device=dev)
    while bool(act.any()):
        cc = cur.clamp(0, tcap - 1).long()
        pv = tr_v[jj, cc]
        take = act & (cur >= 0) & (pv >= 0)
        wbuf[jj, torch.where(take, torch.clamp(wn, max=wcap - 1),
                             wcap).long()] = pv
        cur = torch.where(take, tr_pre[jj, cc], cur)
        wn = wn + take.to(I32)
        act = take
    flags = flags | _bits(wn > wcap, F_TCAP)
    idxw = torch.arange(wcap, dtype=I32, device=dev)[None, :]
    rev = (wn[:, None] - 1 - idxw).clamp(0, wcap - 1).long()
    walk = torch.where(idxw < wn[:, None], torch.gather(wbuf, 1, rev), -1)
    return {"s": torch.where(found, s, -1).to(I32), "flags": flags.to(I32),
            "walk": walk.to(I32), "n_walk": wn.to(I32)}


# ----------------------------------------------------------------------
# the kernel

def gwfa_batch(gd: GwfaGraph, q, ql, v0, off0, v1, off1, max_ed,
               dcap=256, ccap=2048, tcap=512, fcap=512, wcap=64, degcap=6,
               hopcap=16, evcap=128, max_steps=256, timing=None,
               clock=None):
    """GWFA for a batch of bridge jobs: the plain version for CPU
    tensors, the `gwfa` kernel (`gwfa_launch`) for tensors on the card.
    Returns the dict of `gwfa_batch_ref`; on the card its tensors are
    `out_views` of the kernel's one output buffer.

    `timing`, a list, receives the time of the launch alone: the pair of
    CUDA events of `gwfa_launch` on the card, the host milliseconds of
    the plain version on the CPU.  An empty batch launches nothing and
    appends nothing.  `clock`: as in `gwfa_launch`; refused on the
    CPU."""
    caps = dict(dcap=dcap, ccap=ccap, tcap=tcap, fcap=fcap, wcap=wcap,
                degcap=degcap, hopcap=hopcap, evcap=evcap,
                max_steps=max_steps)
    if q.device.type == "cpu":
        if clock is not None:
            raise ValueError("the clock buffer is the CUDA kernel's")
        t0 = time.perf_counter()
        res = gwfa_batch_ref(gd, q, ql, v0, off0, v1, off1, max_ed, **caps)
        if timing is not None and q.shape[0]:
            timing.append((time.perf_counter() - t0) * 1e3)
        return res
    out = gwfa_launch(gd, q, ql, v0, off0, v1, off1, max_ed, **caps,
                      timing=timing, clock=clock)
    return out_views(out, q.shape[0], wcap)


def gwfa_launch(gd: GwfaGraph, q, ql, v0, off0, v1, off1, max_ed,
                dcap=256, ccap=2048, tcap=512, fcap=512, wcap=64, degcap=6,
                hopcap=16, evcap=128, max_steps=256, timing=None,
                clock=None):
    """The `gwfa` kernel (csrc/gwfa.cu, a block of 256 threads a job) on
    a batch of jobs on the card.  Returns its one int32 output buffer of
    J * (3 + wcap) (`out_views` splits it), so that the caller can copy
    all four outputs back at once.  Caps whose job state passes a
    block's shared memory (~113 KB at the defaults, 227 KB at most) fail
    at the launch (RuntimeError).

    `timing`, a list, receives the pair of CUDA events recorded on the
    current stream just before and after the launch: around the bare
    ctypes call, its arguments converted before (`kernels.bind`).
    `clock`: None, or a (J, CLK_N) int64 tensor on the card that takes
    each job's CLK_COLUMNS: clock64() cycles a phase, its
    synchronisations, waves and steps; no entry point passes it."""
    J, QCAP = q.shape
    jobs = (ql, v0, off0, v1, off1, max_ed)
    if q.device.type != "cuda":
        raise ValueError("gwfa_launch runs the CUDA kernel: the jobs must "
                         "be on the card")
    if q.dtype != I32 or any(x.shape != (J,) or x.dtype != I32
                             for x in jobs):
        raise ValueError("q must be (J, QCAP) int32, the job fields (J,) "
                         "int32")
    if any(x.device != q.device for x in (*jobs, *gd)):
        raise ValueError("the jobs and the graph must be on one device")
    if gd.arc_w.shape[1] != degcap:
        raise ValueError(f"the graph was packed for degcap "
                         f"{gd.arc_w.shape[1]}, not {degcap}")
    if dcap < evcap or ccap < dcap or evcap * degcap < dcap:
        raise ValueError("the caps need evcap <= dcap <= min(ccap, evcap * "
                         "degcap), as in the JAX kernel")
    if clock is not None and (clock.shape != (J, CLK_N)
                              or clock.dtype != I64
                              or clock.device != q.device):
        raise ValueError(f"clock must be a (J, {CLK_N}) int64 tensor on "
                         "the jobs' device")
    out = torch.empty(J * (3 + wcap), dtype=I32, device=q.device)
    if J == 0:
        # nothing to launch, so nothing to count
        return out
    from .. import kernels
    args = (q.contiguous(), *(x.contiguous() for x in jobs),
            *(x.contiguous() for x in gd), J, QCAP, gd.arc_cnt.shape[0],
            dcap, ccap, tcap, fcap, wcap, degcap, hopcap, evcap, max_steps,
            out, clock)
    call = kernels.bind("gwfa", *args)
    if timing is None:
        call()
    else:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        call()
        e1.record()
        timing.append((e0, e1))
    return out
