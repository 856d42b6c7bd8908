"""Batched exact 2-piece-affine WFA of the -c gap pool, with its traceback.

Port of the JAX package's ops/wfa_jax.py.  B (target, query) pairs are
aligned in lockstep, score by score: at score s every live diagonal of
a pair is extended greedily over exact matches, the end cell is tested,
and wave s + 1 of (H, E1, F1, E2, F2) is computed over all D = 2 d_cap
+ 1 diagonals with the int32 recurrences of the host engine (miniwfa),
its traceback bits recorded as row s of a (s_cap, B, D) uint8 plane.
The traceback walk then follows those bits back from the end cell, one
base-consuming step an iteration, into a (t_cap, B) op trace written
end first, which `decode_walk` turns into the host engine's CIGAR.

`wfa_device_ref` and `wfa_tb_walk_ref` are the plain PyTorch versions:
they reproduce the JAX recurrences one to one, its ring of n_hist =
max_pen + 1 waves indexed slot(s) = (n_hist - 1 + s) % n_hist and its
NEG_INF = -0x40000000 sentinel, to which the recurrences add 1 a step
(the traceback bits compare those drifted values).  `wfa_device` and
`wfa_tb_walk` run them for CPU tensors and launch the CUDA kernels
(csrc/wfa_exact.cu `wfa_wave`, `wfa_walk`) for tensors on the card.

The kernels stop each pair at its own end, where the JAX loop (and the
plain version) run the batch until every pair is done: they write no tb
row at or past a pair's score, the only rows the walk never reads.
score, end_d, no_ext, the ops trace and fin_i/fin_k are whole.  The
wave kernel keeps a pair's whole ring in shared memory as int16: a
reachable k >= -1 as it is, NEG_INF + d (the drift) as NEG16 + d, an
encoding that keeps order, max and +1 while the two zones stay apart;
`ring16_bytes` refuses the shapes where they could meet or the ring
would not fit a block.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

NEG_INF = -0x40000000
I32 = torch.int32
U8 = torch.uint8
T_PAD, Q_PAD = 254, 255     # distinct pads: padding never matches
PAD = 8                     # pad columns past the longest sequence
EXT_CHECK = 8               # extension rounds between "any extended?" tests
# the kernels' clock buffer columns (csrc/wfa_exact.cu), one row a pair
WAVE_CLK = ("ext", "end", "wave", "steps", "ext_iter", "cycles")
WALK_CLK = ("cycles", "steps", "tb_reads")


def encode_pairs(pairs: Sequence[Tuple[bytes, bytes]],
                 L: Optional[int] = None, device="cpu"):
    """(ts, tl, qs, ql): the pairs padded into (B, L + 8) uint8 planes
    (target pad 254, query pad 255) and int32 (B,) lengths; L defaults
    to the longest sequence."""
    Lmax = L or max(max(len(a), len(b)) for a, b in pairs)
    B = len(pairs)
    ts = np.full((B, Lmax + PAD), T_PAD, dtype=np.uint8)
    qs = np.full((B, Lmax + PAD), Q_PAD, dtype=np.uint8)
    tl = np.zeros(B, dtype=np.int32)
    ql = np.zeros(B, dtype=np.int32)
    for i, (a, b) in enumerate(pairs):
        if len(a) > Lmax or len(b) > Lmax:
            raise ValueError(f"pair {i} is longer than L={Lmax}")
        ts[i, : len(a)] = np.frombuffer(a, dtype=np.uint8)
        qs[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        tl[i] = len(a)
        ql[i] = len(b)
    return tuple(torch.from_numpy(x).to(device) for x in (ts, tl, qs, ql))


def _ring_depths(pens) -> Tuple[int, int, int]:
    """Waves each array must keep: H is read max_pen waves back, E1/F1
    pe1 back, E2/F2 pe2 back."""
    px, po1, pe1, po2, pe2 = pens
    return max(px, po1 + pe1, po2 + pe2) + 1, pe1 + 1, pe2 + 1


# the wfa_wave kernel's ring: int16 in shared memory
NEG16 = -32768              # NEG_INF in the int16 encoding
SMEM_MAX = 232448 - 64      # a block's shared memory on an H100, less
#                             the kernel's static words


def ring_stride(D: int) -> int:
    """int16 slots of a ring row: D diagonals (diagonal j at slot j + 2),
    two pads each side, 16-byte rows (csrc/wfa_exact.cu ring_stride)."""
    return (D + 4 + 7) & ~7


def seq_stride(L: int) -> int:
    """Bytes a staged sequence takes in shared memory, with the slack
    the 8-byte compares read past it (csrc/wfa_exact.cu seq_stride)."""
    return ((L + 15) & ~15) + 16


def ring16_bytes(pens, L: int, d_cap: int, s_cap: int) -> int:
    """Shared memory bytes of a wfa_wave block: the int16 ring of
    `_ring_depths` rows, the two staged sequences and a value a ring row
    for the edgeless plane's waves.  Raises ValueError
    where the kernel cannot hold the pair exactly: a penalty below 1 (px,
    pe1, pe2) or 0 (po1, po2); a reachable k (at most L - 1 + s_cap)
    past 32767 or a drifted NEG_INF (NEG_INF + s_cap at most) that could
    meet -1 (L + s_cap > 32767); or a block past SMEM_MAX."""
    px, po1, pe1, po2, pe2 = (int(v) for v in pens)
    if min(px, pe1, pe2) < 1 or min(po1, po2) < 0:
        raise ValueError(f"wfa_wave needs px, pe1, pe2 >= 1 and po1, po2 "
                         f">= 0, not {tuple(pens)}")
    if L + s_cap > 32767:
        raise ValueError(f"wfa_wave's int16 ring needs L + s_cap <= 32767 "
                         f"(L={L}, s_cap={s_cap})")
    dh, de1, de2 = _ring_depths(pens)
    rows = dh + 2 * de1 + 2 * de2
    # the ring, the sequences, the edgeless plane's waves (a value a row)
    nbytes = rows * ring_stride(2 * d_cap + 1) * 2 + 2 * seq_stride(L) \
        + 2 * rows
    if nbytes > SMEM_MAX:
        raise ValueError(f"wfa_wave's ring takes {nbytes} bytes of shared "
                         f"memory at d_cap={d_cap}, L={L}, pens "
                         f"{tuple(pens)}: more than {SMEM_MAX}")
    return nbytes


def wfa_device_ref(ts, tl, qs, ql, pens, d_cap: int, s_cap: int,
                   counts: Optional[dict] = None):
    """Plain PyTorch batched WFA: the JAX while_loop step for step.

    Returns (score, tb, done, end_d, no_ext): score (B,) int32, -1 where
    the score budget s_cap ran out; tb (s_cap, B, D) uint8 traceback
    bits; end_d (B,) int32 the first diagonal index (in increasing
    order) reaching the end cell; no_ext (B,) bool whether that cell was
    reached without a fresh extension at the final score.  `counts`,
    when given, receives the work a pair-at-a-time schedule does on
    these inputs: "cells", the wave cells of pairs not yet done, and
    "ext", the extension compares (one a live diagonal a step, plus one
    a base extended)."""
    px, po1, pe1, po2, pe2 = (int(v) for v in pens)
    B, L = ts.shape
    D = 2 * d_cap + 1
    dev = ts.device
    d_off = (torch.arange(D, dtype=I32, device=dev) - d_cap)[None, :]
    n_hist = max(px, po1 + pe1, po2 + pe2) + 1

    def full():
        return torch.full((n_hist, B, D), NEG_INF, dtype=I32, device=dev)

    H, E1, F1, E2, F2 = full(), full(), full(), full(), full()
    H[n_hist - 1, :, d_cap] = -1           # s = 0 seed at diagonal 0
    tb = torch.zeros((s_cap, B, D), dtype=U8, device=dev)
    score = torch.full((B,), -1, dtype=I32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    end_d = torch.zeros(B, dtype=I32, device=dev)
    no_ext = torch.zeros(B, dtype=torch.bool, device=dev)
    tl2 = tl.to(I32)[:, None]
    ql2 = ql.to(I32)[:, None]
    ts64 = ts.long()
    qs64 = qs.long()
    ninf = torch.full((B, 1), NEG_INF, dtype=I32, device=dev)

    def slot(sv):
        return (n_hist - 1 + sv) % n_hist

    def extend_all(Hc, live):
        """Greedy exact-match extension of every diagonal (B, D) of the
        live pairs, until no diagonal extends."""
        if counts is not None:
            qk = d_off + Hc
            counts["ext"] = counts.get("ext", 0) + int(
                ((Hc >= -1) & (Hc < tl2) & (qk >= -1) & (qk < ql2)
                 & live).sum())
        while True:
            any_ok = False
            for _ in range(EXT_CHECK):
                k = Hc
                qk = d_off + k
                valid = (k >= -1) & (k < tl2) & (qk >= -1) & (qk < ql2)
                tpos = (k + 1).clamp(0, L - 1).long()
                qpos = (qk + 1).clamp(0, L - 1).long()
                can = valid & (k + 1 < tl2) & (qk + 1 < ql2) \
                    & (torch.gather(ts64, 1, tpos)
                       == torch.gather(qs64, 1, qpos)) & live
                Hc = torch.where(can, k + 1, Hc)
                any_ok = can
                if counts is not None:
                    counts["ext"] += int(can.sum())
            if not bool(any_ok.any()):
                return Hc

    def sh_m(a):        # value at d - 1
        return torch.cat([ninf, a[:, :-1]], 1)

    def sh_p(a):        # value at d + 1
        return torch.cat([a[:, 1:], ninf], 1)

    s = 0
    while s < s_cap and not bool(done.all()):
        cur = slot(s)
        Hpre = H[cur]
        Hc = extend_all(Hpre, ~done[:, None])
        # end test: the first diagonal in increasing order
        at_end = (Hc == tl2 - 1) & (d_off + Hc == ql2 - 1) & (Hc > NEG_INF)
        now_done = at_end.any(1) & ~done
        first_d = at_end.to(torch.uint8).argmax(1).to(I32)
        end_d = torch.where(now_done, first_d, end_d)
        fl = first_d.long()[:, None]
        no_ext = torch.where(now_done, (torch.gather(Hc, 1, fl)
                                        == torch.gather(Hpre, 1, fl))[:, 0],
                             no_ext)
        score = torch.where(now_done, torch.full_like(score, s), score)
        done = done | now_done
        H[cur] = Hc
        if counts is not None:
            counts["cells"] = counts.get("cells", 0) + int((~done).sum()) * D

        nxt = slot(s + 1)
        pHx = H[slot(s + 1 - px)]
        pHo1 = H[slot(s + 1 - po1 - pe1)]
        pHo2 = H[slot(s + 1 - po2 - pe2)]
        pE1 = E1[slot(s + 1 - pe1)]
        pF1 = F1[slot(s + 1 - pe1)]
        pE2 = E2[slot(s + 1 - pe2)]
        pF2 = F2[slot(s + 1 - pe2)]
        ho1m, ho2m = sh_m(pHo1), sh_m(pHo2)
        e1m, e2m = sh_m(pE1), sh_m(pE2)
        ho1p, ho2p = sh_p(pHo1), sh_p(pHo2)
        f1p, f2p = sh_p(pF1), sh_p(pF2)
        nE1 = torch.maximum(ho1m, e1m)
        nE2 = torch.maximum(ho2m, e2m)
        e = torch.maximum(nE1, nE2)
        nF1 = torch.maximum(ho1p, f1p) + 1
        nF2 = torch.maximum(ho2p, f2p) + 1
        f = torch.maximum(nF1, nF2)
        h = torch.maximum(e, f)
        nH = torch.maximum(pHx + 1, h)

        x = torch.where(ho1m >= e1m, 0, 0x08) \
            | torch.where(ho2m >= e2m, 0, 0x20) \
            | torch.where(ho1p >= f1p, 0, 0x10) \
            | torch.where(ho2p >= f2p, 0, 0x40)
        ze = torch.where(nE1 >= nE2, 1, 3)
        zf = torch.where(nF1 >= nF2, 2, 4)
        z = torch.where(e >= f, ze, zf)
        z = torch.where(pHx + 1 >= h, 0, z)
        tb[s] = (x | z).to(U8)

        keep = done[:, None]
        H[nxt] = torch.where(keep, H[nxt], nH)
        E1[nxt] = torch.where(keep, E1[nxt], nE1)
        F1[nxt] = torch.where(keep, F1[nxt], nF1)
        E2[nxt] = torch.where(keep, E2[nxt], nE2)
        F2[nxt] = torch.where(keep, F2[nxt], nF2)
        s += 1
    return score, tb, done, end_d, no_ext


def no_ext_state(no_ext, tb, score, end_d):
    """Initial `last` state of the walk: when the end cell was reached
    without a fresh extension, the walk continues in the recorded state
    of the final score's row (mwf_wfa_core, miniwfa.c:404-406)."""
    S, B, D = tb.shape
    bidx = torch.arange(B, device=tb.device)
    x = tb[(score.long() - 1).clamp(0, S - 1), bidx,
           end_d.long().clamp(0, D - 1)]
    return torch.where(no_ext & (score > 0), (x & 7).to(I32),
                       torch.zeros_like(score, dtype=I32))


def wfa_tb_walk_ref(ts, tl, qs, ql, tb, score, end_d, no_ext, pens,
                    d_cap: int, t_cap: int):
    """Plain PyTorch traceback walk (miniwfa.c:330-377, the JAX
    while_loop step for step).  Returns (ops, fin_i, fin_k): (t_cap, B)
    uint8 op codes (7 match, 8 mismatch, 1 ins, 2 del, 0 inactive)
    emitted end first, and the final (i, k) for the leading indel."""
    px, po1, pe1, po2, pe2 = (int(v) for v in pens)
    S, B, D = tb.shape
    Lw = ts.shape[1]
    dev = ts.device
    bidx = torch.arange(B, device=dev)
    tb_flat = tb.reshape(-1)
    pen_open = torch.tensor([px, po1 + pe1, po1 + pe1, po2 + pe2,
                             po2 + pe2], dtype=I32, device=dev)
    pen_ext = torch.tensor([px, pe1, pe1, pe2, pe2], dtype=I32, device=dev)
    i = ql.to(I32) - 1
    k = tl.to(I32) - 1
    fi, fk = i.clone(), k.clone()
    sx = score.to(I32) - 1
    last = no_ext_state(no_ext, tb, score, end_d)
    active = score >= 0
    ops = torch.zeros((t_cap, B), dtype=U8, device=dev)
    zero = torch.zeros_like(i)
    one = torch.ones_like(i)
    t = 0
    while t < t_cap and bool(active.any()):
        inb = (i >= 0) & (k >= 0) & active
        tch = ts[bidx, k.clamp(0, Lw - 1).long()]
        qch = qs[bidx, i.clamp(0, Lw - 1).long()]
        m = inb & (last == 0) & (tch == qch)
        d = (i - k + d_cap).clamp(0, D - 1).long()
        srow = sx.clamp(0, S - 1).long()
        x = tb_flat[(srow * B + bidx) * D + d].to(I32)
        state = torch.where(last == 0, x & 7, last)
        ext = torch.where(state > 0, (x >> (state + 2)) & 1, zero)
        op = torch.where(m, 7, torch.where(
            state == 0, 8, torch.where((state == 1) | (state == 3), 1, 2)))
        ops[t] = torch.where(inb, op, 0).to(U8)
        di = torch.where(m | (state == 0) | (state == 1) | (state == 3),
                         one, zero)
        dk = torch.where(m | (state == 0) | (state == 2) | (state == 4),
                         one, zero)
        st = state.clamp(0, 4).long()   # JAX gathers clamp the index
        pen = torch.where(ext == 1, pen_ext[st], pen_open[st])
        i2 = torch.where(inb, i - di, i)
        k2 = torch.where(inb, k - dk, k)
        sx = torch.where(inb & ~m, sx - pen, sx)
        last2 = torch.where(inb & ~m & (state > 0) & (ext == 1), state, zero)
        last = torch.where(m, zero, torch.where(inb, last2, last))
        now_out = active & ((i2 < 0) | (k2 < 0))
        fi = torch.where(now_out, i2, fi)
        fk = torch.where(now_out, k2, fk)
        active = active & ~now_out
        i, k = i2, k2
        t += 1
    return ops, fi, fk


def _check_pairs(ts, tl, qs, ql):
    B, L = ts.shape
    if qs.shape != (B, L) or ts.dtype != U8 or qs.dtype != U8 \
            or tl.shape != (B,) or ql.shape != (B,):
        raise ValueError("sequences must be (B, L) uint8, lengths (B,)")
    return B, L


def _check_clock(clock, B, cols, dev):
    if clock is not None and (clock.shape != (B, len(cols))
                              or clock.dtype != torch.int64
                              or clock.device != dev):
        raise ValueError(f"clock must be a ({B}, {len(cols)}) int64 tensor "
                         f"on {dev}")


def wfa_device(ts, tl, qs, ql, pens, d_cap: int, s_cap: int, tb=None,
               clock=None):
    """Align B encoded pairs (`encode_pairs`): the plain version for CPU
    tensors, the `wfa_wave` kernel for tensors on the card, which writes
    into `tb` when given (a (s_cap, B, D) uint8 plane reused across
    calls) and holds tb rows only below each pair's score.  Returns
    (score, tb, done, end_d, no_ext) as `wfa_device_ref`.  The sequence
    lengths must be at most L (`encode_pairs` makes them so); shapes
    `ring16_bytes` refuses raise ValueError.  `clock`: None, or a (B,
    len(WAVE_CLK)) int64 tensor on the card that takes each pair's
    WAVE_CLK columns, clock64() cycles summed over its steps: in
    extension (the extensions that ended after the step's slowest wave),
    in the end test and the barrier, in the wave (from the barrier until
    its slowest thread ended); the steps, the extension iterations
    (8-byte compares) of all threads and the pair's cycles in all; no
    entry point passes it."""
    if ts.device.type == "cpu":
        return wfa_device_ref(ts, tl, qs, ql, pens, d_cap, s_cap)
    B, L = _check_pairs(ts, tl, qs, ql)
    D = 2 * d_cap + 1
    _check_clock(clock, B, WAVE_CLK, ts.device)
    ring16_bytes(pens, L, d_cap, s_cap)
    if tb is None:
        tb = torch.empty((s_cap, B, D), dtype=U8, device=ts.device)
    elif tb.shape != (s_cap, B, D) or tb.dtype != U8 \
            or tb.device != ts.device:
        raise ValueError(f"tb must be ({s_cap}, {B}, {D}) uint8 on "
                         f"{ts.device}")
    from .. import kernels
    dh, de1, de2 = _ring_depths(pens)
    score = torch.empty((B,), dtype=I32, device=ts.device)
    end_d = torch.empty((B,), dtype=I32, device=ts.device)
    no_ext = torch.empty((B,), dtype=torch.bool, device=ts.device)
    px, po1, pe1, po2, pe2 = (int(v) for v in pens)
    if clock is not None:
        clock.zero_()
    kernels.launch("wfa_wave", ts.contiguous(), qs.contiguous(),
                   tl.to(I32).contiguous(), ql.to(I32).contiguous(), B, L,
                   d_cap, s_cap, px, po1, pe1, po2, pe2, dh, de1, de2,
                   tb, score, end_d, no_ext, clock)
    return score, tb, score >= 0, end_d, no_ext


def wfa_tb_walk(ts, tl, qs, ql, tb, score, end_d, no_ext, pens,
                d_cap: int, t_cap: int, clock=None):
    """The traceback walk: the plain version for CPU tensors, the
    `wfa_walk` kernel (one warp a pair) for tensors on the card.
    Returns (ops, fin_i, fin_k) as `wfa_tb_walk_ref`.  `clock`: None, or
    a (B, len(WALK_CLK)) int64 tensor on the card that takes each pair's
    cycles, steps and tb reads; no entry point passes it."""
    if ts.device.type == "cpu":
        return wfa_tb_walk_ref(ts, tl, qs, ql, tb, score, end_d, no_ext,
                               pens, d_cap, t_cap)
    B, L = _check_pairs(ts, tl, qs, ql)
    S, _, D = tb.shape
    if tb.shape != (S, B, 2 * d_cap + 1) or tb.dtype != U8:
        raise ValueError("tb must be (S, B, 2 d_cap + 1) uint8")
    _check_clock(clock, B, WALK_CLK, ts.device)
    if 2 * seq_stride(L) > SMEM_MAX:
        raise ValueError(f"wfa_walk stages 2 x {seq_stride(L)} bytes of "
                         f"sequence: more than {SMEM_MAX}")
    from .. import kernels
    ops = torch.zeros((t_cap, B), dtype=U8, device=ts.device)
    fin_i = torch.empty((B,), dtype=I32, device=ts.device)
    fin_k = torch.empty((B,), dtype=I32, device=ts.device)
    px, po1, pe1, po2, pe2 = (int(v) for v in pens)
    kernels.launch("wfa_walk", ts.contiguous(), qs.contiguous(),
                   tl.to(I32).contiguous(), ql.to(I32).contiguous(),
                   tb.contiguous(), score.to(I32).contiguous(),
                   end_d.to(I32).contiguous(), no_ext.contiguous(), B, L,
                   S, d_cap, t_cap, px, po1, pe1, po2, pe2, ops, fin_i,
                   fin_k, clock)
    return ops, fin_i, fin_k


def decode_walk(ops_col: np.ndarray, fin_i: int, fin_k: int) -> List[int]:
    """Run-length encode one pair's op trace into host CIGAR words
    (len << 4 | op), the leading indel of the walk's exit appended."""
    n = int(np.argmin(ops_col)) if ops_col[-1] == 0 else len(ops_col)
    if ops_col[0] == 0:
        n = 0
    seq = ops_col[:n]
    cig: List[int] = []
    if n:
        # run-length encode (emitted end first)
        change = np.nonzero(np.diff(seq))[0]
        starts = np.concatenate([[0], change + 1])
        ends = np.concatenate([change + 1, [n]])
        for s0, e0 in zip(starts.tolist(), ends.tolist()):
            op = int(seq[s0])
            cig.append((e0 - s0) << 4 | op)
    if fin_i >= 0:
        cig.append((fin_i + 1) << 4 | 1)
    elif fin_k >= 0:
        cig.append((fin_k + 1) << 4 | 2)
    # the walk emits from the alignment's end: reverse, merge the seam
    cig.reverse()
    out: List[int] = []
    for c in cig:
        if out and (out[-1] & 0xF) == (c & 0xF):
            out[-1] += (c >> 4) << 4
        else:
            out.append(c)
    return out
