"""Device front-end for read mapping: the batched seed and chain stages.

Port of the JAX package's mapping/device_front.py.  For each length
bucket one step runs on the device:

  1. minimizer sketch (ops/sketch.py; CUDA kernel on the card);
  2. seed collection (ops/anchors.py): the flat join below 1e5 index
     keys, the cuckoo-hash join above;
  3. the exact-or-flag chain DP (ops/chain_exact.py; CUDA kernel), or
     with MGT_CHAIN_CHUNKED set its chunked-walk form
     (ops/chain_chunked.py; CUDA kernel) where the bucket allows it;
  4. the exact backtrack and compaction (ops/backtrack.py; its walk is
     a CUDA kernel);
  5. packing into one buffer, fetched with a single copy to the host.

The host then hands each read's compacted chains to the native batch
tail (mapping/native_tail.py).  Reads the device cannot reproduce
exactly carry a flag (sketch tie overflow, qcap/acap overflow,
occurrence-cap truncation, duplicate x, unsure chain or backtrack) and
take the host path, so the output is byte-identical either way.

When the chain parameters depend on the read or the chain is not the
banded DP (--rmq and asm, -F, sr; `chain_enabled` False), the front is
a seed-only front: it runs stages 1, 2 and 5 only and hands each read's
raw anchors, rep_len, minimizer positions and minimizer count to the
native tail, which chains them itself (mode 1 or 2) and skips its own
collect.

The kernel path is chosen by the device of the tensors: the front runs
on the device it is given, and the ops wrappers launch the CUDA kernels
for tensors on the card and their plain versions for tensors on the CPU.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..index.midx import MinimizerIndex
from ..options import (DBG, MG_M_HEAP_SORT, MG_M_NO_DIAG, MG_M_RMQ, MG_M_SPLICE,
                       MG_M_SR, MapOptions)
from ..ops.anchors import (HashJoinIndex, JoinIndex, collect_anchors_exact,
                           collect_anchors_exact_hash)
from ..ops.backtrack import backtrack_compact
from ..ops.chain_chunked import lchain_dp_chunked
from ..ops.chain_exact import lchain_dp_exact_win
from ..ops.sketch import encode_batch, sketch_planes
from ..utils import trace
from .native_tail import chain_penalties

U64 = np.uint64
META_Q_MASK = (1 << 25) - 1
UCAP = 64

# (pad_len, batch) buckets; reads longer than the widest go to host
DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (2048, 256), (8192, 128), (32768, 128))
STAGES = ("sketch", "collect", "chain", "backtrack", "pack")
SEED_STAGES = ("sketch", "collect", "pack")


@dataclass
class FrontResult:
    """Per-read device output, host-array form.  With the chain on: the
    compacted chain anchors (ax/ay, forward order, chains in
    first-anchor-x order) and u = sc<<32|cnt per chain, exactly
    mgt_lchain_finish's outputs.  From a seed-only front: the raw
    anchors sorted by x, as the native collect returns them, and u
    None."""
    ax: np.ndarray        # (n,) uint64
    ay: np.ndarray
    rep_len: int
    mini_pos: np.ndarray  # (n_mini,) int32/int64 query positions
    n_mv: int
    u: Optional[np.ndarray] = None  # (n_u,) uint64


def derive_query_info(q_cnt: np.ndarray, q_meta: np.ndarray, n_q: int,
                      max_occ: int) -> Tuple[int, np.ndarray]:
    """rep_len + mini_pos from per-emission query info
    (collect_matches, map-algo.c:67-89)."""
    cnts = q_cnt[:n_q].astype(np.int64)
    metas = q_meta[:n_q].astype(np.uint32)
    qpos = ((metas >> 1) & META_Q_MASK).astype(np.int64)   # k-mer end i
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


def _unpack_ay(pk: np.ndarray) -> np.ndarray:
    """Flat ay word occ8|tandem1|span6|qpos17 -> host ay layout
    occ<<56 | tandem<<42 | span<<32 | qpos."""
    pk = pk.astype(U64)
    return ((pk >> U64(24)) << U64(56)) \
        | (((pk >> U64(23)) & U64(1)) << U64(42)) \
        | (((pk >> U64(17)) & U64(0x3F)) << U64(32)) \
        | (pk & U64(0x1FFFF))


class DeviceFront:
    """Batched on-device seed and chain stage with host fallback flags.

    No entry point passes `buckets` or `chain_window`: like the JAX
    front's parameters of the same names, they exist so that the tests
    can run both fronts at one small bucket and window on the CPU.
    `chain_chunked` likewise: None reads the MGT_CHAIN_CHUNKED switch of
    the JAX front (any non-empty value turns the chunked chain on)."""

    def __init__(self, gi: MinimizerIndex, opt: MapOptions, device="cuda",
                 buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS,
                 chain_window: int = None, chain_chunked: bool = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceFront: no CUDA device available")
        self.gi = gi
        self.opt = opt
        occ_cap = 16          # hit slots per minimizer in the flat join
        # probe backend: the flat join suits indexes below ~1e5 distinct
        # minimizers; above that the K-independent cuckoo hash runs.  The
        # flat join holds keys below 2^36 (k <= 18), so wider keys (asm,
        # sr) take the hash join at any size; the JAX front has no join
        # for them
        wide = len(gi.keys) and int(np.max(gi.keys)) >= 1 << 36
        if len(gi.keys) > 100_000 or wide:
            # per-anchor positions come from idx gathers, so occ_cap
            # is free here: cover max_occ and the truncation flag never
            # fires (occ_cap < cnt < max_occ)
            occ_cap = max(occ_cap, min(256, opt.occ_max1 + 1))
            with trace.span("setup.front.tables"):     # the cuckoo build
                arrays = HashJoinIndex.host_arrays(gi)
            with trace.span("setup.front.upload"):
                self.ji = HashJoinIndex.from_arrays(arrays, occ_cap,
                                                    self.device)
            self.hashed = True
        else:
            with trace.span("setup.front.tables"):
                arrays = JoinIndex.host_arrays(gi, occ_cap)
            with trace.span("setup.front.upload"):
                self.ji = JoinIndex.from_arrays(arrays, self.device)
            self.hashed = False
        self.occ_cap = occ_cap
        self.buckets = sorted(buckets)
        self.max_len = self.buckets[-1][0]
        self.n_device = 0
        self.n_fallback = 0
        self.n_chain_unsure = 0
        self.n_flat_ovf = 0
        self.n_batches = 0    # device steps run (one a bucket batch)
        # True after a submit that built the kernel library or ran a
        # bucket for the first time: the split controller of the file
        # loop (mapping/mapper.py) does not take that cost as the
        # device's steady cost
        self.last_submit_cold = False
        # the pack's end event of the newest bucket batch submitted (None
        # on the CPU): busy_mark reads it
        self.last_end = None
        self._warm = set()
        # the -c gap pool of the Python reader loop (align/cigar_device.py
        # DeviceWfaPool), made by the loop at its first use
        self._wfa_pool = None
        # the device chain applies when the chain parameters are
        # read-independent (map-algo.c:377-390): no sr/splice/rmq, no
        # frag-length-dependent ref gap; otherwise the front is
        # seed-only and the native tail chains the raw anchors
        self.chain_enabled = (
            not (opt.flag & (MG_M_RMQ | MG_M_SPLICE | MG_M_SR))
            and opt.max_frag_len <= 0)
        self.chain_window = chain_window
        if chain_chunked is None:
            chain_chunked = bool(os.environ.get("MGT_CHAIN_CHUNKED"))
        self.chain_chunked = chain_chunked
        self.chn_pen_gap, self.chn_pen_skip = chain_penalties(gi, opt)
        mdx = opt.max_gap_ref if opt.max_gap_ref > 0 else opt.max_gap
        mdy = opt.max_gap
        self.mdx_adj = max(mdx, opt.bw)
        self.mdy_adj = max(mdy, opt.bw)
        self.timer = trace.StageTimer(
            self.device, STAGES if self.chain_enabled else SEED_STAGES)

    # ------------------------------------------------------------------
    def caps(self, pad_len: int):
        """(qcap, acap, window, tile) of a bucket.  Caps scale with the
        bucket; overflow-flagged reads fall back to the host, so caps
        trade only throughput."""
        # the packed fp/parent fields hold anchors < 16384 and the flat
        # ay word a 17-bit qpos
        if pad_len > 1 << 15:
            raise ValueError("device bucket too long for the packed planes")
        if pad_len <= 2048:
            qcap, acap = 384, 512
        elif pad_len <= 8192:
            qcap = max(256, pad_len // 4)
            acap = pad_len // 2 if pad_len <= 4096 else pad_len // 4
        else:
            qcap = pad_len // 4
            acap = (pad_len // 6 // 128) * 128
        if self.chain_window is not None:
            win = min(self.chain_window, acap)
        elif self.device.type == "cuda":
            # the card's window covers the scan reach of long reads
            win = min(512 if pad_len <= 4096 else 768, acap)
        else:
            win = min(1024 if pad_len <= 4096 else 256, acap)
        tile = min(128, acap) if self.device.type == "cuda" else 8
        return qcap, acap, win, tile

    def _step(self, codes: torch.Tensor, lens: torch.Tensor, pad_len: int,
              bsz: int):
        """Run the device stages on one padded batch; returns the packed
        device buffer, its layout and the padded planes (kept for the
        rare batch that overflows the flat planes)."""
        qcap, acap, win, tile = self.caps(pad_len)
        opt = self.opt
        gi = self.gi
        max_occ = int(opt.occ_max1)
        tm = self.timer
        t0 = tm.mark()
        with trace.span("front.sketch"):
            sp = sketch_planes(codes, lens, gi.w, gi.k)
            t1 = tm.mark()
        tm.add("sketch", t0, t1)
        collect = collect_anchors_exact_hash if self.hashed \
            else collect_anchors_exact
        with trace.span("front.collect"):
            res = collect(self.ji, sp.hh, sp.hl, sp.meta, sp.t_hh, sp.t_hl,
                          sp.t_meta, max_occ, self.occ_cap, qcap=qcap,
                          acap=acap)
            overflow = res["overflow"] | sp.overflow
            # cnt <= 255 decides every occurrence test (max_occ caps at
            # 250)
            q_cnt = torch.clamp(res["q_cnt"], 0, 255)
            t2 = tm.mark()
        tm.add("collect", t1, t2)
        if not self.chain_enabled:
            # seed-only: the raw anchor planes go to the host
            full = {k: res[k] for k in ("axh", "axl", "ayh", "ayl")}
            full.update(q_cnt=q_cnt, q_meta=res["q_meta"])
            head = {"n_a": res["n_a"], "n_q": res["n_q"],
                    "overflow": overflow}
            return self._pack(head, full, res["n_a"], res["n_q"],
                              max_occ, bsz, acap, qcap, t2)
        # the chunked chain drops the max_ii candidate, exact only while
        # the iteration clamp clears the buffer (the JAX front's guards)
        chain = lchain_dp_chunked if (
            self.chain_chunked and opt.max_lc_iter >= win + min(128, acap)
            and win >= 128) else lchain_dp_exact_win
        with trace.span("front.chain"):
            f, p, sure = chain(
                res["axh"], res["axl"], res["ayh"], res["ayl"], res["n_a"],
                int(self.mdx_adj), int(self.mdy_adj), int(opt.bw),
                int(opt.max_lc_skip), int(opt.max_lc_iter),
                self.chn_pen_gap, self.chn_pen_skip, window=win, tile=tile)
            t3 = tm.mark()
        tm.add("chain", t2, t3)
        with trace.span("front.backtrack"):
            bt = backtrack_compact(f, p, res["n_a"], res["axh"], res["axl"],
                                   res["ayh"], res["ayl"],
                                   min_cnt=int(opt.min_lc_cnt),
                                   min_sc=int(opt.min_lc_score),
                                   max_drop=int(opt.bw), ucap=UCAP)
            sure = sure & ~bt["bt_unsure"]
            t4 = tm.mark()
        tm.add("backtrack", t3, t4)
        full = {"axh": bt["c_axh"], "axl": bt["c_axl"],
                "ayh": bt["c_ayh"], "ayl": bt["c_ayl"],
                "u_pad_sc": bt["u_sc"], "u_pad_cnt": bt["u_cnt"],
                "n_u": bt["n_u"], "q_cnt": q_cnt, "q_meta": res["q_meta"]}
        head = {"n_a": bt["n_v"], "n_q": res["n_q"], "overflow": overflow,
                "sure": sure}
        return self._pack(head, full, bt["n_v"], res["n_q"], max_occ, bsz,
                          acap, qcap, t4)

    def _pack(self, head, full, n_a, n_q, max_occ, bsz, acap, qcap, t0):
        """Stage 5: the flat planes, then one buffer for one copy (every
        leaf as int64 words).  Returns (buffer, layout, padded planes);
        the stage's end mark becomes last_end on the card."""
        with trace.span("front.pack"):
            head.update(self._pack_body(full, n_a, n_q, max_occ, bsz, acap,
                                        qcap))
            layout = []
            parts = []
            for key in sorted(head):
                v = head[key]
                layout.append((key, tuple(v.shape), v.dtype))
                parts.append(v.reshape(-1).to(torch.int64))
            buf = torch.cat(parts)
            end = self.timer.mark()
        self.timer.add("pack", t0, end)
        if self.timer.cuda:
            self.last_end = end
        return buf, layout, full

    @staticmethod
    def _pack_body(full, n_a, n_q, max_occ, B, acap, qcap):
        """Dense packing of the live anchors of all reads (the chain
        anchors, or a seed-only front's raw anchors) into flat planes of
        half the padded size (pack_body of the JAX front): ay packed to
        one word occ8|tandem1|span6|qpos17 (span <= 31 by construction,
        qpos < 2^17 for bucket reads); rep_len and the non-repetitive
        minimizer positions computed on the device; chain records, where
        there are any, dense-packed.  A batch fuller than the flat caps
        sets flat_ovf and is unpacked from the padded planes instead."""
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
        # rep_len + mini_pos (derive_query_info / collect_matches,
        # map-algo.c:67-89): q_cnt is clipped at 255 >= every max_occ
        q_meta = full["q_meta"]
        qr = torch.arange(qcap, device=dev)[None, :]
        q_ok = qr < n_q[:, None]
        rep = q_ok & (full["q_cnt"] >= max_occ)
        qpos = (q_meta >> 1) & META_Q_MASK
        span = (q_meta >> 26) & 0x1F
        # union of rep intervals [en-sp, en): ens ascend per read, so
        # coverage is sum(max(0, en - max(st, prev rep en)))
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

    # ------------------------------------------------------------------
    def eligible(self, opt: MapOptions, n_segs: int, qlen_sum: int) -> bool:
        if DBG["flag"]:
            # debug dumps are written on the per-read path
            return False
        if n_segs != 1 or qlen_sum == 0 or qlen_sum > self.max_len:
            return False
        if opt.flag & (MG_M_HEAP_SORT | MG_M_NO_DIAG):
            return False
        if opt.max_qlen > 0 and qlen_sum > opt.max_qlen:
            return False
        if opt.occ_max1 > 255:
            # the occurrence plane saturates at 255, so the host's
            # cnt >= occ_max1 repeat test cannot be reproduced
            return False
        return True

    def busy_mark(self):
        """At the start of a host call: the end event of the newest
        bucket batch submitted where it still runs on the card, else
        None (always on the CPU)."""
        end = self.last_end
        return None if end is None or end.query() else end

    def overlap_ms(self, mark, call_ms: float) -> float:
        """The ms of a host call of call_ms, begun at `mark` (busy_mark),
        that ran while the card was still on the batch: 0 where it had
        finished before the call, the whole call where it still runs,
        else the call less the card's time from the batch's end to an
        event recorded now: exact while nothing follows the batch on the
        stream, a lower bound otherwise."""
        if mark is None:
            return 0.0
        if not mark.query():
            return call_ms
        now = self._now_mark()
        now.synchronize()
        return min(call_ms, max(0.0, call_ms - mark.elapsed_time(now)))

    @staticmethod
    def _now_mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def submit(self, seqs: List[str]):
        """Run the device stages for a list of reads (str, bytes or
        uint8 arrays).  Launches are asynchronous on the card; gather()
        waits for the results.  Returns an opaque handle for
        gather()/gather_flat()."""
        with trace.span("front.submit"):
            cold = self.device.type == "cuda" and not kernels.loaded()
            by_bucket: Dict[int, List[int]] = {}
            for i, s in enumerate(seqs):
                for pad_len, bsz in self.buckets:
                    if len(s) <= pad_len:
                        by_bucket.setdefault(pad_len, []).append(i)
                        break
            pending = []
            for pad_len, idxs in by_bucket.items():
                bsz = dict(self.buckets)[pad_len]
                for c0 in range(0, len(idxs), bsz):
                    chunk = idxs[c0: c0 + bsz]
                    reads = [seqs[i] for i in chunk]
                    reads += [""] * (bsz - len(reads))
                    with trace.span("front.encode"):
                        codes, lens = encode_batch(reads, pad_to=pad_len)
                    with trace.span("front.upload"):
                        codes = torch.from_numpy(codes).to(self.device)
                        lens = torch.from_numpy(lens).to(self.device)
                    with trace.span("front.dispatch"):
                        buf, layout, full = self._step(codes, lens, pad_len,
                                                       bsz)
                    self.n_batches += 1
                    pending.append((chunk, buf, layout, full, self.last_end))
                if pad_len not in self._warm:
                    self._warm.add(pad_len)
                    cold = True
            self.last_submit_cold = cold
            return (len(seqs), pending)

    def _fetch(self, entry):
        """Copy one chunk's packed buffer to the host and unpack it; a
        batch that overflowed the flat planes also fetches the padded
        planes."""
        chunk, buf, layout, full, end = entry
        with trace.span("front.wait"):
            if end is not None:
                end.synchronize()
        with trace.span("front.copy"):
            host = buf.cpu().numpy()
        self.timer.settle()
        with trace.span("front.unpack"):
            res = {}
            off = 0
            for key, shape, dtype in layout:
                n = int(np.prod(shape)) if shape else 1
                v = host[off: off + n].reshape(shape)
                off += n
                res[key] = v.astype(bool) if dtype == torch.bool else v
        if res["flat_ovf"]:
            self.n_flat_ovf += 1
            with trace.span("front.copy"):
                res.update({k: v.cpu().numpy() for k, v in full.items()})
        return chunk, res

    def gather_flat(self, handle):
        """Batch-array results: (flat, extra), where flat is a list of
        (positions-in-submit-order, blob of batch arrays) for reads whose
        compacted chains the device delivered, and extra maps positions
        to FrontResult-or-None for the chunks that do not go flat: a
        chunk that overflowed the flat planes, and every chunk of a
        seed-only front (its raw anchors go per read).  Reads absent
        from both, or None in extra, take the host path."""
        with trace.span("front.gather"):
            n_seqs, pending = handle
            flat = []
            extra = {}
            for entry in pending:
                chunk, res = self._fetch(entry)
                with trace.span("front.unpack"):
                    self._unpack(chunk, res, flat, extra)
            return flat, extra

    def _unpack(self, chunk, res, flat, extra):
        """One fetched chunk into gather_flat's flat list or its extra
        map."""
        if res["flat_ovf"] or not self.chain_enabled:
            for ri, fr in zip(chunk, self._chunk_results(chunk, res)):
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

    def gather(self, handle) -> List[Optional[FrontResult]]:
        """One FrontResult per submitted read, or None where the read
        must take the host path."""
        n_seqs, _ = handle
        out: List[Optional[FrontResult]] = [None] * n_seqs
        flat, extra = self.gather_flat(handle)
        for ri, fr in extra.items():
            out[ri] = fr
        for pos, blob in flat:
            for j, ri in enumerate(pos.tolist()):
                p0, n = int(blob["prefix"][j]), int(blob["n_a"][j])
                m0, nm = int(blob["mprefix"][j]), int(blob["n_mini"][j])
                u0, nu = int(blob["uprefix"][j]), int(blob["n_u"][j])
                out[ri] = FrontResult(
                    ax=blob["AX"][p0: p0 + n], ay=blob["AY"][p0: p0 + n],
                    rep_len=int(blob["rep_len"][j]),
                    mini_pos=blob["MINI"][m0: m0 + nm],
                    n_mv=int(blob["n_q"][j]), u=blob["U"][u0: u0 + nu])
        return out

    def _chunk_results(self, chunk, res):
        """Per-read FrontResults of one fetched chunk, from the flat
        planes or, for a chunk that overflowed them, the padded ones."""
        out: List[Optional[FrontResult]] = [None] * len(chunk)
        padded = bool(res["flat_ovf"])
        chains = self.chain_enabled
        if padded:
            AX = (res["axh"].astype(U64) << U64(32)) \
                | res["axl"].astype(U64)
            AH = res["ayh"].astype(U64)
            # device ayh = occ<<24|tandem<<10|span; host layout =
            # occ<<56|tandem<<42|span<<32 | qpos
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
                    int(self.opt.occ_max1))
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

    def log_stats(self):
        from ..utils.syslog import mlog
        tot = self.n_device + self.n_fallback + self.n_chain_unsure
        if tot:
            mlog("device_front",
                 f"device seed stage: {self.n_device}/{tot} reads on "
                 f"device, {self.n_fallback} host fallbacks, "
                 f"{self.n_chain_unsure} chain-DP host reruns, "
                 f"{self.n_flat_ovf} flat-plane refetches")
        if self._wfa_pool is not None:
            mlog("device_front",
                 f"device -c gap WFA: {self._wfa_pool.n_device} on "
                 f"device, {self._wfa_pool.n_host} host")
