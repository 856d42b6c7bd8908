"""Read mapping for the port: the per-read path (mg_map_frag,
map-algo.c:340-502) and the file-level loop (mg_map_files,
gmap.c:163-211).

`map_files` indexes the graph once, then maps each query file batch by
batch: the device front runs the seed and chain stages for the eligible
reads, one native tail call turns their compacted chains into GAF text,
one more maps the flagged and ineligible reads through the native host
path, and the text is written in input order.  A read whose native
tail bails (status != 0) is mapped again from its sequence on the
exact per-read path (`map_frag`) and written with `write_gaf`.  With
device=None every read takes the native host path; that run is the
byte reference the device run is held against.
"""
from __future__ import annotations

import copy
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..graph.gfa import Graph
from ..index.midx import build_index
from ..index.midx import MinimizerIndex
from ..options import (MG_M_NO_COMP_PATH, MG_M_PRINT_2ND, MG_M_SHOW_UNMAP,
                       MG_MAX_SEG, IndexOptions, MapOptions)
from ..seqio.bseq import BSeqFile
from ..seqio.gaf import write_gaf
from ..utils.hashes import kh_hash_str, kh_hash_uint32
from ..utils.ksort import radix_argsort
from . import gchain, lchain
from .lchain import _i32
from .filters import apply_chain_filters
from .native_tail import chain_penalties, map_batch_native
from .seeds import collect_minimizers, collect_native, collect_seed_hits
from .select import (gchain_drop_flt, gchain_flt_sub, gchain_set_mapq,
                     gchain_set_parent)

# output flags the native GAF formatter handles; the port maps
# single-segment reads to GAF without base-level alignment (no -c)
SUPPORTED_FLAGS = MG_M_PRINT_2ND | MG_M_NO_COMP_PATH | MG_M_SHOW_UNMAP
U32 = 0xFFFFFFFF


def resolve_device(device) -> Optional[torch.device]:
    """The torch device for `device` ("cuda", "cpu", a torch.device or
    None for host-only).  Raises when CUDA is asked for and absent: the
    port never moves to the CPU on its own."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "or device=None to map on the CPU")
    return dev


def _check_options(opt: MapOptions) -> None:
    if opt.flag & ~SUPPORTED_FLAGS:
        raise NotImplementedError(
            f"mapping flags {opt.flag & ~SUPPORTED_FLAGS:#x} are not "
            "supported by the port")
    if opt.max_frag_len > 0 or opt.max_gap_ref > 0:
        raise NotImplementedError("fragment-length gaps are not supported "
                                  "by the port")


def _unmapped(name: str, qlen: int, opt: MapOptions) -> str:
    """What the reference writes for a read it does not map."""
    if opt.flag & MG_M_SHOW_UNMAP:
        return f"{name}\t{qlen}\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0\n"
    return ""


def map_frag(gi: MinimizerIndex, qlens: List[int], seqs: List[str],
             opt: MapOptions, qname: Optional[str],
             fast_emit: bool = False) -> Optional[gchain.GChains]:
    """Map one fragment (n_segs query segments) to the graph."""
    n_segs = len(qlens)
    qlen_sum = sum(qlens)
    if qlen_sum == 0 or n_segs <= 0 or n_segs > MG_MAX_SEG:
        return None
    if opt.max_qlen > 0 and qlen_sum > opt.max_qlen:
        return None
    res = None
    if n_segs == 1:
        # whole seed stage in one native call (native/mgt_collect.c)
        res = collect_native(gi, opt, opt.occ_max1, seqs[0])
    if res is not None:
        ax, ay, rep_len, mini_pos, n_mv = res
    else:
        mv_x, mv_y = collect_minimizers(gi, qlens, seqs)
        n_mv = len(mv_x)
        ax, ay, rep_len, mini_pos = collect_seed_hits(
            gi, opt, opt.occ_max1, mv_x, mv_y)
    return map_frag_tail(gi, qlens, seqs, opt, qname, ax, ay, rep_len,
                         mini_pos, n_mv, fast_emit=fast_emit)


def map_frag_tail(gi: MinimizerIndex, qlens: List[int], seqs: List[str],
                  opt: MapOptions, qname: Optional[str],
                  ax: np.ndarray, ay: np.ndarray, rep_len: int,
                  mini_pos: np.ndarray, n_mv: int,
                  fast_emit: bool = False) -> gchain.GChains:
    """Per-read pipeline after seed collection (map-algo.c:377-495).

    The whole tail runs in one native call; each native stage that
    bails hands the read to the next, more decomposed one."""
    n_segs = len(qlens)
    qlen_sum = sum(qlens)
    hash_ = kh_hash_str(qname) if qname else 0
    hash_ ^= (kh_hash_uint32(qlen_sum & U32) + kh_hash_uint32(opt.seed)) & U32
    hash_ &= U32
    hash_ = kh_hash_uint32(hash_)
    # the port admits no sr/splice/frag options (SUPPORTED_FLAGS)
    max_chain_gap_qry = max_chain_gap_ref = opt.max_gap
    chn_pen_gap, chn_pen_skip = chain_penalties(gi, opt)
    seq_cat = "".join(seqs)

    # whole-tail native path (native/mgt_tail.c): linear chain + rescue
    # + lchain tail + graph chain + selection in ONE call
    if len(ax) > 0:
        sel_args = (opt.mask_level, opt.pri_ratio, gi.k * 2,
                    opt.best_n, qlen_sum, n_mv, opt.min_gc_score,
                    rep_len)
        emit = (qname or "", qlen_sum, opt.flag) \
            if fast_emit and n_segs == 1 else None
        gcs = gchain.map_tail_full(
            gi.g, gi.es, ax, ay, mini_pos, opt, qlen_sum, n_segs,
            max_chain_gap_ref, max_chain_gap_qry, chn_pen_gap,
            chn_pen_skip, hash_, seq_cat, sel_args, emit)
        if gcs is not None:
            gcs.rep_len = rep_len
            return _map_frag_finish(gi, gcs, opt, qlen_sum, n_mv)

    if len(ax) == 0:
        n_lc, u = 0, np.empty(0, dtype=np.uint64)
    else:
        ax, ay, n_lc, u = lchain.lchain_dp(
            max_chain_gap_ref, max_chain_gap_qry, opt.bw, opt.max_lc_skip,
            opt.max_lc_iter, opt.min_lc_cnt, opt.min_lc_score,
            chn_pen_gap, chn_pen_skip, False, n_segs, ax, ay)

    # long-join rescue re-chain (map-algo.c:407-417)
    if opt.bw_long > opt.bw and n_segs == 1 and n_lc > 1:
        st = _i32(int(ay[0]))
        en = _i32(int(ay[(int(u[0]) & U32) - 1]))
        if qlen_sum - (en - st) > opt.rmq_rescue_size \
                or qlen_sum - (en - st) > qlen_sum * opt.rmq_rescue_ratio:
            n_a = sum(int(u[i]) & U32 for i in range(n_lc))
            ax, ay = ax[:n_a], ay[:n_a]
            perm = radix_argsort(ax)
            ax, ay = ax[perm], ay[perm]
            ax, ay, n_lc, u = lchain.lchain_rmq(
                opt.max_gap, opt.max_gap_pre, opt.bw_long, opt.max_lc_skip,
                opt.rmq_size_cap, opt.min_lc_cnt, opt.min_lc_score,
                chn_pen_gap, chn_pen_skip, ax, ay)

    # fused native tail (native/mgt_gchain.c): lchain_gen + filter
    # block + update_anchors in one call, chains kept as a table
    tab = None
    if n_lc:
        tab = lchain.lchain_tail_tab(qlen_sum, n_lc, u, ax, ay, mini_pos,
                                     opt)
    if tab is None:
        lc = lchain.lchain_gen(qlen_sum, n_lc, u, ax, ay) if n_lc else []
        if n_lc > 1:
            kept = []
            for p in lc:
                p.off, p.cnt = apply_chain_filters(ax, ay, p.off, p.cnt,
                                                   p.score, opt)
                if p.cnt >= opt.min_lc_cnt:
                    q_span = (int(ay[p.off]) >> 32) & 0xFF
                    p.rs = _i32(int(ax[p.off])) + 1 - q_span
                    p.qs = _i32(int(ay[p.off])) + 1 - q_span
                    p.re = _i32(int(ax[p.off + p.cnt - 1])) + 1
                    p.qe = _i32(int(ay[p.off + p.cnt - 1])) + 1
                    kept.append(p)
            lc = kept
        for p in lc:
            lchain.update_anchors(p, ax, ay, mini_pos)

    gcs = None
    if tab is not None:
        # whole graph-chain stage in one native call
        gcs = gchain.gchain_full_tab(
            gi.g, gi.es, tab, qlen_sum, opt.bw_long, opt.bw_long,
            opt.bw_long, opt.max_gc_skip, opt.ref_bonus, chn_pen_gap,
            opt.mask_level, ay, ax, hash_, opt.min_gc_cnt,
            opt.min_gc_score, opt.gdp_max_ed, n_segs, seq_cat)
    if gcs is None:
        if tab is not None:
            n_gc, u, lc = gchain.gchain1_dp_tab(
                gi.g, tab, qlen_sum, opt.bw_long, opt.bw_long, opt.bw_long,
                opt.max_gc_skip, opt.ref_bonus, chn_pen_gap, chn_pen_skip,
                opt.mask_level, ay)
        else:
            n_gc, u, lc = gchain.gchain1_dp(
                gi.g, lc, qlen_sum, opt.bw_long, opt.bw_long, opt.bw_long,
                opt.max_gc_skip, opt.ref_bonus, chn_pen_gap, chn_pen_skip,
                opt.mask_level, ay)
        gcs = gchain.gchain_gen_tab(gi.g, gi.es, n_gc, u, lc, ax, ay, hash_,
                                    opt.min_gc_cnt, opt.min_gc_score,
                                    opt.gdp_max_ed, n_segs, seq_cat)
    gcs.rep_len = rep_len
    return _map_frag_finish(gi, gcs, opt, qlen_sum, n_mv)


def _map_frag_finish(gi, gcs, opt, qlen_sum, n_mv):
    """Selection + mapq (map-algo.c:464-475), unless the native tail
    already selected (gcs.selected)."""
    if not getattr(gcs, "selected", False):
        gchain_set_parent(opt.mask_level, gcs.gc, opt.sub_diff, 0)
        gchain_flt_sub(opt.pri_ratio, gi.k * 2, opt.best_n, gcs.gc)
        gchain_drop_flt(gcs)
        gchain_set_mapq(gcs, qlen_sum, n_mv, opt.min_gc_score)
    return gcs


def map_batch(gi, opt: MapOptions, recs, n_threads: int, front=None,
              stats: Optional[dict] = None) -> List[str]:
    """GAF text of each record, in input order.  `stats`, when given,
    adds the native tail's host time (tail_ms) and counts the reads
    re-mapped on the per-read path (n_perread)."""
    n = len(recs)
    texts: List[Optional[str]] = [None] * n
    todo = []
    for i, r in enumerate(recs):
        ql = len(r.seq)
        if ql == 0 or (opt.max_qlen > 0 and ql > opt.max_qlen):
            texts[i] = _unmapped(r.name, ql, opt)
        else:
            todo.append(i)
    dev_idx = [i for i in todo
               if front is not None and front.eligible(opt, 1,
                                                       len(recs[i].seq))]
    frs = front.gather(front.submit([recs[i].seq for i in dev_idx])) \
        if dev_idx else []
    on_dev = {i: fr for i, fr in zip(dev_idx, frs) if fr is not None}
    t0 = time.perf_counter()
    res = map_batch_native(
        gi, opt, [(i, recs[i].name, recs[i].seq, on_dev[i]) for i in on_dev],
        n_threads)
    res.update(map_batch_native(
        gi, opt, [(i, recs[i].name, recs[i].seq, None) for i in todo
                  if i not in on_dev], n_threads, host_collect=True))
    if stats is not None:
        stats["tail_ms"] = stats.get("tail_ms", 0.0) \
            + (time.perf_counter() - t0) * 1e3
    n_perread = 0
    for i in todo:
        if res[i] is None:
            # the native tail bailed: re-map the read from its sequence
            # on the exact per-read path (the device's chains are not
            # reused)
            r = recs[i]
            ql = len(r.seq)
            gcs = map_frag(gi, [ql], [r.seq], opt, r.name, fast_emit=True)
            res[i] = write_gaf(gi.g, gcs, 1, [ql], r.name, opt.flag)
            n_perread += 1
        texts[i] = res[i]
    if stats is not None:
        stats["n_perread"] = stats.get("n_perread", 0) + n_perread
    return texts


def map_files(g: Graph, fns: List[str], ipt: IndexOptions,
              opt0: MapOptions, out=sys.stdout, n_threads: int = 1,
              device="cuda", stats: Optional[dict] = None) -> int:
    """Index once, then map each query file (mg_map_files).

    device: "cuda" (default) runs the seed and chain stages on the card,
    "cpu" runs the same stages' plain versions on the CPU, None maps
    every read on the native host path.  The GAF bytes are the same in
    all three cases: reads the device cannot reproduce exactly are
    flagged and take the host path.  `stats`, when given, receives the
    index and mapping wall times, the native tail's host time, and the
    front's counters and per-stage device times (all in ms)."""
    dev = resolve_device(device)
    opt = copy.copy(opt0)
    _check_options(opt)
    t0 = time.perf_counter()
    gi = build_index(g, ipt.k, ipt.w, opt)
    front = None
    if dev is not None:
        from .device_front import DeviceFront
        front = DeviceFront(gi, opt, device=dev)
    t1 = time.perf_counter()
    for fn in fns:
        fp = BSeqFile(fn)
        try:
            while True:
                batch = fp.read_batch(opt.mini_batch_size)
                if not batch:
                    break
                out.write("".join(map_batch(gi, opt, batch, n_threads,
                                            front, stats)))
        finally:
            fp.close()
    if stats is not None:
        stats.update(index_ms=(t1 - t0) * 1e3,
                     map_ms=(time.perf_counter() - t1) * 1e3)
    if front is not None:
        front.log_stats()
        if stats is not None:
            stats.update(n_device=front.n_device,
                         n_fallback=front.n_fallback,
                         n_chain_unsure=front.n_chain_unsure,
                         n_flat_ovf=front.n_flat_ovf,
                         stage_ms=dict(front.timer.ms))
    return 0
