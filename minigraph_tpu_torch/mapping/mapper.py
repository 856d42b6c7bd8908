"""Read mapping for the port: the per-read path (mg_map_frag,
map-algo.c:340-502) and the file-level loops (mg_map_files,
gmap.c:66-211).

`map_files` indexes the graph once, then maps each query file, or with
fragments (sr, --frag) a group of files read in step (mates side by
side).  A single file the native reader opens goes through
`_map_file_native`, the JAX package's all-native loop: C reader arenas
with a one-batch read-ahead thread, and, with a device front, the
adaptive host/device split.  In the open split each arena batch sends a
share of its eligible reads to the device front and maps the rest in
one native host call (host collect); the device share goes to the card
in groups of whole bucket batches, and one worker thread runs the
batch's native calls in turn (the host share's, then each group's
chains or anchors through the native tail) while the loop's thread
submits the next group, so the submit and the tails overlap within the
batch.  One controller (mapping/split.py ShareSplit) sets the host
share of both loops from the measured per-read costs so that both
finish together; when the device does not pay, the split collapses to
the host with a device probe every few batches.  In frag mode the loop
groups mates in C, applies the pair orientation in place on the arena
and maps each pair as one batch item.

Everything else (stdin, paired files, the output shapes the native
batch cannot serialize: --vc, -S; -D) goes through `_map_file_frag`,
the JAX package's Python reader loop: it reads and submits batch k+1
before it finishes batch k, maps a share of the eligible reads on the
host in a background thread, and maps fragments and what the native
batch cannot take on the per-read path.  A read whose native tail bails
(status != 0) is mapped again on the exact per-read path (`map_frag`)
and written with `write_gaf`.  With device=None every read takes the
host path; that run is the byte reference the device runs are held
against, whatever share the controller picks.

-c (base-level alignment) runs in the native batch tail's workers; on
the per-read path `_map_frag_finish` aligns the chains (align/cigar.py),
and in the Python reader loop with a front and an output shape the
batch cannot write (--vc, -S) the chains the native walk cannot finish
leave their gaps to the front's gap pool (align/cigar_device.py).

With a GWFA pool (--gwfa-device, align/gwfa_device.py) every read takes
the Python reader loop and the per-read tail, whose graph-chain stage
bridges on the pool: with a front one pool call a read, without one a
GwfaBatchSink and one call a batch.  --cov adds each read's chains to
the segment and link coverage (ggen/cov.py) instead of writing GAF.
"""
from __future__ import annotations

import copy
import ctypes as ct
import os
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..align.cigar import gchain_cigar, gchain_gen_ds
from ..align.cigar_device import (CigarSink, DeviceWfaPool, finalize_read,
                                  harvest_read)
from ..align.gwfa_device import DeviceGwfaPool, GwfaBatchSink, GwfaPending
from ..ggen.cov import aux_update_cv, cov_map
from ..graph.gfa import Graph, revcomp
from ..index.midx import MinimizerIndex, build_index
from ..options import (DBG, MG_DBG_LCHAIN, MG_DBG_QNAME, MG_DBG_SEED,
                       MG_M_CAL_COV, MG_M_CIGAR, MG_M_FRAG_MERGE,
                       MG_M_FRAG_MODE, MG_M_HEAP_SORT, MG_M_INDEPEND_SEG,
                       MG_M_NO_DIAG, MG_M_RMQ, MG_M_SPLICE, MG_M_SR,
                       MG_M_VERTEX_COOR, MG_M_WRITE_LCHAIN, MG_M_WRITE_MZ,
                       MG_MAX_SEG, IndexOptions, MapOptions)
from ..seqio.bseq import BSeqFile, NativeSeqReader, qname_same, toupper
from ..seqio.gaf import write_gaf
from ..utils import trace
from ..utils.hashes import kh_hash_str, kh_hash_uint32
from ..utils.ksort import radix_argsort
from ..utils.native import get_lib
from ..utils.syslog import mlog
from . import gchain, lchain
from .lchain import _i32
from .filters import apply_chain_filters
from .native_tail import chain_penalties, map_batch_native
from .seeds import (collect_minimizers, collect_minimizers_device,
                    collect_native, collect_seed_hits,
                    collect_seed_hits_heap)
from .select import (gchain_drop_flt, gchain_flt_sub, gchain_set_mapq,
                     gchain_set_parent)
from .split import ShareSplit

U32 = 0xFFFFFFFF
# spliced chains: no preset of the command line sets the flag, and the
# port has no stage for it
UNSUPPORTED_FLAGS = MG_M_SPLICE
# output shapes the native GAF formatter of the per-read tail does not
# write: such reads are serialized by seqio/gaf.py (--cov: no GAF)
_EMIT_BAIL_FLAGS = (MG_M_CIGAR | MG_M_CAL_COV | MG_M_FRAG_MODE
                    | MG_M_FRAG_MERGE | MG_M_WRITE_LCHAIN | MG_M_WRITE_MZ
                    | MG_M_VERTEX_COOR)
# -c does not bail the batch: its workers run the base-level stage
# (CIGAR and ds) natively
_EMIT_BAIL_NOCIG = _EMIT_BAIL_FLAGS & ~MG_M_CIGAR
# the native batch writes merged pairs too; these shapes still bail
_EMIT_BAIL_BATCH = (MG_M_CAL_COV | MG_M_WRITE_LCHAIN | MG_M_WRITE_MZ
                    | MG_M_VERTEX_COOR)

# --seed-device: the seed stage of a long query (qlen_sum >= min_len,
# no --heap-sort) on the per-read path sketches through the chunk-halo
# sweep (index/midx_device.py) on `device` instead of the native
# collect.  The bytes are the same, so it is a routing decision only.
# Module state, as in the JAX package, because graph generation
# (`map_one`), the Python reader loop and the per-read fallback all
# reach map_frag; the lock keeps the reader threads' sweeps whole.
SEED_DEVICE = {"on": False, "min_len": 16384, "device": "cuda"}
_SEED_DEVICE_LOCK = threading.Lock()


def _batch_mode_ok(flag: int) -> bool:
    """Flag shapes the native batch tail can serialize."""
    if flag & _EMIT_BAIL_BATCH:
        return False
    if flag & MG_M_FRAG_MODE:
        # merged pairs only; -c with fragments stays on the per-read path
        if not (flag & MG_M_FRAG_MERGE) or (flag & MG_M_CIGAR):
            return False
    return True


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
    if opt.flag & UNSUPPORTED_FLAGS:
        raise NotImplementedError(
            f"mapping flags {opt.flag & UNSUPPORTED_FLAGS:#x} are not "
            "supported by the port yet")


def map_frag(gi: MinimizerIndex, qlens: List[int], seqs: List[str],
             opt: MapOptions, qname: Optional[str],
             fast_emit: bool = False,
             gwfa_pool=None) -> Optional[gchain.GChains]:
    """Map one fragment (n_segs query segments) to the graph; with a
    `gwfa_pool`, as map_frag_tail."""
    n_segs = len(qlens)
    qlen_sum = sum(qlens)
    if qlen_sum == 0 or n_segs <= 0 or n_segs > MG_MAX_SEG:
        return None
    if opt.max_qlen > 0 and qlen_sum > opt.max_qlen:
        return None
    if DBG["flag"] & MG_DBG_QNAME:
        sys.stderr.write(f"QR\t{qname}\t0\t{qlen_sum}\n")
    res = None
    seed_dev = (SEED_DEVICE["on"] and qlen_sum >= SEED_DEVICE["min_len"]
                and not (opt.flag & MG_M_HEAP_SORT))
    if n_segs == 1 and not (opt.flag & (MG_M_HEAP_SORT | MG_M_NO_DIAG)) \
            and not seed_dev and not DBG["flag"]:
        # whole seed stage in one native call (native/mgt_collect.c)
        res = collect_native(gi, opt, opt.occ_max1, seqs[0])
    if res is not None:
        ax, ay, rep_len, mini_pos, n_mv = res
    else:
        if seed_dev:
            with _SEED_DEVICE_LOCK:
                mv_x, mv_y = collect_minimizers_device(
                    gi, qlens, seqs, SEED_DEVICE["device"])
        else:
            mv_x, mv_y = collect_minimizers(gi, qlens, seqs)
        n_mv = len(mv_x)
        if opt.flag & MG_M_HEAP_SORT:
            ax, ay, rep_len, mini_pos = collect_seed_hits_heap(
                gi, opt, opt.occ_max1, mv_x, mv_y)
        else:
            ax, ay, rep_len, mini_pos = collect_seed_hits(
                gi, opt, opt.occ_max1, mv_x, mv_y, qname)
    return map_frag_tail(gi, qlens, seqs, opt, qname, ax, ay, rep_len,
                         mini_pos, n_mv, fast_emit=fast_emit,
                         gwfa_pool=gwfa_pool)


def map_frag_tail(gi: MinimizerIndex, qlens: List[int], seqs: List[str],
                  opt: MapOptions, qname: Optional[str],
                  ax: np.ndarray, ay: np.ndarray, rep_len: int,
                  mini_pos: np.ndarray, n_mv: int, chains_u=None,
                  cigar_sink=None, fast_emit: bool = False,
                  gwfa_pool=None) -> gchain.GChains:
    """Per-read pipeline after seed collection (map-algo.c:377-495).

    ax/ay are the read's anchors, or with `chains_u` the device front's
    compacted chains (u = sc<<32|cnt per chain), which skip the linear
    chain stage.  The whole tail runs in one native call; each native
    stage that bails hands the read to the next, more decomposed one.
    With -c and a `cigar_sink` (align/cigar_device.py CigarSink) the gaps
    the native walk cannot align are left to the sink's batch pool.  With
    a `gwfa_pool` the whole tail's bridges run on it; a GwfaBatchSink in
    its first phase defers the read: the call returns a GwfaPending."""
    n_segs = len(qlens)
    qlen_sum = sum(qlens)
    hash_ = kh_hash_str(qname) if qname else 0
    hash_ ^= (kh_hash_uint32(qlen_sum & U32) + kh_hash_uint32(opt.seed)) & U32
    hash_ &= U32
    hash_ = kh_hash_uint32(hash_)
    is_splice = bool(opt.flag & MG_M_SPLICE)
    if opt.flag & MG_M_SR:
        max_chain_gap_qry = max(qlen_sum, opt.max_gap)
    else:
        max_chain_gap_qry = opt.max_gap
    if opt.max_gap_ref > 0:
        max_chain_gap_ref = opt.max_gap_ref
    elif opt.max_frag_len > 0:
        max_chain_gap_ref = max(opt.max_frag_len - qlen_sum, opt.max_gap)
    else:
        max_chain_gap_ref = opt.max_gap
    chn_pen_gap, chn_pen_skip = chain_penalties(gi, opt)
    seq_cat = "".join(seqs)
    if DBG["flag"] & MG_DBG_SEED:
        _dump_seeds(gi, ax, ay, rep_len)
    # --dbg-qname: wall-clock stage times (print_time, map-algo.c:332-338)
    qt = time.time() if DBG["flag"] & MG_DBG_QNAME else None

    def stage_time(stage):
        nonlocal qt
        if qt is not None:
            t = time.time()
            sys.stderr.write(f"Q{stage}\t{qname}\t{t - qt:.3f}\n")
            qt = t

    # whole-tail native path (native/mgt_tail.c): linear chain + rescue
    # + lchain tail + graph chain + selection in ONE call
    if len(ax) > 0:
        if chains_u is not None:
            mode, mdx, mdy = 3, len(chains_u), 0
        elif opt.flag & MG_M_RMQ:
            mode, mdx, mdy = 2, opt.max_gap, 0
        else:
            mode, mdx, mdy = 1, max_chain_gap_ref, max_chain_gap_qry
        sel_args = (opt.mask_level, opt.pri_ratio, gi.k * 2,
                    opt.best_n, qlen_sum, n_mv, opt.min_gc_score,
                    rep_len)
        emit = None
        if fast_emit and n_segs == 1 and not (opt.flag & _EMIT_BAIL_FLAGS):
            emit = (qname or "", qlen_sum, opt.flag)
        gcs = gchain.map_tail_full(
            gi.g, gi.es, mode, chains_u, ax, ay, mini_pos, opt, qlen_sum,
            n_segs, mdx, mdy, chn_pen_gap, chn_pen_skip, hash_, seq_cat,
            sel_args, emit, gwfa_pool)
        if isinstance(gcs, GwfaPending):
            return gcs
        if gcs is not None:
            gcs.rep_len = rep_len
            return _map_frag_finish(gi, gcs, opt, qname, n_segs, seq_cat,
                                    qlen_sum, n_mv, cigar_sink)

    if chains_u is not None:
        # the device's chains: skip the linear chain stage
        n_lc = len(chains_u)
        u = np.ascontiguousarray(chains_u, dtype=np.uint64)
    elif len(ax) == 0:
        n_lc, u = 0, np.empty(0, dtype=np.uint64)
    elif opt.flag & MG_M_RMQ:
        ax, ay, n_lc, u = lchain.lchain_rmq(
            opt.max_gap, opt.max_gap_pre, opt.bw, opt.max_lc_skip,
            opt.rmq_size_cap, opt.min_lc_cnt, opt.min_lc_score,
            chn_pen_gap, chn_pen_skip, ax, ay)
    else:
        ax, ay, n_lc, u = lchain.lchain_dp(
            max_chain_gap_ref, max_chain_gap_qry, opt.bw, opt.max_lc_skip,
            opt.max_lc_iter, opt.min_lc_cnt, opt.min_lc_score,
            chn_pen_gap, chn_pen_skip, is_splice, n_segs, ax, ay)

    # long-join rescue re-chain (map-algo.c:407-417)
    if opt.bw_long > opt.bw and not (opt.flag & (MG_M_SPLICE | MG_M_SR)) \
            and n_segs == 1 and n_lc > 1:
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

    stage_time(1)
    # fused native tail (native/mgt_gchain.c): lchain_gen + filter
    # block + update_anchors in one call, chains kept as a table
    tab = None
    if n_lc and not (DBG["flag"] & MG_DBG_LCHAIN):
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
        if DBG["flag"] & MG_DBG_LCHAIN:
            _dump_lchain(gi, lc, ax, ay, qname)
    stage_time(2)

    gcs = None
    if tab is not None and qt is None:
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
        stage_time(3)
        gcs = gchain.gchain_gen_tab(gi.g, gi.es, n_gc, u, lc, ax, ay, hash_,
                                    opt.min_gc_cnt, opt.min_gc_score,
                                    opt.gdp_max_ed, n_segs, seq_cat)
    gcs.rep_len = rep_len
    stage_time(4)
    gcs = _map_frag_finish(gi, gcs, opt, qname, n_segs, seq_cat, qlen_sum,
                           n_mv, cigar_sink)
    if qt is not None:
        stage_time(5)
        # QM memory line (map-algo.c:485); no kalloc arenas here
        sys.stderr.write(f"QM\t{qname}\t{qlen_sum}\t"
                         "cap=0,nCore=0,largest=0\n")
    return gcs


def _map_frag_finish(gi, gcs, opt, qname, n_segs, seq_cat, qlen_sum, n_mv,
                     cigar_sink):
    """Selection + mapq + base alignment (map-algo.c:464-483), the
    selection skipped where the native tail already ran it
    (gcs.selected).  -c aligns single-segment reads only."""
    if not getattr(gcs, "selected", False):
        gchain_set_parent(opt.mask_level, gcs.gc, opt.sub_diff, 0)
        gchain_flt_sub(opt.pri_ratio, gi.k * 2, opt.best_n, gcs.gc)
        gchain_drop_flt(gcs)
        gchain_set_mapq(gcs, qlen_sum, n_mv, opt.min_gc_score)
    if (opt.flag & MG_M_CIGAR) and n_segs == 1:
        if cigar_sink is not None:
            cigar_sink.pending.append(harvest_read(
                gi.g, gi.es, seq_cat, gcs, qname, cigar_sink.jobs))
        else:
            gchain_cigar(gi.g, gi.es, seq_cat, gcs, qname)
            gchain_gen_ds(gi.g, gi.es, seq_cat, gcs)
    return gcs


def _dump_seeds(gi, ax, ay, rep_len):
    """--dbg-seed lines on stderr (map-algo.c:370-375)."""
    out = [f"RS\t{rep_len}"]
    for i in range(len(ax)):
        x, y = int(ax[i]), int(ay[i])
        gap = 0 if i == 0 else (_i32(y) - _i32(int(ay[i - 1]))) \
            - (_i32(x) - _i32(int(ax[i - 1])))
        out.append(f"SD\t{gi.g.seg[x >> 33].name}\t{_i32(x)}\t"
                   f"{'+-'[(x >> 32) & 1]}\t{_i32(y)}\t{(y >> 32) & 0xFF}"
                   f"\t{gap}")
    sys.stderr.write("\n".join(out) + "\n")


def _dump_lchain(gi, lc, ax, ay, qname):
    """--dbg-lchain lines on stdout (mg_print_lchain, format.c:90-119)."""
    out = []
    for p in lc:
        span = (int(ay[p.off]) >> 32) & 0xFF
        mlen = blen = span
        for j in range(1, p.cnt):
            ql_ = _i32(int(ay[p.off + j])) - _i32(int(ay[p.off + j - 1]))
            pl = _i32(int(ax[p.off + j])) - _i32(int(ax[p.off + j - 1]))
            blen += max(pl, ql_)
            mlen += span if (pl > span and ql_ > span) else min(pl, ql_)
        seg = gi.g.seg[p.v >> 1]
        row = [f"LC\t{qname}\t{p.qs}\t{p.qe}\t{'+-'[p.v & 1]}\t{seg.name}"
               f"\t{seg.len}\t{p.rs}\t{p.re}\t{p.score}\t{mlen}\t{blen}"
               f"\t{p.cnt}\t"]
        row.append("".join(f"{_i32(int(ay[p.off + j]))},"
                           for j in range(p.cnt)))
        row.append("\t")
        row.append("".join(f"{_i32(int(ax[p.off + j]))},"
                           for j in range(p.cnt)))
        row.append("\t")
        row.append("".join(f"{int(ay[p.off + j]) >> 56},"
                           for j in range(p.cnt)))
        out.append("".join(row))
    if out:
        sys.stdout.write("\n".join(out) + "\n")


def map_one(gi: MinimizerIndex, seq: str, opt: MapOptions,
            qname: Optional[str] = None) -> Optional[gchain.GChains]:
    return map_frag(gi, [len(seq)], [seq], opt, qname)


def _count(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _timed_native(stats, name, *args, **kw):
    """map_batch_native in the span `name` (tail.host_share,
    tail.device_share or tail.probe), its host time added to
    stats["tail_ms"]."""
    with trace.span(name) as sp:
        res = map_batch_native(*args, **kw)
    _count(stats, "tail_ms", sp.ms)
    return res


def _map_host_share(gi, opt, n_threads, split, stats, blob,
                    loop_thread=None):
    """The host share of an arena batch (every read not in the blob's
    skip list) in one native call; with a split (ShareSplit), its cost
    goes to split.host_cost.  loop_thread:
    the ident of a thread that runs other work meanwhile (the loop's,
    where this runs on the tail worker), whose CPU time the estimates
    leave out."""
    n, skipw = blob[0], blob[5]
    n_host = int(n - len(skipw))
    _count(stats, "n_share_host", n_host)
    if n_host == 0:
        return {}

    # with n_threads > 1 the workers are other threads: the summed
    # process CPU time is the single-thread cost the estimates compare
    def cpu_s():
        if n_threads == 1:
            return time.thread_time()
        c = time.process_time()
        if loop_thread is not None:
            c -= time.clock_gettime(time.pthread_getcpuclockid(loop_thread))
        return c
    c0 = cpu_s()
    t0 = time.perf_counter()
    res = _timed_native(stats, "tail.host_share", gi, opt, None, n_threads,
                        blob=blob[:5] + (skipw if len(skipw) else None,))
    if split is not None:
        cpu = cpu_s() - c0
        wall = time.perf_counter() - t0
        split.host_cost(wall if n_threads == 1 else max(wall, cpu), cpu,
                        n_host)
    return res


# reads of the front's smallest bucket a group of the device share gives
# each tail worker in C: enough that a group's native call pays its
# fixed cost (a few ms a call) over many reads, few enough that the
# first group's submit and the last group's tail, which nothing
# overlaps, stay short
TAIL_READS_PER_THREAD = 64


def _tail_groups(front, cand, qlen, n_threads):
    """The device share `cand` (arena indices in read order) cut into
    submit groups of whole bucket batches: each read in the front's
    bucket for it (the first (pad_len, bsz) of front.buckets that holds
    it), each bucket's reads cut into batches of bsz in read order, as
    front.submit cuts them, so that the groups' submits run the same
    batches as one submit of the whole share; the batches in the order
    of their first reads, and a group the fewest batches in a row whose
    reads weigh n_threads * TAIL_READS_PER_THREAD (the last group what
    is left).

    A read of a bucket of pad_len p weighs (p0 / p)^2, p0 the smallest
    bucket's pad_len.  A native call ends with its slowest read, and
    the tail's cost of a read, and its spread, grow faster than the
    read's length (on a 32 kb bucket's reads one took 250 times the
    median): a group of long reads has to be long for its slowest read
    to stay a small part of the call, and so the longer buckets' reads
    go to the card in few groups, or one."""
    pads = np.array([p for p, _ in front.buckets])
    bsz = dict(front.buckets)
    cand = np.asarray(cand, dtype=np.int64)
    where = np.searchsorted(pads, qlen[cand])     # the first pad >= qlen
    batches = []
    for b in np.unique(where):
        ks = cand[where == b].tolist()
        step = bsz[int(pads[b])]
        w = (pads[0] / pads[b]) ** 2
        batches += [(ks[i: i + step], w * len(ks[i: i + step]))
                    for i in range(0, len(ks), step)]
    batches.sort(key=lambda x: x[0][0])
    target = max(1, n_threads) * TAIL_READS_PER_THREAD
    groups, cur, weight = [], [], 0.0
    for ks, w in batches:
        cur += ks
        weight += w
        if weight >= target:
            groups.append(cur)
            cur, weight = [], 0.0
    if cur:
        groups.append(cur)
    return groups


def _submit_group(front, st, group):
    """Submit one group of the device share (asynchronous on the card);
    its wall, its span's interval and whether it ran cold go to st."""
    abuf, sq_off = st["abuf"], st["sq_off"]
    t0 = time.perf_counter()
    handle = front.submit(
        [abuf[int(sq_off[k]): int(sq_off[k + 1])] for k in group])
    st["sub_wall"] += time.perf_counter() - t0
    st["cold"] |= front.last_submit_cold
    sp = front.last_submit_span
    st["submits"].append((sp.t0, sp.t0 + sp.ns))
    return handle


def _open_split_submit(gi, opt, front, split, n_threads, n, sq_addr,
                       sq_off, nm_addr, nm_off, qlen, bad, cand, stats,
                       tails):
    """Phase 1 of the open host/device split for one arena batch: queue
    the host share's native call on the tail worker `tails` (it needs
    nothing from the card, so it runs while the loop submits), cut the
    device share `cand` (arena indices) into groups (_tail_groups) and
    submit the first (asynchronous on the card).  Returns the batch's
    state for _open_split_finish."""
    # host share: everything not sent to the device
    host_skip = np.asarray(bad).copy()
    host_skip[cand] = True
    skipw = np.nonzero(host_skip)[0]
    _count(stats, "n_share_dev", len(cand))
    blob = (n, sq_addr, sq_off, nm_addr, nm_off)
    st = {"n": n, "blob": blob, "sq_off": sq_off, "cand": cand,
          "tails": tails, "groups": [], "handle": None, "sub_wall": 0.0,
          "cold": False, "submits": [], "host_job": None}
    if n > len(skipw):
        st["host_job"] = tails.put(_map_host_share, gi, opt, n_threads,
                                   split, stats, blob + (skipw,),
                                   loop_thread=threading.get_ident())
    else:       # no host read, no native call: nothing for the worker
        st["host_res"] = _map_host_share(gi, opt, n_threads, split, stats,
                                         blob + (skipw,))
    if cand:
        total = int(sq_off[-1])
        st["abuf"] = np.frombuffer(
            (ct.c_char * total).from_address(sq_addr), dtype=np.uint8)
        st["groups"] = _tail_groups(front, cand, qlen, n_threads)
        st["handle"] = _submit_group(front, st, st["groups"][0])
    return st


def _open_split_finish(gi, opt, front, split, n_threads, st, stats):
    """Phase 2: for each group, submit it (the first is submitted),
    gather it and queue its device-share tail on the tail worker, so
    that the tail runs while the next group is submitted; then wait for
    the worker, merge the results, count the submits' overlap with the
    tails, hand the device share's cost and the batch's end to the
    split and return the batch's results.  The gather waits for
    the group's copy, which trails its last launch by little: the card
    runs a group's stages as they are launched, and the host's submit
    is the longer part.  The worker touches arena bytes and numpy views
    only: every torch call, event and staging lease stays on this
    thread."""
    n, cand, groups = st["n"], st["cand"], st["groups"]
    tails = st["tails"]
    jobs = []           # (job, the group's views) a group
    gather_wall = 0.0
    handle = st.pop("handle")
    for j, group in enumerate(groups):
        if j:
            handle = _submit_group(front, st, group)
        t0 = time.perf_counter()
        # batch arrays (gather_flat): the pointer tables fill with
        # vectorized numpy, no per-read Python
        garr = np.asarray(group)
        fr_flat = [(garr[sel], fb) for sel, fb in front.gather_flat(handle)]
        dev_skip = np.ones(n, dtype=bool)
        dev_skip[garr] = False
        dskipw = np.nonzero(dev_skip)[0]
        gather_wall += time.perf_counter() - t0
        # the front's chains where it delivered them, the in-worker
        # collect where it flagged a read, never the per-read path
        jobs.append((tails.put(_timed_native, stats, "tail.device_share",
                               gi, opt, None, n_threads,
                               blob=st["blob"] + (
                                   dskipw if len(dskipw) else None,),
                               fr_flat=fr_flat), fr_flat))
    host_job = st["host_job"]
    calls = [job for job, _ in jobs]
    if host_job is not None:
        calls.insert(0, host_job)
    tails.wait(calls)
    res = st["host_res"] if host_job is None else host_job.result
    tail_ns = 0
    for (job, _), group in zip(jobs, groups):
        for k in group:
            res[k] = job.result.get(k)
        tail_ns += job.t1 - job.t0
    # the submits' spans against the worker's calls (one thread: the
    # calls do not overlap each other)
    _count(stats, "submit_tail_overlap_ms", sum(
        max(0, min(b, job.t1) - max(a, job.t0)) for a, b in st["submits"]
        for job in calls) / 1e6)
    _count(stats, "n_tail_groups", len(groups))
    split.device_cost(st["sub_wall"] + gather_wall + tail_ns / 1e9,
                      len(cand), st["cold"])
    split.end_batch(n)
    return res


def _map_arena_frags(gi, opt, out, n_threads, n, sq_addr, sq_off, nm_addr,
                     nm_off, stats):
    """One frag-mode arena batch through the native batch tail.

    Fragments are runs of same-name records (mates adjacent in the
    arena), grouped in C; a pair is one batch item spanning both mates
    with the boundary in seg_mid, and the pair orientation flips
    (gmap.c:38-43) are applied in place on the arena bytes, so a read
    that falls to the per-read path sees them too."""
    lib = get_lib()
    if not getattr(_map_arena_frags, "_cfg", False):
        lib.mgt_frag_group.restype = ct.c_int64
        lib.mgt_frag_group.argtypes = [ct.c_void_p, ct.c_void_p,
                                       ct.c_int64, ct.c_void_p]
        lib.mgt_revcomp_spans.restype = None
        lib.mgt_revcomp_spans.argtypes = [ct.c_void_p, ct.c_void_p,
                                          ct.c_void_p, ct.c_int64]
        _map_arena_frags._cfg = True
    first = np.empty(n + 1, dtype=np.int64)
    nf = lib.mgt_frag_group(ct.c_void_p(nm_addr),
                            ct.c_void_p(nm_off.ctypes.data), n,
                            ct.c_void_p(first.ctypes.data))
    first = first[:nf + 1]
    f0 = first[:-1]
    qso = np.ascontiguousarray(sq_off[first])
    qno = np.ascontiguousarray(nm_off[first])
    n_seg = np.ascontiguousarray(np.diff(first))
    qname_len = np.ascontiguousarray(nm_off[f0 + 1] - nm_off[f0])
    seg_mid = np.zeros(nf, dtype=np.int64)
    two = n_seg == 2
    seg_mid[two] = sq_off[f0[two] + 1]
    qsum = qso[1:] - qso[:-1]
    skip = (qsum <= 0) | (n_seg > 2)
    if opt.max_qlen > 0:
        skip = skip | (qsum > opt.max_qlen)
    i2 = f0[two & ~skip]
    if len(i2):
        for flip, mate in ((opt.pe_ori >> 1 & 1, 0), (opt.pe_ori & 1, 1)):
            if flip:
                st = np.ascontiguousarray(sq_off[i2 + mate])
                en = np.ascontiguousarray(sq_off[i2 + mate + 1])
                lib.mgt_revcomp_spans(ct.c_void_p(sq_addr),
                                      ct.c_void_p(st.ctypes.data),
                                      ct.c_void_p(en.ctypes.data), len(i2))
    skipw = np.nonzero(skip)[0]
    res = _timed_native(stats, "tail.host_share", gi, opt, None, n_threads,
                        blob=(nf, sq_addr, qso, nm_addr, qno,
                              skipw if len(skipw) else None),
                        frag_blob=(n_seg, seg_mid, qname_len))
    n_perread = 0
    for j in range(nf):
        txt = res.get(j)
        if txt is None:
            fj, ns = int(first[j]), int(n_seg[j])
            name = ct.string_at(nm_addr + int(nm_off[fj]),
                                int(qname_len[j])).decode("latin-1")
            seqs = [ct.string_at(sq_addr + int(sq_off[fj + k]),
                                 int(sq_off[fj + k + 1] - sq_off[fj + k]))
                    .decode("latin-1") for k in range(ns)]
            qlens = [len(x) for x in seqs]
            gcs = map_frag(gi, qlens, seqs, opt, name,
                           fast_emit=not (opt.flag & MG_M_CIGAR))
            txt = write_gaf(gi.g, gcs, ns, qlens, name, opt.flag)
            n_perread += not skip[j]
        if txt:
            out.write(txt)
    _count(stats, "n_perread", n_perread)


def _arena_batches(rdr, max_bp, frag_mode=False):
    """One-batch read-ahead over the native reader arenas.

    The C reader keeps three arena sets, so a prefetch thread can decode
    batch k+1 while batch k maps and batch k-1 finishes.  The semaphore
    holds the prefetcher one batch ahead, never two: reading k+2 would
    recycle batch k-1's arena under the consumer."""
    import queue
    import threading

    tokens = threading.Semaphore(2)
    q = queue.Queue()
    stop = []

    def worker():
        while True:
            tokens.acquire()
            if stop:
                return
            try:
                with trace.span("read.arena"):
                    a = rdr.read_batch_arena(max_bp, frag_mode)
            except Exception as e:          # re-raised on the consumer
                q.put(("err", e))
                return
            q.put(("ok", a))
            if a is None:
                return

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    try:
        while True:
            with trace.span("loop.read_wait"):
                kind, a = q.get()
            if kind == "err":
                raise a
            if a is None:
                return
            yield a
            tokens.release()
    finally:
        stop.append(True)
        tokens.release()
        th.join()


class _TailJob:
    """A call queued on a _TailWorker: `result` and the call's interval
    on the worker (t0, t1: perf_counter_ns) once `done` is set."""
    __slots__ = ("call", "result", "t0", "t1", "done")

    def __init__(self, call):
        self.call = call
        self.result = None
        self.t0 = self.t1 = 0
        self.done = threading.Event()


class _TailWorker:
    """One thread that runs the open split's native tail calls in the
    order they were queued; each call releases the GIL and runs its own
    n_threads workers in C.  The queuing thread keeps every torch call:
    a call gets arena bytes and numpy views only, and drops its
    arguments before it reports done, so that the views of the front's
    pinned staging buffers are given back on the queuing thread, which
    holds them until it has waited.  A call's exception is raised on
    the queuing thread by the next put or wait, and the calls queued
    after it are skipped; close() skips what is still queued and joins
    the thread once the running call has returned.

    A call needs the GIL to start and again as its C work returns, and
    the queuing thread holds it through the front's Python: at the
    interpreter's default switch interval (5 ms) the tail's C workers
    sat idle up to 5 ms a call between groups.  While the worker lives,
    the interval is SWITCH_S."""
    SWITCH_S = 0.0005

    def __init__(self):
        import queue
        self._q = queue.Queue()
        self._err = None
        self._stop = False
        self._switch = sys.getswitchinterval()
        sys.setswitchinterval(min(self._switch, self.SWITCH_S))
        self._th = threading.Thread(target=self._run, name="mgt-tail",
                                    daemon=True)
        self._th.start()

    def _run(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            fn, args, kw = job.call
            job.call = None
            if not (self._stop or self._err is not None):
                job.t0 = time.perf_counter_ns()
                try:
                    job.result = fn(*args, **kw)
                except BaseException as e:      # raised on the queuing thread
                    self._err = e
                job.t1 = time.perf_counter_ns()
            del fn, args, kw
            job.done.set()

    def _raise(self):
        if self._err is not None:
            raise self._err

    def put(self, fn, *args, **kw) -> _TailJob:
        self._raise()
        job = _TailJob((fn, args, kw))
        self._q.put(job)
        return job

    def wait(self, jobs) -> None:
        for job in jobs:
            job.done.wait()
            self._raise()

    def close(self) -> None:
        self._stop = True
        self._q.put(None)
        self._th.join()
        sys.setswitchinterval(self._switch)


def _map_file_native(gi, opt, rdr, out, n_threads, front=None, split=None,
                     stats=None, frag_mode=False, tails=None):
    """All-native single-file loop: C reader arenas -> native batch tail
    -> GAF text; Python touches only reads that take the per-read path
    (engine bails, zero-length, over max_qlen).  In frag mode each arena
    batch maps as fragments (_map_arena_frags; no device front).

    With a device front (front and split, a ShareSplit, given) the loop
    runs the open split until the controller collapses it; collapsed,
    it maps every read on the host, and a probe batch's device reads
    are submitted before the host call, so the device runs while the
    host maps, and handed to the native tail after it.
    `tails`: the open split's _TailWorker (with a front), idle again
    whenever the loop takes the next arena batch (the prefetch recycles
    batch k-1's arena while batch k+1 maps)."""

    def _emit_batch(res, n, rec, bad):
        """Write a batch's results in read order; a None entry (a
        native bail, or a read the native path does not take) is mapped
        on the exact per-read path."""
        n_perread = 0
        with trace.span("loop.emit"):
            for k in range(n):
                txt = res.get(k)
                if txt is None:
                    name, seq = rec(k)
                    gcs = map_frag(gi, [len(seq)], [seq], opt, name,
                                   fast_emit=not (opt.flag & MG_M_CIGAR))
                    txt = write_gaf(gi.g, gcs, 1, [len(seq)], name,
                                    opt.flag)
                    n_perread += not bad[k]
                if txt:
                    out.write(txt)
        _count(stats, "n_perread", n_perread)

    for n, sq_addr, sq_off, nm_addr, nm_off in _arena_batches(
            rdr, opt.mini_batch_size, frag_mode):
        _count(stats, "n_arena", 1)
        if frag_mode:
            _map_arena_frags(gi, opt, out, n_threads, n, sq_addr, sq_off,
                             nm_addr, nm_off, stats)
            continue
        qlen = sq_off[1:] - sq_off[:-1]
        bad = qlen <= 0
        if opt.max_qlen > 0:
            bad = bad | (qlen > opt.max_qlen)

        def rec(k):
            name = ct.string_at(
                nm_addr + int(nm_off[k]),
                int(nm_off[k + 1] - nm_off[k])).decode("latin-1")
            seq = ct.string_at(
                sq_addr + int(sq_off[k]),
                int(sq_off[k + 1] - sq_off[k])).decode("latin-1")
            return name, seq

        cand = []
        if front is not None:
            elig = [k for k in range(n) if not bad[k]
                    and front.eligible(opt, 1, int(qlen[k]))]
            n_dev = split.plan(n, len(elig))
            if not split.collapsed:
                # open split: the host share and the device share's
                # groups through the tail worker, idle again before the
                # results are emitted, in read order
                st = _open_split_submit(gi, opt, front, split, n_threads,
                                        n, sq_addr, sq_off, nm_addr, nm_off,
                                        qlen, bad, elig[len(elig) - n_dev:],
                                        stats, tails)
                res = _open_split_finish(gi, opt, front, split, n_threads,
                                         st, stats)
                _emit_batch(res, n, rec, bad)
                continue
            cand = elig[:n_dev]         # a probe's reads, if any

        skip = bad
        if cand:
            t_sub0 = time.perf_counter()
            handle = front.submit([rec(k)[1] for k in cand])
            sub_wall = time.perf_counter() - t_sub0
            probe_cold = front.last_submit_cold
            skip = skip.copy()
            skip[cand] = True
            _count(stats, "n_probes", 1)
            _count(stats, "n_share_dev", len(cand))
        res = _map_host_share(gi, opt, n_threads, split, stats,
                              (n, sq_addr, sq_off, nm_addr, nm_off,
                               np.nonzero(skip)[0]))
        if cand:
            t0 = time.perf_counter()
            garr = np.asarray(cand)
            fr_flat = [(garr[sel], fb)
                       for sel, fb in front.gather_flat(handle)]
            # the probe's reads through the native tail: the front's
            # chains or anchors where it delivered them, the in-worker
            # collect where it flagged a read
            pskip = np.ones(n, dtype=bool)
            pskip[cand] = False
            ptxt = _timed_native(stats, "tail.probe", gi, opt, None,
                                 n_threads,
                                 blob=(n, sq_addr, sq_off, nm_addr, nm_off,
                                       np.nonzero(pskip)[0]),
                                 fr_flat=fr_flat)
            if fr_flat:
                split.device_cost(sub_wall + time.perf_counter() - t0,
                                  len(cand), probe_cold)
            for k in cand:
                res[k] = ptxt.get(k)
        if front is not None:
            split.end_batch(n)
        _emit_batch(res, n, rec, bad)


def _read_batch_frag(fps, chunk_size: int):
    """Interleaved multi-file reading (mg_bseq_read_frag,
    bseq.c:100-128): one record of each file in turn."""
    out = []
    size = 0
    while True:
        recs = []
        for fp in fps:
            r = fp._next()
            if r is not None:
                recs.append(r)
        if len(recs) < len(fps):
            if recs:
                sys.stderr.write("[W] query files have different number of "
                                 "records; extra records skipped.\n")
            break
        out.extend(recs)
        size += sum(r.l_seq for r in recs)
        if size >= chunk_size:
            break
    return out


# --- the fork pool (kt_for's analog; the index shared copy-on-write) ---
_POOL_CTX = {}


def _pool_worker_map(item):
    off, qname, seqs = item
    gi, opt = _POOL_CTX["gi"], _POOL_CTX["opt"]
    qlens = [len(s) for s in seqs]
    return off, map_frag(gi, qlens, seqs, opt, qname,
                         fast_emit=_POOL_CTX["fast_emit"])


def fork_refused(gwfa_pool=None) -> Optional[str]:
    """Why this process may not fork its mapping workers, or None.  A
    CUDA context does not survive a fork, so the pool runs only where
    this process holds none and the workers' route touches no card: not
    with --seed-device or the GWFA pool on the card."""
    if torch.cuda.is_initialized():
        return "this process holds a CUDA context"
    if SEED_DEVICE["on"] and torch.device(SEED_DEVICE["device"]).type \
            == "cuda":
        return "--seed-device sketches on the card"
    if gwfa_pool is not None and gwfa_pool.device.type == "cuda":
        return "the GWFA pool runs on the card"
    return None


def _map_fragments_parallel(gi, opt, items, n_threads, fast_emit=True):
    """Map fragments across a fork pool; results in input order.

    items: list of (off, qname, [seqs]).  The reads are independent and
    their order is restored, so the results equal the sequential path's
    (kt_for, kthread.c:30-52).  fast_emit as the sequential caller maps
    (graph generation reads the chains, not the GAF text: False).
    Callers check fork_refused() first."""
    import multiprocessing as mp
    _POOL_CTX.update(gi=gi, opt=opt, fast_emit=fast_emit)
    try:
        with mp.get_context("fork").Pool(n_threads) as pool:
            results = pool.map(_pool_worker_map, items,
                               chunksize=max(1, len(items) // (n_threads * 4)))
    finally:
        _POOL_CTX.clear()
    return [gcs for _, gcs in sorted(results, key=lambda x: x[0])]


def flip_pair(batch, off, pe_ori: int) -> None:
    """Pair orientation (gmap.c:38-43): reverse-complement the mates of
    the pair at batch[off] as pe_ori asks."""
    if pe_ori >> 1 & 1:
        batch[off].seq = revcomp(batch[off].seq)
    if pe_ori & 1:
        batch[off + 1].seq = revcomp(batch[off + 1].seq)


def frag_records(gi, opt, batch, off, n_seg, qlens, gcs_list, cov) -> str:
    """The GAF text of one mapped fragment (its segments batch[off],
    ...; gcs_list one GChains for the fragment or one a segment), or
    with `cov` = (c_seg, c_link) its coverage added there and ""."""
    def one(gcs, n, ql, name):
        if cov is not None:
            cov_map(gi.g, gcs, opt.min_cov_mapq, opt.min_cov_blen, *cov,
                    name)
            return ""
        return write_gaf(gi.g, gcs, n, ql, name, opt.flag)

    if (opt.flag & MG_M_FRAG_MODE) and (opt.flag & MG_M_FRAG_MERGE):
        return one(gcs_list[0], n_seg, qlens, batch[off].name)
    parts = []
    for k in range(n_seg):
        t = batch[off + k]
        gck = gcs_list[k] if len(gcs_list) > 1 else \
            (gcs_list[0] if k == 0 else None)
        parts.append(one(gck, 1, [t.l_seq], t.name))
    return "".join(parts)


def _map_file_frag(gi, fns: List[str], opt: MapOptions, out,
                   n_threads: int = 1, front=None, stats=None,
                   gwfa_pool=None, cov=None) -> None:
    """The read -> map -> write loop of one file, or of a group of
    files read in step (gmap.c:66-177).

    A single file the native reader opens, whose output the native
    batch writes, goes to the all-native loop (`_map_file_native`;
    fragments only without a device front).  The rest is read here: one
    batch ahead (`_read_prep` submits batch k+1 to the device before
    batch k's tails run), fragments grouped by name, with a device
    front an adaptive share of the eligible reads mapped on the host in
    a background thread (`host_pool`) while the device runs the others;
    without one, the whole batch in one native host call where the
    batch can write it.  What neither takes (pairs with a front, the
    output shapes the batch cannot write, -D) maps on the per-read
    path, in threads when a front runs and several are asked for.

    With a `gwfa_pool` every read maps on the per-read path, whose tail
    bridges on the pool (no native loop, no host share, no native batch):
    per read with a front, through a GwfaBatchSink for the whole batch
    without one.  With `cov` = (c_seg, c_link) the reads' chains add to
    the coverage instead of writing GAF."""
    from concurrent.futures import ThreadPoolExecutor

    frag_mode = len(fns) > 1 or bool(opt.flag & MG_M_FRAG_MODE)
    split = None
    # a debug bit keeps every read on the per-read path, where the dumps
    # are written: no native loop, no split, no native batch, no threads
    dbg = DBG["flag"]
    if front is not None and gwfa_pool is None and not dbg \
            and not (opt.flag & _EMIT_BAIL_NOCIG):
        split = getattr(front, "_split_state", None)
        if split is None:
            split = front._split_state = ShareSplit()
    if (gwfa_pool is None and not dbg and len(fns) == 1
            and (not frag_mode or front is None)
            and _batch_mode_ok(opt.flag)
            and not (opt.flag & (MG_M_INDEPEND_SEG | MG_M_NO_DIAG))
            and (front is None or split is not None)):
        try:
            rdr = NativeSeqReader(fns[0])
        except OSError:
            rdr = None
        if rdr is not None:
            tails = _TailWorker() if front is not None else None
            try:
                _map_file_native(gi, opt, rdr, out, n_threads, front, split,
                                 stats, frag_mode, tails)
            finally:
                # the worker's running call reads the reader's arenas
                if tails is not None:
                    tails.close()
                rdr.close()
            return

    fps = [BSeqFile(fn) for fn in fns]
    pe_ori = opt.pe_ori
    split_ok = (front is not None and gwfa_pool is None and not dbg
                and not (opt.flag & (_EMIT_BAIL_NOCIG | MG_M_HEAP_SORT
                                     | MG_M_INDEPEND_SEG | MG_M_NO_DIAG)))
    if not split_ok:
        split = None
    host_pool = ThreadPoolExecutor(max_workers=1) if split_ok else None
    host_batch_ok = (front is None and gwfa_pool is None and not dbg
                     and _batch_mode_ok(opt.flag)
                     and not (opt.flag & (MG_M_INDEPEND_SEG
                                          | MG_M_NO_DIAG)))

    def _host_batch_timed(items):
        # the thread's own CPU time (the one-thread native call runs in
        # this thread) is the host's per-read cost free of contention
        # with the device path's host work
        c0 = time.thread_time()
        with trace.span("tail.host_share") as sp:
            txt = map_batch_native(gi, opt, items, 1, host_collect=True)
        return (txt, sp.ns / 1e9, time.thread_time() - c0, len(items))

    def _read_prep():
        """Read, group and submit the next batch: the device launches
        are asynchronous, so batch k+1 runs on the device while the host
        finishes batch k (kt_pipeline, gmap.c:66-177)."""
        if len(fps) > 1:
            batch = _read_batch_frag(fps, opt.mini_batch_size)
        else:
            batch = fps[0].read_batch(opt.mini_batch_size, frag_mode)
        if not batch:
            return None
        for r in batch:
            r.seq = toupper(r.seq)
        # fragments: runs of same-name records in frag mode
        frags = []
        j = 0
        for i in range(1, len(batch) + 1):
            if i == len(batch) or not frag_mode \
                    or not qname_same(batch[i - 1].name, batch[i].name):
                frags.append((j, i - j))
                j = i
        handle = front_idx = host_fut = None
        sub_wall, cold = 0.0, False
        if front is not None:
            front_idx = [fi for fi, (off, n_seg) in enumerate(frags)
                         if front.eligible(opt, n_seg, batch[off].l_seq)]
            if host_pool is not None:
                # ineligible single-segment reads always take the host
                # batch; an adaptive share of the eligible ones joins them
                elig = set(front_idx)
                host_set = [
                    fi for fi, (off, n_seg) in enumerate(frags)
                    if n_seg == 1 and batch[off].l_seq > 0
                    and fi not in elig
                    and not (opt.max_qlen > 0
                             and batch[off].l_seq > opt.max_qlen)]
                n_steal = len(front_idx) - split.plan(len(frags),
                                                      len(front_idx))
                if split.collapsed and n_steal < len(front_idx):
                    _count(stats, "n_probes", 1)
                if n_steal > 0:
                    host_set += front_idx[:n_steal]
                    front_idx = front_idx[n_steal:]
                if host_set:
                    _count(stats, "n_share_host", len(host_set))
                    items = [(fi, batch[frags[fi][0]].name,
                              batch[frags[fi][0]].seq, None)
                             for fi in sorted(host_set)]
                    host_fut = host_pool.submit(_host_batch_timed, items)
            if front_idx:
                _count(stats, "n_share_dev", len(front_idx))
                t_sub0 = time.perf_counter()
                handle = front.submit(
                    [batch[frags[fi][0]].seq for fi in front_idx])
                # the submit's host cost is part of a device read's
                # price, charged to t_dev at the batch's gather
                sub_wall = time.perf_counter() - t_sub0
                cold = front.last_submit_cold
        return batch, frags, handle, front_idx, host_fut, sub_wall, cold

    def flip(batch, off):
        flip_pair(batch, off, pe_ori)

    # the fork pool's workers (the JAX package's eff_threads): none with
    # a front, whose batches replace it, or where the native batch runs
    pool_threads = 1 if front is not None or host_batch_ok \
        else min(n_threads, os.cpu_count() or 1)
    fork_logged = False

    try:
        cur = _read_prep()
        while cur is not None:
            batch, frags, handle, front_idx, host_fut, sub_wall, cold = cur
            cur = _read_prep()  # device and input run ahead of the tails
            front_res = None
            t_dev0 = time.perf_counter()
            if handle is not None:
                front_res = dict(zip(front_idx, front.gather(handle)))
            # the fork pool where the JAX package forks one (no front, no
            # native batch, several threads, not -D's independent
            # segments) and no card is in the way (fork_refused); its
            # results come before any other route's
            pre = None
            flips_done = False
            if pool_threads > 1 and not (opt.flag & MG_M_INDEPEND_SEG):
                refused = fork_refused(gwfa_pool)
                if refused is None:
                    items = []
                    for off, n_seg in frags:
                        if n_seg == 2:
                            flip(batch, off)
                        items.append((off, batch[off].name,
                                      [batch[off + k].seq
                                       for k in range(n_seg)]))
                    flips_done = True
                    pre = _map_fragments_parallel(gi, opt, items,
                                                  pool_threads)
                elif not fork_logged:
                    fork_logged = True
                    mlog("map_file_frag", f"no fork pool for -t "
                         f"{n_threads}: {refused}; mapping in this "
                         f"process")
            # whole-batch native tails: anchors -> GAF text in one call,
            # the per-read path only for what it cannot take
            batch_txt = None
            if front_res and gwfa_pool is None \
                    and not (opt.flag & _EMIT_BAIL_NOCIG):
                items = [(fi, batch[frags[fi][0]].name,
                          batch[frags[fi][0]].seq, fr)
                         for fi, fr in front_res.items()
                         if fr is not None and frags[fi][1] == 1]
                batch_txt = _timed_native(stats, "tail.device_share", gi,
                                          opt, items, n_threads)
                if split is not None:
                    split.device_cost(
                        sub_wall + time.perf_counter() - t_dev0, len(items),
                        cold)
                # reads the front flagged: the native host path
                flagged = [(fi, batch[frags[fi][0]].name,
                            batch[frags[fi][0]].seq, None)
                           for fi, fr in front_res.items() if fr is None]
                if flagged:
                    batch_txt.update(_timed_native(
                        stats, "tail.device_share", gi, opt, flagged,
                        n_threads, host_collect=True))
            elif host_batch_ok:
                items = []
                for fi, (off, n_seg) in enumerate(frags):
                    if n_seg > 2:
                        continue
                    qsum = sum(batch[off + k].l_seq for k in range(n_seg))
                    if qsum == 0 or (opt.max_qlen > 0
                                     and qsum > opt.max_qlen):
                        continue
                    if n_seg == 2:
                        flip(batch, off)
                        items.append((fi, batch[off].name,
                                      (batch[off].seq, batch[off + 1].seq),
                                      None))
                    else:
                        items.append((fi, batch[off].name, batch[off].seq,
                                      None))
                flips_done = True
                if items:
                    batch_txt = _timed_native(stats, "tail.host_share",
                                              gi, opt, items, n_threads,
                                              host_collect=True)
            if host_fut is not None:
                h_txt, h_wall, h_cpu, h_n = host_fut.result()
                _count(stats, "tail_ms", h_wall * 1e3)
                batch_txt = h_txt if batch_txt is None \
                    else {**batch_txt, **h_txt}
                split.host_cost(h_wall, h_cpu, h_n)
            if split is not None:
                split.end_batch(len(frags))
            if batch_txt is not None:
                _count(stats, "n_perread", sum(
                    1 for v in batch_txt.values() if v is None))
            # -c on the device front's reads where no batch wrote them
            # (--vc, -S): the gaps the native walk cannot align go to one
            # pool for the batch (align/cigar_device.py)
            cigar_sink = None
            if front_res and batch_txt is None and (opt.flag & MG_M_CIGAR):
                cigar_sink = CigarSink()

            def compute_frag(fi, off, n_seg, gp=gwfa_pool):
                if not flips_done and n_seg == 2:
                    flip(batch, off)
                seqs = [batch[off + k].seq for k in range(n_seg)]
                qlens = [len(x) for x in seqs]
                fr = front_res.get(fi) if front_res is not None else None
                fast = cigar_sink is None
                if pre is not None:
                    gcs_list = [pre[fi]]
                elif fr is not None:
                    gcs_list = [map_frag_tail(
                        gi, qlens, seqs, opt, batch[off].name, fr.ax,
                        fr.ay, fr.rep_len, fr.mini_pos, fr.n_mv,
                        chains_u=fr.u, cigar_sink=cigar_sink,
                        fast_emit=fast, gwfa_pool=gp)]
                elif opt.flag & MG_M_INDEPEND_SEG:
                    gcs_list = [map_frag(gi, [qlens[k]], [seqs[k]], opt,
                                         batch[off + k].name,
                                         fast_emit=fast, gwfa_pool=gp)
                                for k in range(n_seg)]
                else:
                    gcs_list = [map_frag(gi, qlens, seqs, opt,
                                         batch[off].name, fast_emit=fast,
                                         gwfa_pool=gp)]
                return qlens, gcs_list

            def emit_frag(off, n_seg, qlens, gcs_list):
                out.write(frag_records(gi, opt, batch, off, n_seg, qlens,
                                       gcs_list, cov))

            todo = [fi for fi in range(len(frags))
                    if batch_txt is None or batch_txt.get(fi) is None]
            if cigar_sink is not None:
                # harvest every read, align the batch's pooled gaps once,
                # then stitch each read's CIGARs and ds strings
                done = {fi: compute_frag(fi, *frags[fi]) for fi in todo}
                if front._wfa_pool is None:
                    front._wfa_pool = DeviceWfaPool(device=front.device)
                res = front._wfa_pool.run(cigar_sink.jobs)
                for pr in cigar_sink.pending:
                    finalize_read(pr, res)
            elif front is not None and n_threads > 1 and len(todo) > 1 \
                    and not dbg:
                # the native tails release the GIL, so the per-read path
                # scales over threads; emission stays in input order
                with ThreadPoolExecutor(
                        max_workers=min(n_threads, 16)) as ex:
                    done = {fi: ex.submit(compute_frag, fi, *frags[fi])
                            for fi in todo}
                    done = {fi: f.result() for fi, f in done.items()}
            elif gwfa_pool is not None and front is None:
                # cross-read pooling: harvest every read's bridge jobs
                # (phase 1), one pool call for the batch, then map the
                # deferred reads again with their results (phase 2)
                sink = GwfaBatchSink(gwfa_pool)
                done = {fi: compute_frag(fi, *frags[fi], gp=sink)
                        for fi in todo}
                flips_done = True       # the second pass must not re-flip
                sink.solve()
                for fi in todo:
                    tickets = [gc.ticket for gc in done[fi][1]
                               if isinstance(gc, GwfaPending)]
                    if tickets:
                        sink.queue_inject(tickets)
                        done[fi] = compute_frag(fi, *frags[fi], gp=sink)
            else:
                # each read is written as soon as it is mapped, so what
                # the stages write to stdout (--dbg-lchain) stays in
                # step with the records, as in the JAX package
                done = {}
            for fi, (off, n_seg) in enumerate(frags):
                if fi in done:
                    emit_frag(off, n_seg, *done[fi])
                elif batch_txt is None or batch_txt.get(fi) is None:
                    emit_frag(off, n_seg, *compute_frag(fi, off, n_seg))
                else:
                    out.write(batch_txt[fi])
    finally:
        if host_pool is not None:
            host_pool.shutdown(wait=True)
        for fp in fps:
            fp.close()


def map_reads(gi: MinimizerIndex, opt: MapOptions, fns: List[str],
              out=sys.stdout, n_threads: int = 1, front=None,
              stats: Optional[dict] = None, gwfa_pool=None,
              cov=None) -> None:
    """Map each query file against an index (the loop of mg_map_files);
    in frag mode with several files, the files in step as one group.

    front: a DeviceFront on `gi`, or None to map every read on the host.
    The split's learned state (mapping/split.py ShareSplit) lives on the
    front as front._split_state and carries over from file to file; a
    caller may set it before the first file, e.g. ShareSplit(share=0.0)
    to send every eligible read to the device.  That pin holds only while
    every read is eligible: the host measures no cost while it maps no
    eligible read, and the share stays until both costs have been
    measured; a pinned caller checks stats["n_share_host"] == 0.
    `stats`, when given, receives the mapping wall time (map_ms), the
    native tail's host time (tail_ms), the reads whose native tail
    bailed and were mapped again on the per-read path (n_perread), the
    native loop's arena batches (n_arena), the reads sent to the device
    and host shares (n_share_dev, n_share_host), the device probes
    (n_probes), and with a front the final share and collapsed (where
    the loop ran a split), the front's counters (of them its bucket
    batches, n_batches: replayed from CUDA graphs, n_step_replays, and
    run eagerly on the card, n_step_eager) and per-stage device times
    (stage_ms).  It also receives the process's totals of the
    spans (utils/trace.py; span_ms, span_n: ms and calls by name), the
    open split's groups (n_tail_groups) and submit_tail_overlap_ms (the
    ms of the front's submits during which the tail worker ran a native
    call, counted once each arena batch has ended), and the hash join's
    collect counts (collect_probed, collect_anchor_slots: DeviceFront's)
    with its table's words a slot (table_slot_words).  gwfa_pool: a
    DeviceGwfaPool on `gi` for the bridges of the graph-chain stage
    (every read then maps on the per-read path); cov: (c_seg, c_link)
    float64 arrays the reads' coverage adds to (--cov), instead of
    GAF."""
    _check_options(opt)
    if front is not None and stats is not None:
        for key in ("n_share_dev", "n_share_host"):
            stats.setdefault(key, 0)
    groups = [fns] if (opt.flag & MG_M_FRAG_MODE) and len(fns) > 1 \
        else [[fn] for fn in fns]
    t0 = time.perf_counter()
    for group in groups:
        _map_file_frag(gi, group, opt, out, n_threads, front, stats,
                       gwfa_pool, cov)
    if stats is not None:
        stats["map_ms"] = (time.perf_counter() - t0) * 1e3
        stats.update(trace.snapshot())
    if front is not None:
        front.log_stats()
        if stats is not None:
            split = getattr(front, "_split_state", None)
            stats.update(n_device=front.n_device,
                         n_fallback=front.n_fallback,
                         n_chain_unsure=front.n_chain_unsure,
                         stage_bytes=front.stage_bytes,
                         stage_pinned_bytes=front.stage_pinned_bytes,
                         n_batches=front.n_batches,
                         n_step_replays=front.n_step_replays,
                         n_step_eager=front.n_step_eager,
                         collect_probed=front.collect_probed,
                         collect_anchor_slots=front.collect_anchor_slots,
                         table_slot_words=front.table_slot_words,
                         share=split.share if split else None,
                         collapsed=bool(split and split.collapsed),
                         stage_ms=dict(front.timer.ms))


def map_files(g: Graph, fns: List[str], ipt: IndexOptions,
              opt0: MapOptions, out=sys.stdout, n_threads: int = 1,
              device="cuda", stats: Optional[dict] = None,
              gwfa_device=None) -> int:
    """Index once, then map each query file (mg_map_files).

    device: "cuda" (default) runs the seed (and, where the chain is the
    banded DP, the chain) stages of the device share on the card, "cpu"
    runs the same stages' plain versions on the CPU, None maps every
    read on the native host path.  The GAF bytes are the same in all
    three cases: reads the device cannot reproduce exactly are flagged
    and take the host path.  gwfa_device: where the GWFA bridge pool
    runs ("cuda"; "cpu" the plain version; None no pool: the native
    tail bridges on the host); its jobs the kernel
    flags bridge on the host, with the same bytes.  With --cov (the
    MG_M_CAL_COV flag) the reads' coverage goes into g's dc:f tags
    instead of GAF.  `stats`, when given, receives what map_reads
    reports (the index build among its spans: setup.index), and with a
    pool its counts (gwfa_jobs, gwfa_device, gwfa_flagged,
    gwfa_oversize)."""
    dev = resolve_device(device)
    opt = copy.copy(opt0)
    _check_options(opt)
    gi = build_index(g, ipt.k, ipt.w, opt)
    front = None
    if dev is not None:
        from .device_front import DeviceFront
        front = DeviceFront(gi, opt, device=dev)
    pool = None
    if gwfa_device is not None:
        pool = DeviceGwfaPool(gi, resolve_device(gwfa_device))
    cov = None
    if opt.flag & MG_M_CAL_COV:
        cov = (np.zeros(g.n_seg, dtype=np.float64),
               np.zeros(g.n_arc, dtype=np.float64))
    map_reads(gi, opt, fns, out, n_threads, front, stats, pool, cov)
    if pool is not None:
        pool.log_stats()
        if stats is not None:
            stats.update(gwfa_jobs=pool.n_jobs, gwfa_device=pool.n_device,
                         gwfa_flagged=pool.n_flagged,
                         gwfa_oversize=pool.n_oversize)
    if cov is not None:
        aux_update_cv(g, "dc", *cov)
    return 0
