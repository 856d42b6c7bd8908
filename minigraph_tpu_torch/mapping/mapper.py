"""Read mapping for the port: the per-read path (mg_map_frag,
map-algo.c:340-502) and the file-level loop (mg_map_files,
gmap.c:163-211).

`map_files` indexes the graph once, then maps each query file.  A file
the native reader opens goes through `_map_file_native`, the JAX
package's all-native loop: C reader arenas with a one-batch read-ahead
thread, and, with a device front, the adaptive host/device split.  In
the open split each arena batch sends a share of its eligible reads to
the device front and maps the rest in one native host call (host
collect), then finishes the previous batch's device share (its chains
through the native tail), so the device works on batch k while the host
finishes batch k-1.  The host share follows the measured per-read costs
so that both finish together; when the device does not pay, the split
collapses to the host with a device probe every few batches.  A file
the native reader cannot open (stdin) goes through `map_batch`, a plain
batch loop.  A read whose native tail bails (status != 0) is mapped
again from its sequence on the exact per-read path (`map_frag`) and
written with `write_gaf`.  With device=None every read takes the native
host path; that run is the byte reference the device runs are held
against, whatever share the controller picks.
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
from ..seqio.bseq import BSeqFile, NativeSeqReader
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


def _ema(prev, x, alpha=0.4):
    """Exponential moving average with None start."""
    return x if prev is None else prev + alpha * (x - prev)


def _probe_interval(split):
    """Batches between device probes while the host owns the work.

    A probe maps ~a quarter batch through the device path, costing
    ~(n/4)*t_dev against interval*n*t_host of host work; sizing the
    interval to ~5x the cost ratio caps probe overhead at ~5%
    regardless of workload."""
    td, th = split.get("t_dev"), split.get("t_host")
    if not td or not th:
        return 8
    return max(8, min(256, int(5.0 * td / th)))


def _count(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _timed_native(stats, *args, **kw):
    """map_batch_native, its host time added to stats["tail_ms"]."""
    t0 = time.perf_counter()
    res = map_batch_native(*args, **kw)
    _count(stats, "tail_ms", (time.perf_counter() - t0) * 1e3)
    return res


def _map_host_share(gi, opt, n_threads, split, stats, blob):
    """The host share of an arena batch (every read not in the blob's
    skip list) in one native call; with a split, its per-read cost
    updates the host estimates t_host and t_host_cpu."""
    n, skipw = blob[0], blob[5]
    n_host = int(n - len(skipw))
    _count(stats, "n_share_host", n_host)
    if n_host == 0:
        return {}
    # with n_threads > 1 the workers are other threads: the summed
    # process CPU time is the single-thread cost the estimates compare
    c0 = time.thread_time() if n_threads == 1 else time.process_time()
    t0 = time.perf_counter()
    res = _timed_native(stats, gi, opt, None, n_threads,
                        blob=blob[:5] + (skipw if len(skipw) else None,))
    if split is not None:
        cpu = (time.thread_time() - c0) if n_threads == 1 \
            else (time.process_time() - c0)
        wall = time.perf_counter() - t0
        split["t_host"] = _ema(
            split["t_host"],
            (wall if n_threads == 1 else max(wall, cpu)) / n_host)
        split["t_host_cpu"] = _ema(split.get("t_host_cpu"), cpu / n_host)
    return res


def _open_split_submit(gi, opt, front, split, n_threads, n, sq_addr,
                       sq_off, nm_addr, nm_off, qlen, bad, stats):
    """Phase 1 of the open host/device split for one arena batch:
    submit the device share (asynchronous on the card) and map the host
    share in one native call on the calling thread (the call releases
    the GIL).  split["share"] is the host's fraction of the eligible
    reads.  Returns the in-flight state for _open_split_finish; the
    caller finishes batch k-1 only after submitting batch k, so the
    device works on batch k while the host runs k-1's device-share
    tails."""
    import ctypes as ct

    elig = [k for k in range(n) if not bad[k]
            and front.eligible(opt, 1, int(qlen[k]))]
    n_steal = int(len(elig) * split["share"])
    cand = elig[n_steal:]
    sub_wall = 0.0
    handle = None
    cold = False
    if cand:
        total = int(sq_off[-1])
        abuf = np.frombuffer((ct.c_char * total).from_address(sq_addr),
                             dtype=np.uint8)
        t0 = time.perf_counter()
        handle = front.submit(
            [abuf[int(sq_off[k]): int(sq_off[k + 1])] for k in cand])
        sub_wall = time.perf_counter() - t0
        cold = front.last_submit_cold
    # host share: everything not sent to the device
    host_skip = np.asarray(bad).copy()
    host_skip[cand] = True
    skipw = np.nonzero(host_skip)[0]
    _count(stats, "n_share_dev", len(cand))
    res = _map_host_share(gi, opt, n_threads, split, stats,
                          (n, sq_addr, sq_off, nm_addr, nm_off, skipw))
    return {"n": n, "sq_addr": sq_addr, "sq_off": sq_off,
            "nm_addr": nm_addr, "nm_off": nm_off, "bad": bad,
            "cand": cand, "handle": handle, "res": res,
            "sub_wall": sub_wall, "cold": cold}


def _open_split_finish(gi, opt, front, split, n_threads, st, stats):
    """Phase 2: gather the device share, map it through the native tail
    (the front's chains where it delivered them, the in-worker collect
    where it flagged a read), update the share controller, return the
    merged results."""
    n, cand = st["n"], st["cand"]
    res = st["res"]
    if st["handle"] is not None:
        t0 = time.perf_counter()
        # batch arrays (gather_flat): the pointer tables fill with
        # vectorized numpy, no per-read Python
        flat, extra = front.gather_flat(st["handle"])
        cand_arr = np.asarray(cand)
        fr_flat = [(cand_arr[sel], fb) for sel, fb in flat]
        fr_map = {cand[i]: fr for i, fr in extra.items() if fr is not None}
        # every candidate runs here: a read the front flagged (no
        # chains) runs the in-worker collect, never the per-read path
        dev_skip = np.ones(n, dtype=bool)
        dev_skip[cand_arr] = False
        dev_skip |= np.asarray(st["bad"])
        dskipw = np.nonzero(dev_skip)[0]
        dres = _timed_native(
            stats, gi, opt, None, n_threads,
            blob=(n, st["sq_addr"], st["sq_off"], st["nm_addr"],
                  st["nm_off"], dskipw if len(dskipw) else None),
            fr_map=fr_map, fr_flat=fr_flat)
        for k in cand:
            res[k] = dres.get(k)
        if not st["cold"]:      # a build or first run is not the steady cost
            split["t_dev"] = _ema(
                split["t_dev"],
                (st["sub_wall"] + time.perf_counter() - t0) / len(cand))
    # ---- controller: share balance + collapse test
    now = time.perf_counter()
    t_last = split.get("t_last")
    split["t_last"] = now
    if t_last is not None and n > 0 and split["share"] < 1.0:
        cyc = now - t_last
        if cyc / n < 0.05:      # not a build cycle
            split["rate_mix"] = _ema(split.get("rate_mix"), n / cyc)
            split["nb_mix"] = split.get("nb_mix", 0) + 1
    if split["t_dev"] and split["t_host"]:
        tgt = split["t_dev"] / (split["t_dev"] + split["t_host"])
        share = 1.0 if tgt > 0.95 else min(0.9, max(0.0, tgt))
        if tgt > 0.95:
            split["hi_tgt"] = split.get("hi_tgt", 0) + 1
        else:
            split["hi_tgt"] = 0
        if split.get("hi_tgt", 0) >= 2:
            split["collapsed"] = True
            share = 1.0
        elif (share < 1.0 and split.get("rate_mix")
              and split.get("nb_mix", 0) >= 3
              and split.get("t_host_cpu")
              and 1.0 / split["t_host_cpu"] > 1.08 * split["rate_mix"]):
            split["collapsed"] = True
            share = 1.0
        split["share"] = share
    return res


def _arena_batches(rdr, max_bp):
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
                a = rdr.read_batch_arena(max_bp)
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


def _map_file_native(gi, opt, rdr, out, n_threads, front=None, split=None,
                     stats=None):
    """All-native single-file loop: C reader arenas -> native batch tail
    -> GAF text; Python touches only reads that take the per-read path
    (engine bails, zero-length, over max_qlen).

    With a device front (front and split given) the loop runs the open
    split until the controller collapses it; collapsed, it maps every
    read on the host and every _probe_interval-th arena batch probes a
    quarter batch through the device (submitted before the host call, so
    the device runs while the host maps) to keep t_dev fresh; two probes
    in a row with a finish-together target <= 0.45 reopen the split."""
    import ctypes as ct

    def _emit_batch(res, n, rec, bad):
        """Write a batch's results in read order; a None entry (a
        native bail, or a read the native path does not take) is mapped
        on the exact per-read path."""
        n_perread = 0
        for k in range(n):
            txt = res.get(k)
            if txt is None:
                name, seq = rec(k)
                gcs = map_frag(gi, [len(seq)], [seq], opt, name,
                               fast_emit=True)
                txt = write_gaf(gi.g, gcs, 1, [len(seq)], name, opt.flag)
                n_perread += not bad[k]
            if txt:
                out.write(txt)
        _count(stats, "n_perread", n_perread)

    pending = None      # in-flight split batch (the device busy on it)

    def _flush_pending():
        nonlocal pending
        if pending is None:
            return
        st, rec_p = pending
        pending = None
        res_p = _open_split_finish(gi, opt, front, split, n_threads, st,
                                   stats)
        _emit_batch(res_p, st["n"], rec_p, st["bad"])

    for n, sq_addr, sq_off, nm_addr, nm_off in _arena_batches(
            rdr, opt.mini_batch_size):
        _count(stats, "n_arena", 1)
        qlen = sq_off[1:] - sq_off[:-1]
        bad = qlen <= 0
        if opt.max_qlen > 0:
            bad = bad | (qlen > opt.max_qlen)

        # bind this batch's arena: a pending batch's rec is called one
        # iteration later, when the loop has moved to the next arena
        def rec(k, nm_addr=nm_addr, nm_off=nm_off, sq_addr=sq_addr,
                sq_off=sq_off):
            name = ct.string_at(
                nm_addr + int(nm_off[k]),
                int(nm_off[k + 1] - nm_off[k])).decode("latin-1")
            seq = ct.string_at(
                sq_addr + int(sq_off[k]),
                int(sq_off[k + 1] - sq_off[k])).decode("latin-1")
            return name, seq

        if front is not None and not split.get("collapsed"):
            # open split: submit batch k's device share and map its host
            # share, then finish batch k-1 (its fetch has had a host
            # batch to drain); emission stays in batch order
            st = _open_split_submit(gi, opt, front, split, n_threads, n,
                                    sq_addr, sq_off, nm_addr, nm_off, qlen,
                                    bad, stats)
            _flush_pending()
            pending = (st, rec)
            continue
        _flush_pending()

        skip = bad
        handle = cand = None
        sub_wall = 0.0
        probe_cold = False
        if front is not None:
            split["nb"] = split.get("nb", 0) + 1
            if split["nb"] % _probe_interval(split) == 0:
                cand = [k for k in range(n) if not bad[k]
                        and front.eligible(opt, 1, int(qlen[k]))]
                cand = cand[:max(8, n // 4)]
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
        if handle is not None:
            t0 = time.perf_counter()
            fr_map = {k: fr for k, fr in zip(cand, front.gather(handle))
                      if fr is not None}
            # the probe's reads through the native tail: the front's
            # chains where it delivered them, the in-worker collect where
            # it flagged a read
            pskip = np.ones(n, dtype=bool)
            pskip[cand] = False
            ptxt = _timed_native(stats, gi, opt, None, n_threads,
                                 blob=(n, sq_addr, sq_off, nm_addr, nm_off,
                                       np.nonzero(pskip)[0]),
                                 fr_map=fr_map)
            if fr_map and not probe_cold:
                split["t_dev"] = _ema(
                    split["t_dev"],
                    (sub_wall + time.perf_counter() - t0) / len(cand))
                if split["t_host"]:
                    tgt = split["t_dev"] / (split["t_dev"] + split["t_host"])
                    # hysteresis: one probe biased low (the device ran
                    # during the host call) must not reopen the split
                    if tgt <= 0.45:
                        split["reopen"] = split.get("reopen", 0) + 1
                        if split["reopen"] >= 2:
                            split["collapsed"] = False
                            split["rate_mix"] = None
                            split["nb_mix"] = 0
                            split["reopen"] = 0
                    else:
                        split["reopen"] = 0
            for k in cand:
                res[k] = ptxt.get(k)
        _emit_batch(res, n, rec, bad)
    _flush_pending()


def map_reads(gi: MinimizerIndex, opt: MapOptions, fns: List[str],
              out=sys.stdout, n_threads: int = 1, front=None,
              stats: Optional[dict] = None) -> None:
    """Map each query file against an index (the loop of mg_map_files).

    front: a DeviceFront on `gi`, or None to map every read on the host.
    The split's learned state lives on the front as front._split_state
    and carries over from file to file; a caller may set it before the
    first file, e.g. {"share": 0.0, "t_host": None, "t_dev": None} to
    send every eligible read to the device.  That pin holds only while
    every read is eligible: the host measures no cost while it maps no
    eligible read, and the share stays until both costs have been
    measured; a pinned caller checks stats["n_share_host"] == 0.  `stats`, when given, receives the mapping wall
    time (map_ms), the native tail's host time (tail_ms), the reads
    re-mapped on the per-read path (n_perread), the arena batches
    (n_arena), the reads sent to the device and host shares
    (n_share_dev, n_share_host), the device probes (n_probes), and with
    a front the final share, collapsed, and the front's counters and
    per-stage device times (ms)."""
    _check_options(opt)
    split = None
    if front is not None:
        split = getattr(front, "_split_state", None)
        if split is None:
            split = {"share": 0.35, "t_host": None, "t_dev": None}
            front._split_state = split
    t0 = time.perf_counter()
    for fn in fns:
        try:
            rdr = NativeSeqReader(fn)
        except OSError:
            rdr = None
        if rdr is not None:
            try:
                _map_file_native(gi, opt, rdr, out, n_threads, front,
                                 split, stats)
            finally:
                rdr.close()
            continue
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
        stats["map_ms"] = (time.perf_counter() - t0) * 1e3
    if front is not None:
        front.log_stats()
        if stats is not None:
            stats.update(n_device=front.n_device,
                         n_fallback=front.n_fallback,
                         n_chain_unsure=front.n_chain_unsure,
                         n_flat_ovf=front.n_flat_ovf,
                         n_batches=front.n_batches,
                         share=split["share"],
                         collapsed=bool(split.get("collapsed")),
                         stage_ms=dict(front.timer.ms))


def map_files(g: Graph, fns: List[str], ipt: IndexOptions,
              opt0: MapOptions, out=sys.stdout, n_threads: int = 1,
              device="cuda", stats: Optional[dict] = None) -> int:
    """Index once, then map each query file (mg_map_files).

    device: "cuda" (default) runs the seed and chain stages of the
    device share on the card, "cpu" runs the same stages' plain versions
    on the CPU, None maps every read on the native host path.  The GAF
    bytes are the same in all three cases: reads the device cannot
    reproduce exactly are flagged and take the host path.  `stats`,
    when given, receives the index wall time (index_ms) and what
    map_reads reports."""
    dev = resolve_device(device)
    opt = copy.copy(opt0)
    _check_options(opt)
    t0 = time.perf_counter()
    gi = build_index(g, ipt.k, ipt.w, opt)
    front = None
    if dev is not None:
        from .device_front import DeviceFront
        front = DeviceFront(gi, opt, device=dev)
    if stats is not None:
        stats["index_ms"] = (time.perf_counter() - t0) * 1e3
    map_reads(gi, opt, fns, out, n_threads, front, stats)
    return 0
