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
  5. packing into one buffer of the 64-bit words the native tail reads,
     copied once, asynchronously, into pinned host memory (a pool the
     front owns) right after the batch is dispatched.

The host then hands each read's compacted chains to the native batch
tail (mapping/native_tail.py) as views of that memory.  Reads the
device cannot reproduce exactly carry a flag (sketch tie overflow,
qcap/acap overflow, occurrence-cap truncation, duplicate x, unsure
chain or backtrack) and take the host path, so the output is
byte-identical either way.

When the chain parameters depend on the read or the chain is not the
banded DP (--rmq and asm, -F, sr; `chain_enabled` False), the front is
a seed-only front: it runs stages 1, 2 and 5 only and hands each read's
raw anchors, rep_len, minimizer positions and minimizer count to the
native tail (the same words, with no chain records), which chains them
itself (mode 1 or 2) and skips its own collect.

The kernel path is chosen by the device of the tensors: the front runs
on the device it is given, and the ops wrappers launch the CUDA kernels
for tensors on the card and their plain versions for tensors on the CPU.

On the card the step of a bucket shape runs eagerly once, the first
time the front sees that shape; then each of its stages is captured
into a CUDA graph of its own (`capture_stages`: one memory pool for the
shape, replayed in the order of capture), and every later batch of the
shape copies its codes and lengths into the captured inputs and
replays the stages: a few graph launches a batch instead of the
hundreds of PyTorch launches of the eager step, with the same kernels
and the same words.  A shape whose capture fails stays eager.  On the
CPU the step is always eager.
"""
from __future__ import annotations

import os
import weakref
from dataclasses import dataclass
from functools import partial
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
# the per-read vectors of a packed batch, in buffer order; a chained
# front adds its chain records' and its sure flags'
READ_VECTORS = ("prefix", "n_a", "mprefix", "n_mini", "rep_len", "n_q",
                "overflow")
CHAIN_VECTORS = ("uprefix", "n_u", "sure")
# blob keys of the per-read vectors a chunk hands on (gather_flat)
BLOB_VECTORS = ("prefix", "n_a", "mprefix", "n_mini", "rep_len", "n_q")


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


def pack_layout(B: int, acap: int, qcap: int, chains: bool):
    """Where a bucket batch's words lie in its packed int64 buffer:
    ({key: (offset, length)}, total words).  First the planes of the
    live anchors of all reads, dense, each as long as the padded planes
    hold (a read keeps at most acap anchors, qcap minimizers and UCAP
    chains, so every batch fits): AX = axh<<32 | axl, AY in the host
    layout occ<<56 | tandem<<42 | span<<32 | qpos, MINI the
    non-repetitive minimizer positions, and with the chain on U = sc<<32
    | cnt; each plane is followed by one word that takes the scatter's
    writes of the padding.  Then one row of B words per read vector
    (READ_VECTORS, then CHAIN_VECTORS)."""
    planes = [("AX", B * acap), ("AY", B * acap), ("MINI", B * qcap)]
    if chains:
        planes.append(("U", B * UCAP))
    lay = {}
    off = 0
    for key, cap in planes:
        lay[key] = (off, cap)
        off += cap + 1
    for key in READ_VECTORS + (CHAIN_VECTORS if chains else ()):
        lay[key] = (off, B)
        off += B
    return lay, off


class _Lease:
    """A pinned staging buffer lent to one bucket batch.  Its host views
    (np.asarray(lease) and every view of that) hold the lease, and the
    buffer goes back to the pool only when the last of them is gone:
    after the handle and every blob or FrontResult made from it."""
    __slots__ = ("tensor", "__weakref__")

    def __init__(self, tensor):
        self.tensor = tensor

    @property
    def __array_interface__(self):
        return {"shape": (self.tensor.numel(),), "typestr": "<i8",
                "data": (self.tensor.data_ptr(), False), "version": 3}


class _StagePool:
    """Pinned int64 host buffers for the front's packed batches, by
    length (one a bucket shape), reused once their lease is dropped.
    pinned_bytes: what the pool has allocated."""

    def __init__(self):
        self.free: Dict[int, List[torch.Tensor]] = {}
        self.pinned_bytes = 0

    def take(self, n: int) -> _Lease:
        free = self.free.get(n)
        if free:
            t = free.pop()
        else:
            t = torch.empty(n, dtype=torch.int64, pin_memory=True)
            self.pinned_bytes += n * 8
        lease = _Lease(t)
        weakref.finalize(lease, self._give_back, t)
        return lease

    def _give_back(self, t):
        self.free.setdefault(t.numel(), []).append(t)


def capture_stages(fns, st: dict) -> list:
    """Each stage fn(st) captured into a CUDA graph of its own, in order,
    all in one memory pool: the graphs must be replayed in that order.
    A stage reads its inputs from `st` and puts its outputs there, so
    the tensors in `st` after the capture are the graphs' static inputs
    and outputs.  Captures on a side stream (torch.cuda.graph's);
    relaxed, because the chain and backtrack wrappers set their
    kernel's shared-memory limit (cudaFuncSetAttribute) on every call.
    Returns the graphs."""
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for fn in fns:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool, capture_error_mode="relaxed"):
            fn(st)
        graphs.append(g)
    return graphs


@dataclass
class _StepGraphs:
    """A bucket shape's captured step: its tensors (`st`: the inputs
    codes and lens, each stage's outputs, the packed buffer `buf` and
    its `layout`), one graph a stage in the front's `stage_names` order,
    and the kernel launches the capture made, which each replay adds to
    `kernels.launches`."""
    st: dict
    graphs: list
    launched: Dict[str, int]


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
        # the bytes of the packed words handed on (on the card copied into
        # pinned memory from _pool, on the CPU viewed where the step left
        # them)
        self.stage_bytes = 0
        self._pool = _StagePool()
        self.n_batches = 0    # device steps run (one a bucket batch)
        # what the hash join's collect touches, counted from the batch
        # shapes (padded slots included, as the gathers read them): the
        # minimizer slots probed (each reads its two table slots) and the
        # anchor slots (each reads its position entries and writes its
        # anchor planes)
        self.collect_probed = 0
        self.collect_anchor_slots = 0
        # True after a submit that built the kernel library or ran (and
        # on the card captured) a bucket shape for the first time: the
        # split controller of the file loop (mapping/mapper.py) does not
        # take that cost as the device's steady cost
        self.last_submit_cold = False
        # the span of the newest submit (utils/trace.py span: its t0 and
        # ns): the file loop's overlap of submits with native tails
        self.last_submit_span = None
        # the bucket shapes seen, (pad_len, bsz, chain_enabled), each
        # with its captured step (_StepGraphs), or None where it runs
        # eagerly: always on the CPU, on the card where the capture
        # failed
        self._shapes: Dict[tuple, Optional[_StepGraphs]] = {}
        self._capture = self.device.type == "cuda"
        # bucket batches run from a shape's graphs, and eagerly by a
        # front that captures (on the card)
        self.n_step_replays = 0
        self.n_step_eager = 0
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
        self.stage_names = STAGES if self.chain_enabled else SEED_STAGES
        self.timer = trace.StageTimer(self.device, self.stage_names)

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

    def _stages(self, pad_len: int, bsz: int):
        """The step of a (pad_len, bsz) batch as its stages, one function
        a name of `stage_names` (STAGES, or SEED_STAGES where the front
        is seed-only), in order: each fn(st) reads its inputs from the
        dict `st` (codes and lens to begin with) and puts its outputs
        there; the last leaves the packed device buffer and its layout
        in st["buf"] and st["layout"].  No stage synchronises with the
        host or changes the front, so each can be captured in a CUDA
        graph."""
        qcap, acap, win, tile = self.caps(pad_len)
        opt = self.opt
        gi = self.gi
        max_occ = int(opt.occ_max1)
        collect_fn = collect_anchors_exact_hash if self.hashed \
            else collect_anchors_exact
        # the chunked chain drops the max_ii candidate, exact only while
        # the iteration clamp clears the buffer (the JAX front's guards)
        chain_fn = lchain_dp_chunked if (
            self.chain_chunked and opt.max_lc_iter >= win + min(128, acap)
            and win >= 128) else lchain_dp_exact_win

        def sketch(st):
            st["sp"] = sketch_planes(st["codes"], st["lens"], gi.w, gi.k)

        def collect(st):
            sp = st["sp"]
            res = collect_fn(self.ji, sp.hh, sp.hl, sp.meta, sp.t_hh,
                             sp.t_hl, sp.t_meta, max_occ, self.occ_cap,
                             qcap=qcap, acap=acap)
            st["res"] = res
            st["overflow"] = res["overflow"] | sp.overflow
            # cnt <= 255 decides every occurrence test (max_occ caps at
            # 250)
            st["q_cnt"] = torch.clamp(res["q_cnt"], 0, 255)

        def chain(st):
            res = st["res"]
            st["f"], st["p"], st["sure"] = chain_fn(
                res["axh"], res["axl"], res["ayh"], res["ayl"], res["n_a"],
                int(self.mdx_adj), int(self.mdy_adj), int(opt.bw),
                int(opt.max_lc_skip), int(opt.max_lc_iter),
                self.chn_pen_gap, self.chn_pen_skip, window=win, tile=tile)

        def backtrack(st):
            res = st["res"]
            bt = backtrack_compact(st["f"], st["p"], res["n_a"], res["axh"],
                                   res["axl"], res["ayh"], res["ayl"],
                                   min_cnt=int(opt.min_lc_cnt),
                                   min_sc=int(opt.min_lc_score),
                                   max_drop=int(opt.bw), ucap=UCAP)
            st["bt"] = bt
            st["sure"] = st["sure"] & ~bt["bt_unsure"]

        def pack(st):
            res = st["res"]
            if self.chain_enabled:
                bt = st["bt"]
                full = {"axh": bt["c_axh"], "axl": bt["c_axl"],
                        "ayh": bt["c_ayh"], "ayl": bt["c_ayl"],
                        "u_pad_sc": bt["u_sc"], "u_pad_cnt": bt["u_cnt"],
                        "n_u": bt["n_u"]}
                n_a, sure = bt["n_v"], st["sure"]
            else:
                # seed-only: the raw anchor planes go to the host
                full = {k: res[k] for k in ("axh", "axl", "ayh", "ayl")}
                n_a, sure = res["n_a"], None
            full.update(q_cnt=st["q_cnt"], q_meta=res["q_meta"])
            st["buf"], st["layout"] = self._pack_body(
                full, n_a, res["n_q"], st["overflow"], sure, max_occ, bsz,
                acap, qcap)

        fns = {"sketch": sketch, "collect": collect, "chain": chain,
               "backtrack": backtrack, "pack": pack}
        return [fns[name] for name in self.stage_names]

    def _run(self, calls, st: dict, pad_len: int, bsz: int):
        """One batch through its stages: calls[i]() runs stage i (eagerly
        or as a graph's replay), each in its span `front.<stage>` and
        between two marks of the stage timer.  Returns (st["buf"],
        st["layout"])."""
        if self.hashed:
            qcap, acap = self.caps(pad_len)[:2]
            self.collect_probed += bsz * qcap
            self.collect_anchor_slots += bsz * acap
        tm = self.timer
        t0 = tm.mark()
        for name, call in zip(self.stage_names, calls):
            with trace.span("front." + name):
                call()
                t1 = tm.mark()
            tm.add(name, t0, t1)
            t0 = t1
        return st["buf"], st["layout"]

    def _step(self, codes: torch.Tensor, lens: torch.Tensor, pad_len: int,
              bsz: int):
        """Run the device stages eagerly on one padded batch; returns the
        packed device buffer and its layout."""
        st = {"codes": codes, "lens": lens}
        return self._run([partial(fn, st) for fn in self._stages(pad_len,
                                                                  bsz)],
                         st, pad_len, bsz)

    def _replay(self, sg: _StepGraphs, codes: np.ndarray, lens: np.ndarray,
                pad_len: int, bsz: int):
        """One batch from its shape's graphs: its codes and lengths
        copied into the captured inputs (stream-ordered: behind the
        previous replay, whose staging copy of the packed buffer was
        queued before this), then one replay a stage.  Returns the
        captured buffer and its layout."""
        st = sg.st
        with trace.span("front.upload"):
            st["codes"].copy_(torch.from_numpy(codes))
            st["lens"].copy_(torch.from_numpy(lens))
        with trace.span("front.dispatch"):
            out = self._run([g.replay for g in sg.graphs], st, pad_len,
                            bsz)
        for name, n in sg.launched.items():
            kernels.launches[name] += n
        self.n_step_replays += 1
        return out

    def _capture_step(self, codes: torch.Tensor, lens: torch.Tensor,
                      pad_len: int, bsz: int) -> Optional[_StepGraphs]:
        """The shape's step captured (capture_stages) on copies of a
        batch's inputs, after that batch has run eagerly (which loaded
        the kernels and set their attributes); None where the capture
        raised.  The capture runs nothing, so the launches it counted are
        taken back."""
        st = {"codes": codes.clone(), "lens": lens.clone()}
        before = dict(kernels.launches)
        try:
            graphs = capture_stages(self._stages(pad_len, bsz), st)
        except RuntimeError:
            return None
        finally:
            launched = {k: v - before.get(k, 0)
                        for k, v in kernels.launches.items()
                        if v != before.get(k, 0)}
            kernels.launches.update(before)
        return _StepGraphs(st, graphs, launched)

    @staticmethod
    def _pack_body(full, n_a, n_q, overflow, sure, max_occ, B, acap, qcap):
        """Dense packing of the live anchors of all reads (the chain
        anchors, or a seed-only front's raw anchors) into one int64
        buffer of the words the native tail reads, laid out by
        pack_layout (pack_body of the JAX front, with the host's word
        assembly done here): the flat ay word occ8|tandem1|span6|qpos17
        of the JAX front widened to the host layout (span <= 31 by
        construction, qpos < 2^17 for bucket reads); rep_len and the
        non-repetitive minimizer positions computed on the device; chain
        records, where there are any (sure not None), dense-packed.
        Returns (buffer, layout)."""
        dev = n_a.device
        I64 = torch.int64
        chains = sure is not None
        lay, total = pack_layout(B, acap, qcap, chains)
        buf = torch.zeros(total, dtype=I64, device=dev)
        n_a = n_a.to(I64)

        def excl(v):
            return torch.cumsum(v, 0) - v

        def put(key, v, pos, ok):
            """v's words where ok at pos in the plane `key`, the rest
            into the word after it."""
            off, cap = lay[key]
            ix = torch.where(ok, pos + off, off + cap)
            buf.scatter_(0, ix.reshape(-1), v.reshape(-1))

        ar = torch.arange(acap, device=dev)[None, :]
        valid = ar < n_a[:, None]
        prefix = excl(n_a)
        pos = prefix[:, None] + ar
        put("AX", (full["axh"] << 32) | full["axl"], pos, valid)
        ayh = full["ayh"]
        # occ<<56 keeps ayh's bits 24-31 (the shift drops the rest)
        put("AY", ((ayh >> 24) << 56) | (((ayh >> 10) & 1) << 42)
            | ((ayh & 0x3F) << 32) | (full["ayl"] & 0x1FFFF), pos, valid)
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
        mrank = torch.cumsum(mini_sel.to(I64), 1) - 1
        put("MINI", qpos.to(I64), mprefix[:, None] + mrank, mini_sel)
        vectors = [prefix, n_a, mprefix, n_mini, rep_len, n_q, overflow]
        if chains:
            n_u = full["n_u"].to(I64)
            ur = torch.arange(UCAP, device=dev)[None, :]
            uprefix = excl(n_u)
            put("U", (full["u_pad_sc"].to(I64) << 32)
                | (full["u_pad_cnt"].to(I64) & 0xFFFFFFFF),
                uprefix[:, None] + ur, ur < n_u[:, None])
            vectors += [uprefix, n_u, sure]
        off = lay["prefix"][0]
        buf[off: off + len(vectors) * B].view(len(vectors), B).copy_(
            torch.stack([v.to(I64) for v in vectors]))
        return buf, lay

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

    def submit(self, seqs: List[str]):
        """Run the device stages for a list of reads (str, bytes or
        uint8 arrays).  Launches are asynchronous on the card; gather()
        waits for the results.  Returns an opaque handle for
        gather()/gather_flat()."""
        with trace.span("front.submit") as sp:
            self.last_submit_span = sp
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
                key = (pad_len, bsz, self.chain_enabled)
                # a shape's first batch runs eagerly and, on the card,
                # captures the shape's graphs
                cold |= key not in self._shapes
                for c0 in range(0, len(idxs), bsz):
                    chunk = idxs[c0: c0 + bsz]
                    reads = [seqs[i] for i in chunk]
                    reads += [""] * (bsz - len(reads))
                    with trace.span("front.encode"):
                        codes, lens = encode_batch(reads, pad_to=pad_len)
                    buf, layout = self._dispatch(key, codes, lens)
                    with trace.span("front.stage"):
                        host, done = self._stage(buf)
                    self.n_batches += 1
                    pending.append((chunk, host, layout, done))
            self.last_submit_cold = cold
            return (len(seqs), pending)

    def _dispatch(self, key, codes: np.ndarray, lens: np.ndarray):
        """One encoded bucket batch through the step: replayed from its
        shape's graphs where the shape has them, else uploaded and run
        eagerly; a front on the card captures a shape's graphs after the
        shape's first eager batch.  Returns the packed device buffer and
        its layout."""
        pad_len, bsz, _ = key
        sg = self._shapes.get(key)
        if sg is not None:
            return self._replay(sg, codes, lens, pad_len, bsz)
        with trace.span("front.upload"):
            codes = torch.from_numpy(codes).to(self.device)
            lens = torch.from_numpy(lens).to(self.device)
        with trace.span("front.dispatch"):
            out = self._step(codes, lens, pad_len, bsz)
        if self._capture:
            self.n_step_eager += 1
            if key not in self._shapes:
                with trace.span("front.capture"):
                    self._shapes[key] = self._capture_step(codes, lens,
                                                           pad_len, bsz)
        self._shapes.setdefault(key, None)
        return out

    def _stage(self, buf):
        """A packed batch's words on the host, and the event that marks
        their arrival (None on the CPU).  On the card: one asynchronous
        copy, queued behind the batch's own stages and ahead of the next
        batch's, into a pinned buffer of the pool; on the CPU the buffer
        itself."""
        self.stage_bytes += buf.numel() * 8
        if self.device.type != "cuda":
            return buf.numpy(), None
        lease = self._pool.take(buf.numel())
        lease.tensor.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return np.asarray(lease), done

    @property
    def table_bytes(self) -> int:
        """Device bytes of the join tables."""
        return sum(t.numel() * t.element_size()
                   for t in vars(self.ji).values()
                   if isinstance(t, torch.Tensor))

    @property
    def table_slot_words(self) -> int:
        """Table words one probed slot reads: tag and pay, and tag_hi
        for wide keys (0 for the flat join, which has no slots)."""
        if not self.hashed:
            return 0
        return 2 if self.ji.tag_hi is None else 3

    @property
    def stage_pinned_bytes(self) -> int:
        """Pinned host memory the staging pool has allocated."""
        return self._pool.pinned_bytes

    def gather_flat(self, handle):
        """Batch-array results: a list of (positions-in-submit-order,
        blob of batch arrays) for the reads whose anchors the device
        delivered, one entry a chunk with any.  A blob's planes (AX, AY,
        MINI, and U where the front chains) are views of the chunk's
        packed words; its per-read vectors (BLOB_VECTORS, and uprefix and
        n_u with U) hold the delivered reads only.  The other reads take
        the host path."""
        with trace.span("front.gather"):
            n_seqs, pending = handle
            flat = []
            for chunk, host, layout, done in pending:
                with trace.span("front.wait"):
                    if done is not None:
                        done.synchronize()
                self.timer.settle()
                with trace.span("front.unpack"):
                    self._unpack(chunk, host, layout, flat)
            return flat

    def _unpack(self, chunk, host, layout, flat):
        """One chunk's words, waited for, into gather_flat's flat list:
        the planes AX, AY and U as uint64 views, MINI as int64, and the
        `ok` selection of the per-read vectors."""
        def view(key):
            off, n = layout[key]
            return host[off: off + n]

        nb = len(chunk)
        ok = view("overflow")[:nb] == 0
        self.n_fallback += int(nb - ok.sum())
        keys = BLOB_VECTORS
        blob = {"AX": view("AX").view(U64), "AY": view("AY").view(U64),
                "MINI": view("MINI")}
        if self.chain_enabled:
            sure = view("sure")[:nb] != 0
            self.n_chain_unsure += int((ok & ~sure).sum())
            ok &= sure
            keys += ("uprefix", "n_u")
            blob["U"] = view("U").view(U64)
        self.n_device += int(ok.sum())
        sel = np.nonzero(ok)[0]
        if not len(sel):
            return
        for key in keys:
            blob[key] = view(key)[sel]
        flat.append((np.asarray(chunk)[sel], blob))

    def gather(self, handle) -> List[Optional[FrontResult]]:
        """One FrontResult per submitted read, or None where the read
        must take the host path."""
        n_seqs, _ = handle
        out: List[Optional[FrontResult]] = [None] * n_seqs
        for pos, blob in self.gather_flat(handle):
            U = blob.get("U")
            for j, ri in enumerate(pos.tolist()):
                p0, n = int(blob["prefix"][j]), int(blob["n_a"][j])
                m0, nm = int(blob["mprefix"][j]), int(blob["n_mini"][j])
                u = None
                if U is not None:
                    u0, nu = int(blob["uprefix"][j]), int(blob["n_u"][j])
                    u = U[u0: u0 + nu]
                out[ri] = FrontResult(
                    ax=blob["AX"][p0: p0 + n], ay=blob["AY"][p0: p0 + n],
                    rep_len=int(blob["rep_len"][j]),
                    mini_pos=blob["MINI"][m0: m0 + nm],
                    n_mv=int(blob["n_q"][j]), u=u)
        return out

    def log_stats(self):
        from ..utils.syslog import mlog
        tot = self.n_device + self.n_fallback + self.n_chain_unsure
        if tot:
            mlog("device_front",
                 f"device seed stage: {self.n_device}/{tot} reads on "
                 f"device, {self.n_fallback} host fallbacks, "
                 f"{self.n_chain_unsure} chain-DP host reruns, "
                 f"{self.n_batches} batches "
                 f"({self.n_step_replays} replayed from CUDA graphs, "
                 f"{self.n_step_eager} eager on the card), "
                 f"{self.stage_bytes / 1e6:.1f} MB staged "
                 f"({self.stage_pinned_bytes / 1e6:.1f} MB pinned), "
                 f"join tables {self.table_bytes / 1e6:.1f} MB")
        if self._wfa_pool is not None:
            mlog("device_front",
                 f"device -c gap WFA: {self._wfa_pool.n_device} on "
                 f"device, {self._wfa_pool.n_host} host")
