"""Batched base-level alignment of the -c gaps (the device gap pool).

Port of the JAX package's align/cigar_device.py.  mg_gchain_cigar
(galign.c:39-145) aligns every inter-anchor gap of every graph chain
with the WFA.  Where the native walk (native/mgt_cigar.c) cannot finish
a chain (a gap over its iteration budget), `harvest_read` walks the
chain's anchors and defers each gap it would align into a flat pool of
(target gap, query gap) jobs; `DeviceWfaPool.run` aligns the pool's
jobs of 256-2048 bp in lockstep with the batched exact WFA
(ops/wfa_exact.py, CIGAR-exact against the host engine) and the rest
with the host's wfa_auto, chain heuristic included, so results never
depend on where a job ran; `finalize_read` stitches each chain's CIGAR
and generates the ds strings.

Flow (driver: mapping/mapper.py, the Python reader loop with a front):
  harvest_read()  per read, right after the chain tail
  DeviceWfaPool.run()  once per read batch
  finalize_read()  builds gc.p and the ds strings
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from ..mapping.gchain import Cigar, GChains
from ..ops.wfa_exact import (decode_walk, encode_pairs, wfa_device,
                             wfa_tb_walk)
from ..options import MG_SEED_IGNORE
from . import cigar
from .cigar import _append1, _append_many, _es_seq, _i32, gchain_gen_ds
from .wfa import wfa_auto

# (max gap length, score budget, batch) size classes.  Jobs shorter than
# MIN_DEV_LEN run on the host: the native wavefront engine finishes a
# 20 bp gap in microseconds, while a device job pays the batch's
# transfer and decode.  Longer gaps and over-budget jobs also go to the
# host engine (its chain heuristic included).
BUCKETS: Tuple[Tuple[int, int, int], ...] = (
    (768, 1024, 64), (2048, 3072, 16))
MIN_DEV_LEN = 256
PENS = (4, 4, 2, 15, 1)


@dataclass
class PendingCigar:
    """One gchain's walk with unresolved WFA gaps."""
    gc: object
    off_a0: int
    segs: List = field(default_factory=list)  # ('ops', [u32]) | ('job', id)


@dataclass
class PendingRead:
    gt: GChains
    g: object
    es: list
    qseq: str
    qname: Optional[str]
    chains: List[PendingCigar] = field(default_factory=list)


@dataclass
class CigarSink:
    """The jobs and pending reads of one batch (mapping/mapper.py)."""
    jobs: List[Tuple[bytes, bytes]] = field(default_factory=list)
    pending: List[PendingRead] = field(default_factory=list)


def harvest_read(g, es, qseq: str, gt: GChains, qname: Optional[str],
                 jobs: List[Tuple[bytes, bytes]]) -> PendingRead:
    """The anchor walk of gchain_cigar with the WFA gaps deferred into
    `jobs` (indices global across the batch).  A chain the one-call
    native walk resolves is finished here; only chains with a gap over
    its budget take the pool."""
    qbytes = qseq.encode("latin-1")
    pr = PendingRead(gt=gt, g=g, es=es, qseq=qseq, qname=qname)
    for gc in gt.gc:
        if cigar._gchain_cigar_native(es, qbytes, gt, gc):
            continue
        l0 = gc.off
        off_a0 = gt.lc[l0].off
        pc = PendingCigar(gc=gc, off_a0=off_a0)
        ops: List[int] = []
        _append1(ops, 7, (int(gt.ay[off_a0]) >> 32) & 0xFF)
        j0 = 0
        for j in range(1, gc.n_anchor):
            py = int(gt.ay[off_a0 + j])
            px = int(gt.ax[off_a0 + j])
            if (py & MG_SEED_IGNORE) and j != gc.n_anchor - 1:
                continue
            qx = int(gt.ax[off_a0 + j0])
            qy = int(gt.ay[off_a0 + j0])
            l = l0
            while l < gc.off + gc.cnt:
                r = gt.lc[l]
                if r.off <= off_a0 + j < r.off + r.cnt:
                    break
                l += 1
            assert l < gc.off + gc.cnt
            # the host walk's check: a corrupt anchor offset fails here,
            # not as a length mismatch in finalize_read
            assert _i32(qx) < es[gt.lc[l0].v >> 1].len
            if l == l0:
                l_seq = _i32(px) - _i32(qx)
                seq = _es_seq(es, gt.lc[l0].v)[
                    _i32(qx) + 1: _i32(qx) + 1 + l_seq]
            else:
                v = gt.lc[l0].v
                parts = [_es_seq(es, v)[_i32(qx) + 1:]]
                for k in range(l0 + 1, l):
                    parts.append(_es_seq(es, gt.lc[k].v))
                parts.append(_es_seq(es, gt.lc[l].v)[: _i32(px) + 1])
                seq = b"".join(parts)
                l_seq = len(seq)
            qlen = _i32(py) - _i32(qy)
            qgap = qbytes[_i32(qy) + 1: _i32(qy) + 1 + qlen]
            assert l_seq > 0 or qlen > 0
            if l_seq == 0:
                _append1(ops, 1, qlen)
            elif qlen == 0:
                _append1(ops, 2, l_seq)
            elif l_seq == qlen and qlen <= ((qy >> 32) & 0xFF):
                _append1(ops, 7, qlen)
            else:
                pc.segs.append(("ops", ops))
                pc.segs.append(("job", len(jobs)))
                jobs.append((seq, qgap))
                ops = []
            j0 = j
            l0 = l
        pc.segs.append(("ops", ops))
        pr.chains.append(pc)
    cigar.release_scratch()
    return pr


def finalize_read(pr: PendingRead, results: Dict[int, List[int]]) -> None:
    """Stitch the resolved gaps into gc.p (the tail of gchain_cigar) and
    generate the ds strings."""
    gt = pr.gt
    for pc in pr.chains:
        gc = pc.gc
        cig: List[int] = []
        for kind, payload in pc.segs:
            _append_many(cig, payload if kind == "ops"
                         else results[payload])
        p = Cigar()
        off_a0 = pc.off_a0
        p.ss = _i32(int(gt.ax[off_a0])) + 1 \
            - ((int(gt.ay[off_a0]) >> 32) & 0xFF)
        p.ee = _i32(int(gt.ax[off_a0 + gc.n_anchor - 1])) + 1
        p.n_cigar = len(cig)
        p.cigar = cig
        qtot = 0
        for c in cig:
            op, ln = c & 0xF, c >> 4
            if op == 7:
                p.mlen += ln
            p.blen += ln
            if op != 1:
                p.aplen += ln
            if op != 2:
                qtot += ln
        gc.p = p
        gc.ds = None
        assert qtot == gc.qe - gc.qs and p.aplen == gc.pe - gc.ps
    gchain_gen_ds(pr.g, pr.es, pr.qseq, gt)


class DeviceWfaPool:
    """Batched exact WFA over the harvested gap jobs on `device`: the
    kernels on the card, their plain versions for device="cpu".  The
    pool keeps one tb plane per bucket across runs and counts the jobs
    aligned there (n_device) and on the host (n_host)."""

    def __init__(self, pens=PENS,
                 buckets: Tuple[Tuple[int, int, int], ...] = BUCKETS,
                 device="cuda"):
        self.pens = pens
        self.buckets = buckets
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DeviceWfaPool: no CUDA device available")
        self.n_device = 0
        self.n_host = 0
        self._tb = {}           # bucket -> its reused (s_cap, B, D) plane

    def run(self, jobs: List[Tuple[bytes, bytes]]) -> Dict[int, List[int]]:
        results: Dict[int, List[int]] = {}
        by_bucket: Dict[int, List[int]] = {}
        host_jobs: List[int] = []
        # custom buckets shorter than MIN_DEV_LEN stay reachable
        min_dev = min([MIN_DEV_LEN] + [b[0] for b in self.buckets])
        for i, (t, q) in enumerate(jobs):
            ln = max(len(t), len(q))
            if ln < min_dev:
                host_jobs.append(i)
                continue
            for bi, (lmax, _, _) in enumerate(self.buckets):
                if ln <= lmax:
                    by_bucket.setdefault(bi, []).append(i)
                    break
            else:
                host_jobs.append(i)
        for bi, idxs in by_bucket.items():
            lmax, s_cap, bsz = self.buckets[bi]
            for c0 in range(0, len(idxs), bsz):
                chunk = idxs[c0: c0 + bsz]
                pairs = [jobs[i] for i in chunk]
                pairs += [(b"A", b"A")] * (bsz - len(pairs))
                ts, tl, qs, ql = encode_pairs(pairs, L=lmax,
                                              device=self.device)
                score, tb, _, end_d, no_ext = wfa_device(
                    ts, tl, qs, ql, self.pens, d_cap=lmax, s_cap=s_cap,
                    tb=self._tb.get(bi))
                if self.device.type == "cuda":
                    self._tb[bi] = tb
                # the walk runs where the tb planes are; only the
                # (t_cap, B) op trace comes back
                ops, fi, fk = wfa_tb_walk(
                    ts, tl, qs, ql, tb, score, end_d, no_ext, self.pens,
                    d_cap=lmax, t_cap=2 * lmax + 4)
                score, ops, fi, fk = (x.cpu().numpy()
                                      for x in (score, ops, fi, fk))
                for k, i in enumerate(chunk):
                    if score[k] < 0:   # over budget: the host engine
                        host_jobs.append(i)
                        continue
                    results[i] = decode_walk(ops[:, k], int(fi[k]),
                                             int(fk[k]))
                    self.n_device += 1
        for i in host_jobs:
            t, q = jobs[i]
            results[i] = wfa_auto(t, q, cigar=True).cigar or []
            self.n_host += 1
        return results
