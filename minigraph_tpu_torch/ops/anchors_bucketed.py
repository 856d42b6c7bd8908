"""Bucketed equality-join seed collection (port of the JAX package's
ops/anchors_bucketed.py).

Keys are partitioned by the low b bits of the minimizer hash, so each
query joins only the keys of its own bucket:

  1. `spread_queries`: the step's query list (main plane, then tie
     plane) is sorted stably by bucket, each query gets its slot in the
     bucket's run, and its 9 join features plus its meta (low 12 bits,
     high 20 bits) land in a dense (11, B, nb*qb) grid.  A read with
     more than qb queries in one bucket is flagged.
  2. the probe (ops/probe.py: a CUDA kernel on the card) extracts each
     slot's payload column from its bucket's tables;
  3. `finish_anchors`: expansion, packing and the final stable sort.

The JAX version spreads and expands with one-hot matmuls; here both are
a scatter (and the expansion a running max, as in ops/anchors.py), which
give the same values: every spread slot and every anchor slot receives
at most one term.  Tables are built in numpy exactly as the JAX
BucketedJoinIndex builds them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .anchors import (_seg_len, expand_bands, join_features, join_planes,
                      pack_anchors)
from .probe import probe_bucketed


@dataclass
class BucketedJoinIndex:
    """Per-bucket tables of the bucketed join (f32, on one device)."""
    keymat: torch.Tensor   # (nb, 9, KB) equality-join matrix
    keyext: torch.Tensor   # (nb, EXT, KB) payload, EXT = 2 + 3*occ_cap
    b_bits: int
    kb: int
    occ_cap: int

    @staticmethod
    def host_arrays(gi, occ_cap: int = 16, b_bits: int | None = None) -> dict:
        """numpy keymat/keyext exactly as ops/anchors_bucketed.py builds
        them."""
        keys = np.asarray(gi.keys, dtype=np.uint64)
        start = np.asarray(gi.key_start, dtype=np.int64)
        cnt = np.asarray(gi.key_cnt, dtype=np.int64)
        pos = np.asarray(gi.pos, dtype=np.uint64)
        seg_len = _seg_len(gi)
        K = len(keys)
        if b_bits is None:
            b_bits = 6 if K > 4096 else max(0, K.bit_length() - 6)
        nb = 1 << b_bits
        # bucket by the LOW hash bits: minimizers are window minima, so
        # their hash values skew small and the top bits are non-uniform
        bkt = (keys & np.uint64(nb - 1)).astype(np.int64)
        order = np.argsort(bkt, kind="stable")
        keys, start, cnt, bkt = keys[order], start[order], cnt[order], \
            bkt[order]
        counts = np.bincount(bkt, minlength=nb)
        KB = max(int(counts.max(initial=1)), 8)
        KB = -(-KB // 512) * 512 if KB > 256 else KB
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        EXT = 2 + 3 * occ_cap
        keymat = np.zeros((nb, 9, KB), np.float32)
        keymat[:, 8, :] = 1.0          # padding columns never match
        keyext = np.zeros((nb, EXT, KB), np.float32)
        Kc = np.stack([((keys >> np.uint64(9 * i)) & np.uint64(0x1FF))
                       .astype(np.float32) for i in range(4)], -1)
        jv = np.arange(K, dtype=np.int64)
        v = bkt
        jj = jv - starts[v]
        for i in range(4):
            keymat[v, 2 * i, jj] = 1.0
            keymat[v, 2 * i + 1, jj] = -2.0 * Kc[:, i]
        keymat[v, 8, jj] = (Kc ** 2).sum(1)
        keyext[v, 0, jj] = cnt
        keyext[v, 1, jj] = 1.0
        # flatten (key, hit slot) pairs for the position rows
        m = np.minimum(cnt, occ_cap)
        rows = np.repeat(jv, m)
        cols = np.arange(len(rows)) - np.repeat(np.cumsum(m) - m, m)
        p = pos[np.repeat(start, m) + cols]
        rid = (p >> np.uint64(32)).astype(np.int64)
        rposs = ((p & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
        strand = (p & np.uint64(1)).astype(np.int64)
        rv, rj = v[rows], jj[rows]
        keyext[rv, 2 + cols, rj] = (rid << 1) | strand
        keyext[rv, 2 + occ_cap + cols, rj] = rposs
        keyext[rv, 2 + 2 * occ_cap + cols, rj] = seg_len[rid] - rposs - 2
        return {"keymat": keymat, "keyext": keyext}

    @classmethod
    def from_host(cls, gi, occ_cap: int = 16, device="cuda",
                  b_bits: int | None = None) -> "BucketedJoinIndex":
        return cls.from_arrays(cls.host_arrays(gi, occ_cap, b_bits), device)

    @classmethod
    def from_arrays(cls, arrays: dict, device) -> "BucketedJoinIndex":
        keymat = np.array(arrays["keymat"], dtype=np.float32)
        keyext = np.array(arrays["keyext"], dtype=np.float32)
        nb, _, KB = keymat.shape
        if nb & (nb - 1) or keyext.shape[0] != nb or keyext.shape[2] != KB:
            raise ValueError("bucketed tables must be (2^b, 9, KB) and "
                             "(2^b, EXT, KB)")
        return cls(keymat=torch.from_numpy(keymat).to(device),
                   keyext=torch.from_numpy(keyext).to(device),
                   b_bits=nb.bit_length() - 1, kb=KB,
                   occ_cap=(keyext.shape[1] - 2) // 3)


def spread_queries(hh, hl, meta, t_hh, t_hl, t_meta, nb: int,
                   qcap: int = 512, qb: int = 24):
    """Compact the emitted minimizers, group them by bucket and spread
    them to the dense (B, SB = nb*qb) grid: 9 join features + meta low
    12 bits + meta high 20 bits, float32, plane-major.  Returns
    (sf (11, B, SB), n_q (B,) int32, q_overflow (B,) bool)."""
    B = hh.shape[0]
    dev = hh.device
    SB = nb * qb
    chh, chl, cmeta, cemit = join_planes(hh, hl, meta, t_hh, t_hl, t_meta)
    n_q = cemit.sum(1).to(torch.int32)
    # stable sort by bucket (low hash bits); non-emitted slots last
    skey = torch.where(cemit, chl & (nb - 1), nb + 1)
    skey, perm = torch.sort(skey, dim=1, stable=True)
    skey, perm = skey[:, :qcap], perm[:, :qcap]
    qhh, qhl, qmeta = (torch.gather(a, 1, perm) for a in (chh, chl, cmeta))
    qvalid = torch.arange(qcap, device=dev)[None, :] \
        < torch.clamp(n_q, max=qcap)[:, None]
    # slot within the bucket's run
    idx = torch.arange(qcap, device=dev).expand(B, qcap)
    new_run = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                         skey[:, 1:] != skey[:, :-1]], 1)
    slot = idx - torch.cummax(torch.where(new_run, idx, -1), 1).values
    lost = qvalid & (slot >= qb)
    ok = qvalid & ~lost
    flatkey = torch.where(ok, skey * qb + slot, SB)
    f32 = torch.float32
    feats = join_features(qhh, qhl) + [(qmeta & 0xFFF).to(f32),
                                       (qmeta >> 12).to(f32)]
    featv = torch.stack([torch.where(ok, f, 0.0) for f in feats])
    sf = torch.zeros((11, B, SB + 1), dtype=f32, device=dev)
    sf.scatter_(2, flatkey.expand(11, B, qcap), featv)
    return sf[..., :SB], n_q, (n_q > qcap) | lost.any(1)


def finish_anchors(ext, sf, max_occ: int, occ_cap: int, acap: int = 2048):
    """Expansion, anchor packing and the final sort from the probe's
    (EXT, B, SB) output.  Returns (axh, axl, ayh, ayl, n_a, a_overflow);
    slots of the grid that hold no query (sf[8] == 0) are ignored."""
    _, B, SB = ext.shape
    present = sf[8] > 0          # the constant-1 feature marks real slots
    # an empty slot's output is a column sum that may exceed int64
    cnt = torch.where(present, ext[0], 0.0).to(torch.int64)
    keep = (ext[1] > 0) & present & (cnt < max_occ)
    occ = torch.where(keep, torch.clamp(cnt, max=occ_cap), 0)
    occ_byte = torch.where(keep, torch.clamp(cnt, max=255), 0)
    qidx, rank, a_valid, n_a, n_tot = expand_bands(occ, acap)

    def take_q(a):
        return torch.gather(a, 1, qidx)

    qmeta = (sf[10].to(torch.int64) << 12) | sf[9].to(torch.int64)
    slot = torch.where(a_valid, rank, 0)

    def hit(col0):
        """Row col0 + (the anchor's hit slot) of its emission's column."""
        rows = ext[col0: col0 + occ_cap].permute(1, 0, 2) \
            .reshape(B, occ_cap * SB)
        return torch.gather(rows, 1, slot * SB + qidx).to(torch.int64)

    axh, axl, ayh, ayl, _ = pack_anchors(
        hit(2), hit(2 + occ_cap), hit(2 + 2 * occ_cap), take_q(occ_byte),
        take_q(qmeta), a_valid, acap)
    return axh, axl, ayh, ayl, n_a, n_tot > acap


def collect_anchors_bucketed(bi: BucketedJoinIndex, hh, hl, meta, t_hh,
                             t_hl, t_meta, max_occ: int, occ_cap: int,
                             qcap: int = 512, qb: int = 24,
                             acap: int = 2048):
    """Bucketed anchor collection; contract of
    ops/anchors.py collect_anchors_join."""
    nb = bi.keymat.shape[0]
    sf, _, q_overflow = spread_queries(hh, hl, meta, t_hh, t_hl, t_meta, nb,
                                       qcap=qcap, qb=qb)
    ext = probe_bucketed(sf[:9], bi.keymat, bi.keyext)
    *planes, a_overflow = finish_anchors(ext, sf, max_occ, occ_cap,
                                         acap=acap)
    return (*planes, q_overflow | a_overflow)
