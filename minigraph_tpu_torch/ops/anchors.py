"""Seed-hit collection from sketch planes (collect_seed_hits semantics,
map-algo.c:58-192).

Ports of the JAX package's collectors.  The two exact ones, which the
device front chooses between by index size, keep the reference's
emission order:

* `collect_anchors_exact` (ops/anchors_jax.py) with `JoinIndex`: the
  JAX version probes with an equality join on the matrix unit; here the
  probe is a binary search over the sorted keys recovered from the same
  tables.  Both read each key's payload row from `keyext`, so every
  output is the same, including the occ_cap truncation flag.
* `collect_anchors_exact_hash` (ops/anchors_hash.py) with
  `HashJoinIndex`: the two-choice cuckoo probe, with the same tables.

The three of the batched map step (ops/pipeline.py) take the main
plane's emissions before the tie plane's, flag tandems by main-plane
adjacency and every tie as a tandem, and raise only the qcap/acap
overflow flag:

* `collect_anchors_join` (anchors_jax.py) with `JoinIndex`, probed by
  the same binary search;
* `collect_anchors_hash` (anchors_hash.py) with `HashJoinIndex`;
* `collect_anchors_flat` (anchors_jax.py
  `collect_anchors_flat_pallas_traced`) with `JoinIndex`: the flat
  probe (ops/probe.py, a CUDA kernel on the card) over the padded
  km_p/ke_p tables.

Apart from that probe, all are plain PyTorch on whatever device the
planes live on.  Planes hold u32 values in int64 tensors (ops/u32.py);
padding is U32MAX.  The band expansion from per-emission hit lists to
anchor slots is a scatter and a running max (the JAX join's one-hot
matmul gives the same values).  The anchor sorts are stable sorts on
the unsigned (axh, axl) key, packed into one int64 (axh = rid<<1|rev
stays below 2**31), so equal keys keep generation order exactly as the
JAX sorts' is_stable=True does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import u32
from .sketch import META_Q_BITS
from ..utils import trace

U32MAX = u32.U32MAX
INT64_MAX = (1 << 63) - 1

# multiply-shift constants for the two cuckoo table choices
MUL1A, MUL1B = 0x9E3779B1, 0x85EBCA77
MUL2A, MUL2B = 0xC2B2AE3D, 0x27D4EB2F


def _seg_len(gi) -> np.ndarray:
    return np.asarray([s.len for s in gi.g.seg], dtype=np.int64)


@dataclass
class JoinIndex:
    """Flat-join tables: the JAX JoinIndex's keymat/keyext and its padded
    km_p/ke_p for the flat probe, plus the sorted keys recovered from
    keymat for the binary-search probe."""
    keymat: torch.Tensor   # (9, K) f32 equality-join matrix
    keyext: torch.Tensor   # (K, 2 + 3*occ_cap) f32 payload rows
    km_p: torch.Tensor     # (1, 9, Kpad) keymat, padding never matches
    ke_p: torch.Tensor     # (1, EXT, Kpad) keyext transposed, padded
    keys: torch.Tensor     # (K,) int64 sorted minimizers
    cols: torch.Tensor     # (K,) keyext row of each sorted key
    occ_cap: int

    @staticmethod
    def host_arrays(gi, occ_cap: int = 16) -> dict:
        """numpy keymat/keyext exactly as ops/anchors_jax.py builds them."""
        keys = np.asarray(gi.keys, dtype=np.uint64)
        start = np.asarray(gi.key_start, dtype=np.int64)
        cnt = np.asarray(gi.key_cnt, dtype=np.int64)
        pos = np.asarray(gi.pos, dtype=np.uint64)
        seg_len = _seg_len(gi)
        K = len(keys)
        if keys.max(initial=0) >= 1 << 36:
            raise ValueError("minimizer exceeds join width")
        Kc = np.stack([((keys >> np.uint64(9 * i)) & np.uint64(0x1FF))
                       .astype(np.float32) for i in range(4)], -1)
        keymat = np.zeros((9, K), np.float32)
        for i in range(4):
            keymat[2 * i] = 1.0
            keymat[2 * i + 1] = -2.0 * Kc[:, i]
        keymat[8] = (Kc ** 2).sum(1)
        # payload: [cnt, 1(found)] + per hit slot [rid<<1|strand, rpos,
        # seg_len-rpos-2]; all values < 2^24 so f32 holds them exactly
        ext = np.zeros((K, 2 + 3 * occ_cap), np.float32)
        ext[:, 0] = cnt
        ext[:, 1] = 1.0
        n = np.minimum(cnt, occ_cap)
        slot = np.arange(occ_cap)[None, :]
        ok = slot < n[:, None]
        p = pos[np.where(ok, start[:, None] + slot, 0)] if len(pos) \
            else np.zeros((K, occ_cap), np.uint64)
        rid = (p >> np.uint64(32)).astype(np.int64)
        rposs = ((p & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
        strand = (p & np.uint64(1)).astype(np.int64)
        if rid[ok].max(initial=0) >= 1 << 23 \
                or rposs[ok].max(initial=0) >= 1 << 23:
            raise ValueError("graph too large for the f32 join payload")
        ext[:, 2: 2 + occ_cap] = np.where(ok, (rid << 1) | strand, 0)
        ext[:, 2 + occ_cap: 2 + 2 * occ_cap] = np.where(ok, rposs, 0)
        ext[:, 2 + 2 * occ_cap:] = np.where(
            ok, seg_len[rid] - rposs - 2, 0)
        return {"keymat": keymat, "keyext": ext}

    @classmethod
    def from_host(cls, gi, occ_cap: int = 16, device="cuda") -> "JoinIndex":
        return cls.from_arrays(cls.host_arrays(gi, occ_cap), device)

    @classmethod
    def from_arrays(cls, arrays: dict, device) -> "JoinIndex":
        keymat = np.array(arrays["keymat"], dtype=np.float32)
        keyext = np.array(arrays["keyext"], dtype=np.float32)
        K = keymat.shape[1]
        # padded as ops/anchors_jax.py JoinIndex.from_host pads them
        kpad = max(256, -(-K // 256) * 256)
        km_p = np.zeros((1, 9, kpad), np.float32)
        km_p[0, 8, :] = 1.0
        km_p[0, :, :K] = keymat
        ke_p = np.zeros((1, keyext.shape[1], kpad), np.float32)
        ke_p[0, :, :K] = keyext.T
        # keymat row 2i+1 holds -2 * (9-bit chunk i) of each key
        ch = np.rint(-keymat[1:8:2] / 2).astype(np.int64)      # (4, K)
        keys = ch[0] | (ch[1] << 9) | (ch[2] << 18) | (ch[3] << 27)
        order = np.argsort(keys, kind="stable")
        return cls(keymat=torch.from_numpy(keymat).to(device),
                   keyext=torch.from_numpy(keyext).to(device),
                   km_p=torch.from_numpy(km_p).to(device),
                   ke_p=torch.from_numpy(ke_p).to(device),
                   keys=torch.from_numpy(keys[order]).to(device),
                   cols=torch.from_numpy(order.astype(np.int64)).to(device),
                   occ_cap=(keyext.shape[1] - 2) // 3)


def _slot_hashes_np(hh, hl, hbits):
    a1 = hl * np.uint32(MUL1A) + hh * np.uint32(MUL1B)
    a2 = hl * np.uint32(MUL2A) + hh * np.uint32(MUL2B)
    return (a1 >> np.uint32(32 - hbits)), (a2 >> np.uint32(32 - hbits))


CUCKOO_STEPS = 200   # moves a key's walk may make before the table grows
CUCKOO_TRIES = 6     # table sizes tried, one more hbits each
# the payload start<<10 | cnt<<2 | hh&3 must stay below 2^63
START_LIMIT = 1 << 53


def cuckoo_table(hh, hl, hbits: int) -> tuple:
    """(table, hbits): the key index in each of the 2^hbits slots (-1
    where empty), walked in C (csrc/cuckoo.c) from the two slot hashes
    of each key; a walk that gives up retries at one more hbits, six
    sizes in all, as ops/anchors_hash.py does."""
    from ..utils.native import get_lib
    lib = get_lib()
    for _ in range(CUCKOO_TRIES):
        if hbits > 32:
            raise ValueError("cuckoo table past 2^32 slots")
        s1, s2 = (np.ascontiguousarray(s, dtype=np.uint32)
                  for s in _slot_hashes_np(hh, hl, hbits))
        table = np.empty(1 << hbits, dtype=np.int32)
        if lib.mgt_cuckoo_walk(s1.ctypes.data, s2.ctypes.data, len(s1),
                               table.ctypes.data, len(table),
                               CUCKOO_STEPS) < 0:
            return table, hbits
        hbits += 1
    raise RuntimeError("cuckoo build failed")


@dataclass
class HashJoinIndex:
    """Cuckoo hash table + position planes (u32 values, int64 tensors).

    The JAX package's table holds minimizers below 2^34 (k <= 17): the
    key's high bits ride in the payload's two low bits.  For wider keys
    (asm's k = 19, sr's k = 21) the port adds tag_hi, the whole high
    word of each slot's key, and checks it instead; the other tables
    stay as the JAX package builds them.  Where a payload reaches
    U32MAX (a start of 2^22 or more: a position array past ~4.19 M
    entries), pay keeps its layout in 64 bits and an empty slot holds
    -1 (`empty`)."""
    tag: torch.Tensor    # (H,) low 32 bits of the minimizer
    pay: torch.Tensor    # (H,) start<<10 | min(cnt,255)<<2 | hash_hi2
    p_rid: torch.Tensor  # (P,) rid<<1|strand
    p_sel: torch.Tensor  # (2P,) interleaved [rpos, seg_len-rpos-2]
    hbits: int
    occ_cap: int
    tag_hi: Optional[torch.Tensor] = None  # (H,) keys >> 32, wide keys
    empty: int = U32MAX  # pay of an empty slot

    @staticmethod
    def host_arrays(gi) -> dict:
        """numpy tables exactly as ops/anchors_hash.py builds them."""
        return HashJoinIndex.key_arrays(
            np.asarray(gi.keys, dtype=np.uint64),
            np.asarray(gi.key_start, dtype=np.int64),
            np.asarray(gi.key_cnt, dtype=np.int64),
            np.asarray(gi.pos, dtype=np.uint64), _seg_len(gi))

    @staticmethod
    def key_arrays(keys, start, cnt, pos, seg_len, hbits_min: int = 0) -> dict:
        """numpy tables from flat index arrays (ops/anchors_hash.py
        HashJoinIndex.from_arrays): an "idx" shard's keys with their
        rebased starts; hbits_min forces a common table size over the
        shards.  While every payload stays below U32MAX, the empty
        slots' value, the tables are the JAX package's, pay as uint32;
        past that pay is int64 with empty slots -1."""
        keys = np.asarray(keys, dtype=np.uint64)
        start = np.asarray(start, dtype=np.int64)
        cnt = np.asarray(cnt, dtype=np.int64)
        pos = np.asarray(pos, dtype=np.uint64)
        seg_len = np.asarray(seg_len, dtype=np.int64)
        K = len(keys)
        wide = keys.max(initial=0) >= 1 << 34
        if start.max(initial=0) >= START_LIMIT:
            raise ValueError("position array too large for a 64-bit payload")
        hh = (keys >> np.uint64(32)).astype(np.uint32)
        hl = keys.astype(np.uint32)
        pay = (start << 10) | (np.minimum(cnt, 255) << 2) \
            | (hh & np.uint32(3)).astype(np.int64)
        empty = U32MAX if pay.max(initial=0) < U32MAX else -1
        hbits = max(4, hbits_min, int(np.ceil(np.log2(max(K, 1) * 2))))
        with trace.span("setup.front.cuckoo"):
            table, hbits = cuckoo_table(hh, hl, hbits)
        H = 1 << hbits
        tag = np.zeros(H, dtype=np.uint32)
        payt = np.full(H, empty, dtype=np.uint32 if empty == U32MAX
                       else np.int64)
        filled = table >= 0
        tag[filled] = hl[table[filled]]
        payt[filled] = pay[table[filled]]
        p_rid = ((pos >> np.uint64(32)).astype(np.uint32) << np.uint32(1)) \
            | (pos & np.uint64(1)).astype(np.uint32)
        p_pos = ((pos & np.uint64(0xFFFFFFFF)) >> np.uint64(1)) \
            .astype(np.uint32)
        rid = (pos >> np.uint64(32)).astype(np.int64)
        p_base = (seg_len[rid] - p_pos.astype(np.int64) - 2).astype(np.uint32)
        p_sel = np.zeros(2 * max(len(pos), 1), dtype=np.uint32)
        p_sel[0: 2 * len(pos): 2] = p_pos
        p_sel[1: 2 * len(pos): 2] = p_base
        out = {"tag": tag, "pay": payt, "p_rid": p_rid, "p_sel": p_sel,
               "hbits": hbits}
        if wide:
            tag_hi = np.zeros(H, dtype=np.uint32)
            tag_hi[filled] = hh[table[filled]]
            out["tag_hi"] = tag_hi
        return out

    @classmethod
    def from_host(cls, gi, occ_cap: int = 16, device="cuda"):
        return cls.from_arrays(cls.host_arrays(gi), occ_cap, device)

    @classmethod
    def from_arrays(cls, arrays: dict, occ_cap: int, device):
        def t(name):
            return u32.from_numpy(np.asarray(arrays[name]), device)
        pay = np.asarray(arrays["pay"])
        return cls(tag=t("tag"), pay=t("pay"), p_rid=t("p_rid"),
                   p_sel=t("p_sel"), hbits=int(arrays["hbits"]),
                   occ_cap=occ_cap,
                   tag_hi=t("tag_hi") if "tag_hi" in arrays else None,
                   empty=-1 if pay.dtype == np.int64 else U32MAX)


def tables_from_numpy(kind: str, arrays: dict, device, occ_cap: int = 16):
    """The port's index tables from the JAX package's, as numpy arrays:
    kind "join" takes JoinIndex keymat/keyext, kind "hash" takes
    HashJoinIndex tag/pay/p_rid/p_sel/hbits, kind "bucketed" takes
    BucketedJoinIndex keymat/keyext."""
    if kind == "join":
        return JoinIndex.from_arrays(arrays, device)
    if kind == "hash":
        return HashJoinIndex.from_arrays(arrays, occ_cap, device)
    if kind == "bucketed":
        from .anchors_bucketed import BucketedJoinIndex
        return BucketedJoinIndex.from_arrays(arrays, device)
    raise ValueError(f"unknown table kind {kind!r}")


def _tandem_flags(hh, hl, emitted):
    """MG_SEED_TANDEM: an emitted minimizer whose hash equals the
    previous or the next emitted hash (collect_matches, map-algo.c:73-86)."""
    B, S = hh.shape
    dev = hh.device
    key = torch.where(emitted, (hh << 32) | hl, -1)   # hh < 4 when emitted
    iota = torch.arange(S, device=dev).expand(B, S)
    last = torch.cummax(torch.where(emitted, iota, -1), dim=1).values
    prev = torch.cat([torch.full((B, 1), -1, device=dev, dtype=last.dtype),
                      last[:, :-1]], 1)
    nxt_incl = torch.flip(torch.cummin(torch.flip(
        torch.where(emitted, iota, S), [1]), dim=1).values, [1])
    nxt = torch.cat([nxt_incl[:, 1:],
                     torch.full((B, 1), S, device=dev, dtype=last.dtype)], 1)

    def at(j, none):
        v = torch.gather(key, 1, torch.clamp(j, 0, S - 1))
        return torch.where(none, -2, v)

    eq_prev = key == at(prev, prev < 0)
    eq_next = key == at(nxt, nxt >= S)
    return emitted & (eq_prev | eq_next)


def merge_planes(hh, hl, meta, t_hh, t_hl, t_meta):
    """Interleave main/tie planes into the reference emission order
    (slot 2t = main, 2t+1 = tie) and set the tandem bit (meta bit 31).
    Returns (mhh, mhl, mmeta, memit), each (B, 2S)."""
    B, S = hh.shape

    def ilv(a, b):
        return torch.stack([a, b], 2).reshape(B, 2 * S)

    mhh, mhl, mmeta = ilv(hh, t_hh), ilv(hl, t_hl), ilv(meta, t_meta)
    memit = mmeta != U32MAX
    tand = _tandem_flags(mhh, mhl, memit)
    mmeta = torch.where(tand, mmeta | (1 << 31), mmeta)
    return mhh, mhl, mmeta, memit


def _compact_queries(chh, chl, cmeta, cemit, qcap):
    """Emitted slots in order into (B, qcap) planes (the stable boolean
    sort of the JAX version; non-emitted slots are all-U32MAX, so the
    padding equals what the sort leaves there)."""
    B, S2 = chh.shape
    dev = chh.device
    n_q = cemit.sum(1).to(torch.int32)
    rank = torch.cumsum(cemit.to(torch.int64), 1) - 1
    put = cemit & (rank < qcap)
    dst = torch.where(put, rank, qcap)

    def comp(a):
        out = torch.full((B, qcap + 1), U32MAX, dtype=a.dtype, device=dev)
        out.scatter_(1, dst, torch.where(put, a, U32MAX))
        return out[:, :qcap]

    qvalid = torch.arange(qcap, device=dev)[None, :] \
        < torch.clamp(n_q, max=qcap)[:, None]
    return comp(chh), comp(chl), comp(cmeta), n_q, qvalid


def _unpack_qmeta(qmeta):
    z = qmeta & 1
    qpos = (qmeta >> 1) & ((1 << META_Q_BITS) - 1)
    span = (qmeta >> (META_Q_BITS + 1)) & 0x1F
    tandem = qmeta >> 31
    return z, qpos, span, tandem


def _sort_anchors(axh, axl, ayh, ayl, acap):
    """Stable sort by the unsigned (axh, axl) key; padding sorts last."""
    key = torch.where(axh == U32MAX, INT64_MAX, (axh << 32) | axl)
    key, perm = torch.sort(key, dim=1, stable=True)
    perm = perm[:, :acap]
    g = lambda a: torch.gather(a, 1, perm)  # noqa: E731
    return g(axh), g(axl), g(ayh), g(ayl), key[:, :acap]


def _dup_flag(axh, key):
    """Duplicate x keys: the reference's in-place radix sort permutes
    equal keys unpredictably, so such reads take the host path."""
    return ((key[:, 1:] == key[:, :-1]) & (axh[:, 1:] != U32MAX)).any(1)


def join_planes(hh, hl, meta, t_hh, t_hl, t_meta):
    """The step collectors' query planes (ops/anchors_jax.py
    collect_anchors_join): the main plane's slots, then the tie plane's;
    tandem = a main emission whose hash equals the previous or the next
    main emission's, and every tie.  Returns (chh, chl, cmeta, cemit),
    each (B, 2S)."""
    emitted = meta != U32MAX
    t_emitted = t_meta != U32MAX
    tand = _tandem_flags(hh, hl, emitted)
    meta_t = torch.where(tand, meta | (1 << 31), meta)
    t_meta_t = torch.where(t_emitted, t_meta | (1 << 31), t_meta)
    return (torch.cat([hh, t_hh], 1), torch.cat([hl, t_hl], 1),
            torch.cat([meta_t, t_meta_t], 1),
            torch.cat([emitted, t_emitted], 1))


def join_features(qhh, qhl):
    """The 9 equality-join features of each query (ops/anchors_jax.py):
    c^2 and c for the four 9-bit chunks of the 36-bit minimizer, then 1.
    Every value is an integer below 2^18, exact in float32."""
    f32 = torch.float32
    feats = []
    for i in range(3):
        c = ((qhl >> (9 * i)) & 0x1FF).to(f32)
        feats += [c * c, c]
    c3 = (((qhh << 5) | (qhl >> 27)) & 0x1FF).to(f32)
    return feats + [c3 * c3, c3, torch.ones_like(c3)]


def _join_probe(ji: JoinIndex, qhh, qhl, qvalid, occ_cap):
    """The flat join's match, found by binary search over the sorted
    keys: (found, ext) with ext the matched key's keyext row."""
    B, qcap = qhh.shape
    m = ((qhh & 0xF) << 32) | qhl
    K = ji.keys.numel()
    if not K:
        return (torch.zeros_like(qvalid),
                torch.zeros((B, qcap, 2 + 3 * occ_cap), dtype=torch.float32,
                            device=qhh.device))
    at = torch.clamp(torch.searchsorted(ji.keys, m), max=K - 1)
    return qvalid & (ji.keys[at] == m), ji.keyext[ji.cols[at]]


def _hash_probe(hi: HashJoinIndex, qhh, qhl, qvalid):
    """Two cuckoo choices -> (found, cnt, start)."""
    sh = 32 - hi.hbits
    s1 = ((_mul32(qhl, MUL1A) + _mul32(qhh, MUL1B)) & U32MAX) >> sh
    s2 = ((_mul32(qhl, MUL2A) + _mul32(qhh, MUL2B)) & U32MAX) >> sh
    t1, y1 = hi.tag[s1], hi.pay[s1]
    t2, y2 = hi.tag[s2], hi.pay[s2]
    if hi.tag_hi is None:
        h1, h2 = y1 & 3, y2 & 3
    else:
        h1, h2 = hi.tag_hi[s1], hi.tag_hi[s2]
    hit1 = (t1 == qhl) & (h1 == qhh) & (y1 != hi.empty)
    hit2 = (t2 == qhl) & (h2 == qhh) & (y2 != hi.empty)
    payv = torch.where(hit1, y1, y2)
    found = (hit1 | hit2) & qvalid
    return (found, torch.where(found, (payv >> 2) & 0xFF, 0),
            torch.where(found, payv >> 10, 0))


def expand_bands(occ, acap):
    """Band expansion: anchor slot r of a read belongs to emission q iff
    offs_q <= r < offs_q + occ_q, offs the exclusive prefix sum of occ.
    Scatter q+1 at offs_q, then a running max.  Emissions at
    offs >= acap belong to reads already flagged (n_tot > acap); the
    clamp keeps them out of the next read's slots.  Returns (qidx, rank,
    a_valid, n_a, n_tot), the first three (B, acap)."""
    B, qcap = occ.shape
    dev = occ.device
    offs = torch.cumsum(occ, 1) - occ
    n_tot = occ.sum(1)
    n_a = torch.clamp(n_tot, max=acap).to(torch.int32)
    live = (occ > 0) & (offs < acap)
    rowb = torch.arange(B, device=dev)[:, None]
    flat_i = torch.where(live, rowb * acap + offs, B * acap)
    q1 = torch.arange(1, qcap + 1, device=dev).expand(B, qcap)
    mark = torch.zeros(B * acap + 1, dtype=torch.int64, device=dev)
    mark.scatter_reduce_(0, flat_i.reshape(-1), q1.reshape(-1), "amax")
    mark = mark[: B * acap].reshape(B, acap)
    qidx = torch.clamp(torch.cummax(mark, 1).values - 1, min=0)
    a_iota = torch.arange(acap, device=dev)[None, :]
    rank = a_iota - torch.gather(offs, 1, qidx)
    return qidx, rank, a_iota < n_a[:, None], n_a, n_tot


def pack_anchors(rid_strand, rpos, base, occ_b, qmeta, valid, acap):
    """Anchor planes from per-anchor hits, sorted by x: tpos = rpos on
    the forward strand, base + span on the reverse (base =
    seg_len - rpos - 2); slots outside `valid` are padding.  Returns
    (axh, axl, ayh, ayl, key) as _sort_anchors."""
    z, qpos, span, tandem = _unpack_qmeta(qmeta)
    rev = (rid_strand & 1) ^ z
    tpos = torch.where(rev == 0, rpos, base + span)

    def pad(a):
        return torch.where(valid, a, U32MAX)

    return _sort_anchors(pad(((rid_strand >> 1) << 1) | rev),
                         pad(tpos & U32MAX),
                         pad((occ_b << 24) | (tandem << 10) | span),
                         pad(qpos), acap)


def collect_anchors_exact(ji: JoinIndex, hh, hl, meta, t_hh, t_hl, t_meta,
                          max_occ: int, occ_cap: int, qcap: int = 512,
                          acap: int = 2048) -> dict:
    """Byte-parity anchor collection with the flat-join tables.

    Returns a dict: axh/axl/ayh/ayl (B, acap) anchor planes sorted by x
    with reference tie order, n_a (B,) int32, overflow (B,) bool, q_cnt
    (B, qcap) true index occurrence per emission (0 = not indexed),
    q_meta (B, qcap) tandem<<31|span<<26|qpos<<1|strand (U32MAX pad),
    n_q (B,) int32 total emissions."""
    B = hh.shape[0]
    dev = hh.device
    chh, chl, cmeta, cemit = merge_planes(hh, hl, meta, t_hh, t_hl, t_meta)
    qhh, qhl, qmeta, n_q, qvalid = _compact_queries(chh, chl, cmeta, cemit,
                                                    qcap)
    q_overflow = n_q > qcap

    # probe: the join matches a query iff its 36-bit chunked value equals
    # a key; binary search over the sorted keys finds the same row
    found, ext = _join_probe(ji, qhh, qhl, qvalid, occ_cap)
    cnt = torch.where(found, ext[..., 0].to(torch.int64), 0)
    keep = found & (cnt < max_occ)
    occ = torch.where(keep, torch.clamp(cnt, max=occ_cap), 0)
    occ_byte = torch.where(keep, torch.clamp(cnt, max=255), 0)
    n_tot = occ.sum(1)
    n_a = torch.clamp(n_tot, max=acap).to(torch.int32)
    a_overflow = n_tot > acap
    # silent anchor loss: cnt in (occ_cap, max_occ) would drop hits
    trunc = (keep & (cnt > occ_cap)).any(1)

    # direct (query, slot) grid
    slot_ok = torch.arange(occ_cap, device=dev)[None, None, :] \
        < occ[..., None]

    def grid(a):
        return a.expand(B, qcap, occ_cap).reshape(B, qcap * occ_cap)

    axh, axl, ayh, ayl, key = pack_anchors(
        grid(ext[..., 2: 2 + occ_cap].to(torch.int64)),
        grid(ext[..., 2 + occ_cap: 2 + 2 * occ_cap].to(torch.int64)),
        grid(ext[..., 2 + 2 * occ_cap: 2 + 3 * occ_cap].to(torch.int64)),
        grid(occ_byte[..., None]), grid(qmeta[..., None]), grid(slot_ok),
        acap)
    dup = _dup_flag(axh, key)
    return {"axh": axh, "axl": axl, "ayh": ayh, "ayl": ayl, "n_a": n_a,
            "overflow": q_overflow | a_overflow | trunc | dup,
            "q_cnt": torch.where(qvalid, cnt, 0),
            "q_meta": torch.where(qvalid, qmeta, U32MAX),
            "n_q": n_q}


def _mul32(a, c: int):
    """(a * c) mod 2**32 for u32 values a, without leaving int64."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & U32MAX


def _hash_anchors(hi: HashJoinIndex, qmeta, start, occ, occ_byte, acap):
    """Expansion and per-anchor position fetch of the hash collectors:
    (axh, axl, ayh, ayl, key, n_a, n_tot)."""
    qidx, rank, a_valid, n_a, n_tot = expand_bands(occ, acap)

    def take_q(a):
        return torch.gather(a, 1, qidx)

    idx = torch.where(a_valid, take_q(start) + rank, 0)
    p_rid = hi.p_rid if hi.p_rid.numel() else \
        torch.zeros(1, dtype=torch.int64, device=occ.device)
    rid_strand = p_rid[idx]
    qmeta_a = take_q(qmeta)
    # p_sel interleaves [rpos, base]: rev picks the coordinate
    rev = (rid_strand & 1) ^ (qmeta_a & 1)
    val = u32.as_i32(hi.p_sel[(idx << 1) | rev]).to(torch.int64)
    return (*pack_anchors(rid_strand, val, val, take_q(occ_byte), qmeta_a,
                          a_valid, acap), n_a, n_tot)


def collect_anchors_exact_hash(hi: HashJoinIndex, hh, hl, meta, t_hh, t_hl,
                               t_meta, max_occ: int, occ_cap: int,
                               qcap: int = 512, acap: int = 2048) -> dict:
    """Byte-parity anchor collection with the cuckoo-hash tables
    (ops/anchors_hash.py collect_anchors_exact_hash, default path).
    Same contract as collect_anchors_exact."""
    chh, chl, cmeta, cemit = merge_planes(hh, hl, meta, t_hh, t_hl, t_meta)
    qhh, qhl, qmeta, n_q, qvalid = _compact_queries(chh, chl, cmeta, cemit,
                                                    qcap)
    q_overflow = n_q > qcap
    found, cnt, start = _hash_probe(hi, qhh, qhl, qvalid)
    keep = found & (cnt < max_occ)
    occ = torch.where(keep, torch.clamp(cnt, max=occ_cap), 0)
    occ_byte = torch.where(keep, cnt, 0)      # table caps at 255
    trunc = (keep & (cnt > occ_cap)).any(1)
    if max_occ > 255:
        trunc = trunc | (found & (cnt == 255)).any(1)
    axh, axl, ayh, ayl, key, n_a, n_tot = _hash_anchors(
        hi, qmeta, start, occ, occ_byte, acap)
    dup = _dup_flag(axh, key)
    return {"axh": axh, "axl": axl, "ayh": ayh, "ayl": ayl, "n_a": n_a,
            "overflow": q_overflow | (n_tot > acap) | trunc | dup,
            "q_cnt": torch.where(qvalid, cnt, 0),
            "q_meta": torch.where(qvalid, qmeta, U32MAX),
            "n_q": n_q}


def step_queries(hh, hl, meta, t_hh, t_hl, t_meta, qcap):
    """The step collectors' emitted queries in order, compacted to qcap:
    (qhh, qhl, qmeta, n_q, qvalid), the first three (B, qcap)."""
    chh, chl, cmeta, cemit = join_planes(hh, hl, meta, t_hh, t_hl, t_meta)
    return _compact_queries(chh, chl, cmeta, cemit, qcap)


def flat_queries(qhh, qhl, qvalid):
    """The flat probe's (9, B, qcap) queries: the join features, -1 on
    unused slots (no key matches them)."""
    return torch.stack([torch.where(qvalid, f, -1.0)
                        for f in join_features(qhh, qhl)])


def collect_anchors_join(ji: JoinIndex, hh, hl, meta, t_hh, t_hl, t_meta,
                         max_occ: int, occ_cap: int, qcap: int = 512,
                         acap: int = 2048):
    """Anchor collection of the batched map step with the flat-join
    tables (ops/anchors_jax.py collect_anchors_join, return_planes).

    Returns (axh, axl, ayh, ayl, n_a, overflow): (B, acap) anchor planes
    sorted by x, anchors kept in generation order up to acap before the
    sort; overflow = more than qcap emissions or acap anchors."""
    qhh, qhl, qmeta, n_q, qvalid = step_queries(hh, hl, meta, t_hh, t_hl,
                                                 t_meta, qcap)
    found, ext = _join_probe(ji, qhh, qhl, qvalid, occ_cap)
    cnt = ext[..., 0].to(torch.int64)
    keep = found & (cnt < max_occ)
    occ = torch.where(keep, torch.clamp(cnt, max=occ_cap), 0)
    occ_byte = torch.where(keep, torch.clamp(cnt, max=255), 0)
    qidx, rank, a_valid, n_a, n_tot = expand_bands(occ, acap)

    def take_q(a):
        return torch.gather(a, 1, qidx)

    # each anchor reads its hit slot from its emission's payload row
    slot = torch.where(a_valid, rank, 0)[..., None]
    rows = torch.gather(ext, 1, qidx[..., None].expand(-1, -1, ext.shape[2]))

    def hit(col0):
        return torch.gather(rows, 2, col0 + slot)[..., 0].to(torch.int64)

    axh, axl, ayh, ayl, _ = pack_anchors(
        hit(2), hit(2 + occ_cap), hit(2 + 2 * occ_cap), take_q(occ_byte),
        take_q(qmeta), a_valid, acap)
    return axh, axl, ayh, ayl, n_a, (n_q > qcap) | (n_tot > acap)


def collect_anchors_hash(hi: HashJoinIndex, hh, hl, meta, t_hh, t_hl,
                         t_meta, max_occ: int, occ_cap: int, qcap: int = 512,
                         acap: int = 2048):
    """Anchor collection of the batched map step with the cuckoo-hash
    tables (ops/anchors_hash.py collect_anchors_hash, return_planes);
    contract of collect_anchors_join."""
    qhh, qhl, qmeta, n_q, qvalid = step_queries(hh, hl, meta, t_hh, t_hl,
                                                 t_meta, qcap)
    found, cnt, start = _hash_probe(hi, qhh, qhl, qvalid)
    # cnt in the table caps at 255: max_occ above that can't be checked
    keep = found & (cnt < min(max_occ, 255))
    occ = torch.where(keep, torch.clamp(cnt, max=occ_cap), 0)
    axh, axl, ayh, ayl, _, n_a, n_tot = _hash_anchors(
        hi, qmeta, start, occ, torch.where(keep, cnt, 0), acap)
    return axh, axl, ayh, ayl, n_a, (n_q > qcap) | (n_tot > acap)


def collect_anchors_flat(ji: JoinIndex, hh, hl, meta, t_hh, t_hl, t_meta,
                         max_occ: int, occ_cap: int, qcap: int = 512,
                         acap: int = 2048):
    """Anchor collection with the flat probe (ops/anchors_jax.py
    collect_anchors_flat_pallas_traced): the probe runs over km_p/ke_p
    (ops/probe.py: CUDA kernel on the card), and the anchors are laid out
    hit slot by hit slot before the stable sort.  Contract of
    collect_anchors_join."""
    from .probe import probe_flat
    B = hh.shape[0]
    qhh, qhl, qmeta, n_q, qvalid = step_queries(hh, hl, meta, t_hh, t_hl,
                                                 t_meta, qcap)
    ext = probe_flat(flat_queries(qhh, qhl, qvalid), ji.km_p, ji.ke_p)
    cnt = ext[0].to(torch.int64)
    keep = (ext[1] > 0) & qvalid & (cnt < max_occ)
    occ = torch.where(keep, torch.clamp(cnt, max=occ_cap), 0)
    occ_byte = torch.where(keep, torch.clamp(cnt, max=255), 0)
    n_tot = occ.sum(1)
    n_a = torch.clamp(n_tot, max=acap).to(torch.int32)
    # slot-major layout: hit slot s of every emission, then s + 1
    s_ok = torch.arange(occ_cap, device=hh.device)[:, None, None] < occ

    def grid(a):
        return a.expand(occ_cap, B, qcap).permute(1, 0, 2) \
            .reshape(B, occ_cap * qcap)

    def pay(col0):
        return grid(ext[col0: col0 + occ_cap].to(torch.int64))

    axh, axl, ayh, ayl, _ = pack_anchors(
        pay(2), pay(2 + occ_cap), pay(2 + 2 * occ_cap), grid(occ_byte[None]),
        grid(qmeta[None]), grid(s_ok), acap)
    return axh, axl, ayh, ayl, n_a, (n_q > qcap) | (n_tot > acap)
