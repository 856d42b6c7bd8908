"""Base-level alignment of graph chains: per-anchor-gap WFA producing a
graph CIGAR (mg_gchain_cigar, galign.c:39-145) and the ds difference
string (mg_gchain_gen_ds, galign.c:182-293)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..options import MG_SEED_IGNORE
from ..mapping.gchain import Cigar, GChains
from .wfa import wfa_auto

_NT4 = np.full(256, 4, dtype=np.uint8)
_NT4[:4] = [0, 1, 2, 3]
for _c, _v in zip("ACGTU", [0, 1, 2, 3, 3]):
    _NT4[ord(_c)] = _v
    _NT4[ord(_c.lower())] = _v
_ACGTN = "acgtn"


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


@dataclass
class DsString:
    len: int = 0
    n_off: int = 0
    off: List[int] = field(default_factory=list)
    ds: str = ""


def _es_seq(es, v: int) -> bytes:
    return es[v >> 1].fwd if (v & 1) == 0 else es[v >> 1].rc


def _append1(cigar: List[int], op: int, ln: int) -> None:
    if cigar and (cigar[-1] & 0xF) == op:
        cigar[-1] += ln << 4
    else:
        cigar.append(ln << 4 | op)


def _append_many(cigar: List[int], other: List[int]) -> None:
    if not other:
        return
    _append1(cigar, other[0] & 0xF, other[0] >> 4)
    cigar.extend(other[1:])


_es_cache: dict = {}
_native_gc_cfg = False


def _es_tables(es):
    """Per-vertex sequence-pointer table + per-segment length array for
    the native engine, cached per index (es is built once in midx.py)."""
    import ctypes
    key = id(es)
    hit = _es_cache.get(key)
    if hit is not None and hit[0] is es and hit[1] == len(es):
        return hit[2], hit[3]
    n = len(es)
    seqp = (ctypes.c_char_p * (2 * n))()
    seg_len = np.empty(n, dtype=np.int64)
    for i, e in enumerate(es):
        seqp[2 * i] = e.fwd
        seqp[2 * i + 1] = e.rc
        seg_len[i] = e.len
    _es_cache.clear()  # one live index at a time
    _es_cache[key] = (es, n, seqp, seg_len)
    return seqp, seg_len


def _gchain_cigar_native(es, qbytes: bytes, gt: GChains, gc) -> bool:
    """One-call native anchor walk + per-gap WFA (native/mgt_cigar.c).
    Returns False to fall back to the Python path."""
    global _native_gc_cfg
    import ctypes

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_gchain_cigar"):
        return False
    if not _native_gc_cfg:
        lib.mgt_gchain_cigar.restype = ctypes.c_int64
        _native_gc_cfg = True
    seqp, seg_len = _es_tables(es)
    lct = getattr(gt, "_lc_tables", None)
    if lct is None:
        lct = (np.asarray([r.v for r in gt.lc], dtype=np.int64),
               np.asarray([r.off for r in gt.lc], dtype=np.int64),
               np.asarray([r.cnt for r in gt.lc], dtype=np.int64))
        gt._lc_tables = lct
    lc_v, lc_off, lc_cnt = lct
    off_a0 = gt.lc[gc.off].off
    cig_cap = (gc.pe - gc.ps) + (gc.qe - gc.qs) + 4 * gc.n_anchor + 64
    cig = np.empty(cig_cap, dtype=np.uint32)
    stats = np.zeros(4, dtype=np.int64)

    def P(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    ax = gt.ax if gt.ax.flags["C_CONTIGUOUS"] else np.ascontiguousarray(gt.ax)
    ay = gt.ay if gt.ay.flags["C_CONTIGUOUS"] else np.ascontiguousarray(gt.ay)
    n = lib.mgt_gchain_cigar(
        P(ax), P(ay), ctypes.c_int64(off_a0),
        ctypes.c_int64(gc.n_anchor),
        P(lc_v), P(lc_off), P(lc_cnt),
        ctypes.c_int64(gc.off), ctypes.c_int64(gc.cnt),
        seqp, P(seg_len), qbytes,
        P(cig), ctypes.c_int64(cig_cap), P(stats))
    if n < 0:
        return False
    p = Cigar()
    p.ss = _i32(int(gt.ax[off_a0])) + 1 - ((int(gt.ay[off_a0]) >> 32) & 0xFF)
    p.ee = _i32(int(gt.ax[off_a0 + gc.n_anchor - 1])) + 1
    p.n_cigar = int(n)
    p.cigar = cig[:n].tolist()
    p.mlen, p.blen, p.aplen = int(stats[0]), int(stats[1]), int(stats[2])
    gc.p = p
    gc.ds = None
    assert int(stats[3]) == gc.qe - gc.qs and p.aplen == gc.pe - gc.ps
    return True


def gchain_cigar(g, es, qseq: str, gt: GChains, qname: Optional[str]) -> None:
    """Walk anchors of each gchain, align the inter-anchor gaps with WFA
    and merge into one graph CIGAR (galign.c:39-145)."""
    from ..options import DBG, MG_DBG_MINIWFA, MG_DBG_MWF_SEQ
    use_native = not (DBG["flag"] & (MG_DBG_MINIWFA | MG_DBG_MWF_SEQ))
    qbytes = qseq.encode("latin-1")
    for gc in gt.gc:
        if use_native and _gchain_cigar_native(es, qbytes, gt, gc):
            continue
        l0 = gc.off
        off_a0 = gt.lc[l0].off
        cigar: List[int] = []
        _append1(cigar, 7, (int(gt.ay[off_a0]) >> 32) & 0xFF)
        j0 = 0
        for j in range(1, gc.n_anchor):
            py = int(gt.ay[off_a0 + j])
            px = int(gt.ax[off_a0 + j])
            if (py & MG_SEED_IGNORE) and j != gc.n_anchor - 1:
                continue
            qx = int(gt.ax[off_a0 + j0])
            qy = int(gt.ay[off_a0 + j0])
            # find the lchain containing this anchor
            l = l0
            while l < gc.off + gc.cnt:
                r = gt.lc[l]
                if r.off <= off_a0 + j < r.off + r.cnt:
                    break
                l += 1
            assert l < gc.off + gc.cnt
            assert _i32(qx) < g.seg[gt.lc[l0].v >> 1].len
            # extract the target sequence between anchors
            if l == l0:
                l_seq = _i32(px) - _i32(qx)
                seq = _es_seq(es, gt.lc[l0].v)[_i32(qx) + 1: _i32(qx) + 1 + l_seq]
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
                _append1(cigar, 1, qlen)
            elif qlen == 0:
                _append1(cigar, 2, l_seq)
            elif l_seq == qlen and qlen <= ((qy >> 32) & 0xFF):
                _append1(cigar, 7, qlen)
            else:
                rst = wfa_auto(seq, qgap, cigar=True)
                from ..options import DBG, MG_DBG_MINIWFA, MG_DBG_MWF_SEQ
                if DBG["flag"] & (MG_DBG_MINIWFA | MG_DBG_MWF_SEQ) \
                        and l_seq > 5000 and qlen > 5000 \
                        and rst.s >= 10000:
                    # long-WFA logging (galign.c:109-121)
                    import sys as _sys
                    if DBG["flag"] & MG_DBG_MINIWFA:
                        _sys.stderr.write(
                            f"WL\t{qname}\t{j}\t{_i32(qy) + 1}\t"
                            f"{_i32(py) - _i32(qy)}\t{l_seq}\t{rst.s}\n")
                    if DBG["flag"] & MG_DBG_MWF_SEQ:
                        _sys.stderr.write(
                            f"WL\t{qname}\t{j}\t{_i32(qy) + 1}\t{rst.s}\n"
                            f"WT\t{seq.decode('latin-1')}\n"
                            f"WQ\t{qgap.decode('latin-1')}\n")
                _append_many(cigar, rst.cigar or [])
            j0 = j
            l0 = l
        p = Cigar()
        p.ss = _i32(int(gt.ax[off_a0])) + 1 - ((int(gt.ay[off_a0]) >> 32) & 0xFF)
        p.ee = _i32(int(gt.ax[off_a0 + gc.n_anchor - 1])) + 1
        p.n_cigar = len(cigar)
        p.cigar = cigar
        l = 0
        for c in cigar:
            op, ln = c & 0xF, c >> 4
            if op == 7:
                p.mlen += ln
                p.blen += ln
            else:
                p.blen += ln
            if op != 1:
                p.aplen += ln
            if op != 2:
                l += ln
        gc.p = p
        gc.ds = None
        assert l == gc.qe - gc.qs and p.aplen == gc.pe - gc.ps


def _write_indel(parts: List[str], seq, ln: int, ll: int, lr: int) -> None:
    """write_indel (galign.c:153-180): microhomology bracket notation."""
    def nt(i):
        return _ACGTN[int(_NT4[seq[i]])]
    if ll + lr >= ln:
        parts.append("[")
        parts.extend(nt(i) for i in range(ln))
        parts.append("]")
    else:
        k = 0
        if ll > 0:
            parts.append("[")
            parts.extend(nt(k + i) for i in range(ll))
            parts.append("]")
            k += ll
        parts.extend(nt(k + i) for i in range(ln - lr - ll))
        k += ln - lr - ll
        if lr > 0:
            parts.append("[")
            parts.extend(nt(k + i) for i in range(lr))
            parts.append("]")


_native_ds_cfg = False


def _gen_ds_native(gc, tseq: bytes, qbytes: bytes):
    """Native ds generation (native/mgt_cigar.c).  Returns DsString or
    None when the library is unavailable."""
    global _native_ds_cfg
    import ctypes

    from ..utils.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "mgt_gen_ds"):
        return None
    if not _native_ds_cfg:
        lib.mgt_gen_ds.restype = ctypes.c_int64
        _native_ds_cfg = True
    cig = np.asarray(gc.p.cigar, dtype=np.uint32)
    span = gc.p.aplen + (gc.qe - gc.qs)
    ds_cap = 4 * span + 16 * len(cig) + 64
    off_cap = 2 * span + len(cig) + 8
    # np.empty, not create_string_buffer: the latter zero-fills, which
    # costs ~1s per whole-contig ds buffer in the ggs driver
    ds_buf = np.empty(ds_cap, dtype=np.uint8)
    off = np.empty(off_cap, dtype=np.int64)
    n_off = ctypes.c_int64(0)
    n = lib.mgt_gen_ds(
        cig.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(cig)),
        tseq, ctypes.c_int64(gc.p.aplen),
        qbytes, ctypes.c_int64(gc.qs), ctypes.c_int64(gc.qe),
        ds_buf.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(ds_cap),
        off.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(off_cap),
        ctypes.byref(n_off))
    if n < 0:
        return None
    ds = DsString()
    ds.ds = ds_buf[:n].tobytes().decode("latin-1")
    ds.len = n
    ds.n_off = int(n_off.value)
    ds.off = off[: ds.n_off]
    return ds


def gchain_gen_ds(g, es, qseq: str, gt: GChains) -> None:
    """Derive the ds:Z difference string from the CIGAR
    (mg_gchain_gen_ds, galign.c:182-293)."""
    qbytes = qseq.encode("latin-1")
    qnt = _NT4[np.frombuffer(qbytes, dtype=np.uint8)]
    for gc in gt.gc:
        # extract the aligned target sequence
        parts = []
        for j in range(gc.cnt):
            k = gc.off + j
            v = gt.lc[k].v
            slen = es[v >> 1].len
            st = 0 if j > 0 else gc.p.ss
            en = slen if j < gc.cnt - 1 else gc.p.ee
            parts.append(_es_seq(es, v)[st:en])
        tseq = b"".join(parts)
        assert len(tseq) == gc.p.aplen
        nds = _gen_ds_native(gc, tseq, qbytes)
        if nds is not None:
            gc.ds = nds
            continue
        tnt = _NT4[np.frombuffer(tseq, dtype=np.uint8)] if tseq else \
            np.empty(0, dtype=np.uint8)

        out: List[str] = []
        off: List[int] = []
        cur_len = 0

        def emit(s: str):
            nonlocal cur_len
            out.append(s)
            cur_len += len(s)

        x = 0
        y = gc.qs
        for c in gc.p.cigar:
            op, ln = c & 0xF, c >> 4
            if op in (0, 7, 8):
                l = 0
                tx = tnt[x: x + ln]
                qy = qnt[y: y + ln]
                mism = np.nonzero(tx != qy)[0]
                prev = 0
                for z in mism:
                    z = int(z)
                    l = z - prev
                    if l > 0:
                        off.append(cur_len)
                        emit(f":{l}")
                    off.append(cur_len)
                    emit(f"*{_ACGTN[int(tx[z])]}{_ACGTN[int(qy[z])]}")
                    prev = z + 1
                l = ln - prev
                if l > 0:
                    off.append(cur_len)
                    emit(f":{l}")
                x += ln
                y += ln
            elif op == 1:  # insertion
                z = 1
                while z <= ln:
                    if y - z < gc.qs or qbytes[y + ln - z] != qbytes[y - z]:
                        break
                    z += 1
                lr = z - 1
                z = 0
                while z < ln:
                    if y + ln + z >= gc.qe or qbytes[y + ln + z] != qbytes[y + z]:
                        break
                    z += 1
                ll = z
                off.append(cur_len)
                emit("+")
                ind: List[str] = []
                _write_indel(ind, qbytes[y: y + ln], ln, ll, lr)
                emit("".join(ind))
                y += ln
            elif op == 2:  # deletion
                z = 1
                while z <= ln:
                    if x - z < 0 or tseq[x + ln - z] != tseq[x - z]:
                        break
                    z += 1
                lr = z - 1
                z = 0
                while z < ln:
                    if x + ln + z >= gc.p.aplen or tseq[x + z] != tseq[x + ln + z]:
                        break
                    z += 1
                ll = z
                off.append(cur_len)
                emit("-")
                ind = []
                _write_indel(ind, tseq[x: x + ln], ln, ll, lr)
                emit("".join(ind))
                x += ln
        ds = DsString()
        ds.ds = "".join(out)
        ds.len = len(ds.ds)
        ds.off = off
        ds.n_off = len(off)
        gc.ds = ds
