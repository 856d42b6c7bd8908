"""GFA/rGFA/FASTA reader and byte-parity GFA writer.

Follows the reference line grammars (gfa-io.c:113-264) including the
FASTA auto-detection inside the reader (gfa-io.c:311-322): a '>' header
switches to FASTA mode and each record becomes one segment named s<N>
with the FASTA name as its stable name, rank 0.
"""
from __future__ import annotations

import gzip
import re
import sys
from typing import IO, List, Optional

import numpy as np

from .gfa import INT32_MAX, AuxTag, Graph, Segment

_INT_RE = re.compile(r"^[ \t]*[+-]?[0-9]*")
_FLOAT_RE = re.compile(r"^[ \t]*[+-]?(?:[0-9]+(?:\.[0-9]*)?|\.[0-9]+)(?:[eE][+-]?[0-9]+)?")


def _strtol(s: str) -> int:
    m = _INT_RE.match(s)
    t = m.group(0).strip() if m else ""
    if t in ("", "+", "-"):
        return 0
    return int(t)


def _strtod(s: str) -> float:
    m = _FLOAT_RE.match(s)
    t = m.group(0).strip() if m else ""
    try:
        return float(t)
    except ValueError:
        return 0.0


def _i32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def parse_aux(fields: List[str]) -> List[AuxTag]:
    """Parse optional tag fields (gfa_aux_parse, gfa-io.c:16-71).

    Fields not matching XX:T:... with T in AifZB are silently dropped.
    """
    out: List[AuxTag] = []
    for q in fields:
        if len(q) >= 5 and q[2] == ":" and q[4] == ":" and q[3] in "AifZB":
            tag, typ, val = q[:2], q[3], q[5:]
            if typ == "A":
                out.append(AuxTag(tag, "A", val[:1] if val else "\0"))
            elif typ == "i":
                out.append(AuxTag(tag, "i", _i32(_strtol(val))))
            elif typ == "f":
                out.append(AuxTag(tag, "f", float(np.float32(_strtod(val)))))
            elif typ == "Z":
                out.append(AuxTag(tag, "Z", val))
            elif typ == "B":
                if len(val) >= 1:
                    sub = val[0]
                    items = []
                    rest = val[1:]
                    for tok in rest.split(","):
                        if tok == "" and rest == "":
                            continue
                        if tok == "":
                            items.append(0)
                        elif sub == "f":
                            items.append(float(np.float32(_strtod(tok))))
                        else:
                            try:
                                items.append(int(tok, 0))
                            except ValueError:
                                items.append(_strtol(tok))
                    out.append(AuxTag(tag, "B", (sub, items)))
    return out


def aux_get(aux: List[AuxTag], tag: str, typ: Optional[str] = None) -> Optional[AuxTag]:
    for t in aux:
        if t.tag == tag and (typ is None or t.type == typ):
            return t
    return None


def aux_del(aux: List[AuxTag], t: AuxTag) -> None:
    aux.remove(t)


def _parse_S(g: Graph, line: str) -> int:
    body = line[2:]
    fields = body.split("\t")
    if len(fields) < 2:
        return -1
    seg_name = fields[0]
    seq = None if fields[1] == "*" else fields[1]
    aux = parse_aux(fields[2:])
    LN = -1
    t = aux_get(aux, "LN")
    if t is not None and t.type == "i":
        LN = t.value
        aux_del(aux, t)
    if seq is None:
        length = LN if LN >= 0 else 0
    else:
        length = len(seq)
    if LN >= 0 and length != LN:
        sys.stderr.write(
            f"[W] for segment '{seg_name}', LN:i:{LN} tag is different from "
            f"sequence length {length}\n")
    sid = g.add_seg(seg_name)
    s = g.seg[sid]
    s.len, s.seq = length, seq
    if aux:
        t = aux_get(aux, "SN")
        if t is not None and t.type == "Z":
            s.snid = g.sseq_add(t.value)
            s.soff = 0
            aux_del(aux, t)
            t2 = aux_get(aux, "SO")
            if t2 is not None and t2.type == "i":
                s.soff = t2.value
                aux_del(aux, t2)
        t = aux_get(aux, "SR")
        if t is not None and t.type == "i":
            s.rank = t.value
            if s.rank > g.max_rank:
                g.max_rank = s.rank
            aux_del(aux, t)
        g.sseq_update(s)
    s.aux = aux
    return 0


_CIG_RE = re.compile(r"([0-9]+)([A-Z])")


def _parse_L(g: Graph, line: str) -> int:
    fields = line[2:].split("\t")
    if len(fields) < 4:
        return -1
    segv, sv, segw, sw = fields[0], fields[1], fields[2], fields[3]
    if sv not in "+-" or sw not in "+-":
        return -2
    oriv = int(sv != "+")
    oriw = int(sw != "+")
    ov = ow = INT32_MAX
    if len(fields) == 4:
        ov = ow = 0
    else:
        q = fields[4]
        if q.startswith("*"):
            ov = ow = 0
        elif q.startswith(":"):
            ov = INT32_MAX
            ow = _strtol(q[1:]) if len(q) > 1 and q[1].isdigit() else INT32_MAX
        elif q and q[0].isdigit():
            m = _INT_RE.match(q)
            num_end = m.end()
            ov = int(q[:num_end])
            rest = q[num_end:]
            if rest and rest[0].isupper():  # CIGAR
                ov = ow = 0
                for mlen, op in _CIG_RE.findall(q):
                    L = int(mlen)
                    if op in "MDN":
                        ov += L
                    if op in "MIS":
                        ow += L
            elif rest.startswith(":"):
                ow = _strtol(rest[1:]) if len(rest) > 1 and rest[1].isdigit() else INT32_MAX
            else:
                return -1
        else:
            return -1
    v = g.add_seg(segv) << 1 | oriv
    w = g.add_seg(segw) << 1 | oriw
    arc = g.add_arc1(v, w, ov, ow, -1, False)
    aux = parse_aux(fields[5:])
    if aux:
        t = aux_get(aux, "SR")
        if t is not None and t.type == "i":
            arc.rank = t.value
            aux_del(aux, t)
        t = aux_get(aux, "L1")
        if t is not None:
            if ov != INT32_MAX and t.type == "i":
                g.seg[v >> 1].len = max(g.seg[v >> 1].len, ov + t.value)
            aux_del(aux, t)
        t = aux_get(aux, "L2")
        if t is not None:
            if ow != INT32_MAX and t.type == "i":
                g.seg[w >> 1].len = max(g.seg[w >> 1].len, ow + t.value)
            aux_del(aux, t)
        if aux:
            g.link_aux[arc.link_id] = aux
    return 0


def _open_text(fn: str) -> IO[str]:
    if fn == "-":
        return sys.stdin
    with open(fn, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(fn, "rt")
    return open(fn, "rt")


def read_gfa(fn: str) -> Graph:
    """Load a GFA/rGFA (or plain FASTA) file into a finalized Graph
    (gfa_read, gfa-io.c:294-337)."""
    g = Graph()
    is_fa = False
    fa_seg: Optional[Segment] = None
    fa_chunks: List[str] = []

    def finish_fa():
        nonlocal fa_seg, fa_chunks
        if fa_seg is not None:
            seq = "".join(fa_chunks)
            fa_seg.seq = seq
            fa_seg.len = len(seq)
            g.sseq_update(fa_seg)
        fa_seg = None
        fa_chunks = []

    fp = _open_text(fn)
    try:
        for raw in fp:
            line = raw.rstrip("\n").rstrip("\r")
            if len(line) > 0 and line[0] == ">":
                is_fa = True
                finish_fa()
                # FASTA header: segment s<N>, stable name = header word
                hdr = line[1:]
                for i, ch in enumerate(hdr):
                    if ch.isspace():
                        hdr = hdr[:i]
                        break
                sid = g.add_seg(f"s{g.n_seg + 1}")
                fa_seg = g.seg[sid]
                fa_seg.snid = g.sseq_add(hdr)
                fa_seg.soff = fa_seg.rank = 0
                fa_chunks = []
                continue
            if is_fa:
                if len(line) >= 3 and line[1] == "\t":  # likely a GFA line
                    finish_fa()
                    is_fa = False
                else:
                    fa_chunks.append(line)
                    continue
            if len(line) < 3 or line[1] != "\t":
                continue
            if line[0] == "S":
                ret = _parse_S(g, line)
            elif line[0] == "L":
                ret = _parse_L(g, line)
            else:
                ret = 0
            if ret < 0:
                sys.stderr.write(f"[E] invalid {line[0]}-line (error code {ret})\n")
    finally:
        if fp is not sys.stdin:
            fp.close()
    if is_fa:
        finish_fa()
    g.finalize()
    return g
