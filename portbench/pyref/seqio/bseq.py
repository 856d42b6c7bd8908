"""FASTA/FASTQ (optionally gzipped) sequence reader with reference
batching semantics (bseq.c:61-128)."""
from __future__ import annotations

import gzip
import re
import sys
from dataclasses import dataclass
from typing import IO, Iterator, List, Optional

CHECK_PAIR_THRES = 1_000_000
_U2T = bytes.maketrans(b"uU", b"tT")


@dataclass
class BSeq:
    name: str
    seq: str
    qual: Optional[str] = None
    comment: Optional[str] = None
    rid: int = -1

    @property
    def l_seq(self) -> int:
        return len(self.seq)


def _qname_len(s: str) -> int:
    l = len(s)
    if l >= 3 and s[-1].isdigit() and s[-2] == "/":
        return l - 2
    return l


def qname_same(a: str, b: str) -> bool:
    """Names identical after stripping a trailing /[0-9] (bseq.h:35-41)."""
    la, lb = _qname_len(a), _qname_len(b)
    return la == lb and a[:la] == b[:la]


def _open_text(fn: str) -> IO[str]:
    if fn == "-":
        return sys.stdin
    with open(fn, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(fn, "rt")
    return open(fn, "rt")


def _records(fp: IO[str]) -> Iterator[BSeq]:
    """kseq-equivalent FASTA/FASTQ record iterator."""
    name = comment = None
    seq_parts: List[str] = []
    qual_parts: List[str] = []
    in_qual = False
    seq_len = 0

    def finish():
        nonlocal seq_parts, qual_parts, in_qual, seq_len
        s = "".join(seq_parts).encode("latin-1").translate(_U2T).decode("latin-1")
        q = "".join(qual_parts) if qual_parts else None
        rec = BSeq(name=name or "", seq=s, qual=q, comment=comment)
        seq_parts, qual_parts, in_qual, seq_len = [], [], False, 0
        return rec

    for raw in fp:
        line = raw.rstrip("\n").rstrip("\r")
        if not in_qual and line[:1] in (">", "@") and name is None:
            hdr = line[1:]
            m = re.match(r"(\S*)\s*(.*)", hdr, re.DOTALL)
            name, comment = m.group(1), (m.group(2) or None)
        elif not in_qual and line[:1] in (">", "@") and not qual_parts and seq_parts:
            rec = finish()
            yield rec
            hdr = line[1:]
            m = re.match(r"(\S*)\s*(.*)", hdr, re.DOTALL)
            name, comment = m.group(1), (m.group(2) or None)
        elif line[:1] == "+" and not in_qual and seq_parts:
            in_qual = True
            seq_len = sum(len(p) for p in seq_parts)
        elif in_qual:
            qual_parts.append(line)
            if sum(len(p) for p in qual_parts) >= seq_len:
                rec = finish()
                yield rec
                name = comment = None
        else:
            if name is not None:
                seq_parts.append(line)
    if name is not None and (seq_parts or not qual_parts):
        yield finish()


class BSeqFile:
    def __init__(self, fn: str):
        self._fp = _open_text(fn)
        self._it = _records(self._fp)
        self._pending: Optional[BSeq] = None
        self._eof = False

    def close(self):
        if self._fp is not sys.stdin:
            self._fp.close()

    def _next(self) -> Optional[BSeq]:
        try:
            return next(self._it)
        except StopIteration:
            self._eof = True
            return None

    def read_batch(self, chunk_size: int, frag_mode: bool = False) -> List[BSeq]:
        """mg_bseq_read (bseq.c:61-98): read until chunk_size bases, keeping
        same-name fragments together in frag mode."""
        out: List[BSeq] = []
        size = 0
        if self._pending is not None:
            out.append(self._pending)
            size = self._pending.l_seq
            self._pending = None
        while True:
            s = self._next()
            if s is None:
                break
            out.append(s)
            size += s.l_seq
            if size >= chunk_size:
                if frag_mode and out[-1].l_seq < CHECK_PAIR_THRES:
                    while True:
                        t = self._next()
                        if t is None:
                            break
                        if qname_same(t.name, out[-1].name):
                            out.append(t)
                        else:
                            self._pending = t
                            break
                break
        return out


def read_all(fn: str) -> List[BSeq]:
    f = BSeqFile(fn)
    try:
        out = []
        while True:
            batch = f.read_batch(1 << 62)
            if not batch:
                return out
            out.extend(batch)
    finally:
        f.close()


def toupper(s: str) -> str:
    return s.upper()


class NativeSeqReader:
    """Arena batch reader over native/mgt_seqio.c: records land in C
    buffers (uppercased, U->T) consumed directly by the native batch
    mapping driver; per-read Python objects exist only for fallback
    reads.  Batch boundary rule matches BSeqFile.read_batch."""

    def __init__(self, fn: str):
        import ctypes as ct

        import numpy as np

        from ..utils.native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "mgt_seq_open"):
            raise OSError("native reader unavailable")
        if not getattr(NativeSeqReader, "_cfg", False):
            lib.mgt_seq_open.restype = ct.c_void_p
            lib.mgt_seq_open.argtypes = [ct.c_char_p]
            lib.mgt_seq_read_batch2.restype = ct.c_int64
            lib.mgt_seq_read_batch2.argtypes = [ct.c_void_p, ct.c_int64,
                                                ct.c_int64, ct.c_void_p]
            lib.mgt_seq_close.restype = None
            lib.mgt_seq_close.argtypes = [ct.c_void_p]
            NativeSeqReader._cfg = True
        self._ct, self._np = ct, np
        self._lib = lib
        self._h = lib.mgt_seq_open(fn.encode())
        if not self._h:
            raise OSError(f"cannot open {fn}")

    def read_batch_arena(self, max_bp: int, frag_mode: bool = False):
        """Returns (n, sq_addr, sq_off, nm_addr, nm_off) or None at
        EOF.  The arenas and offset views are valid only until the
        next call.  frag_mode keeps same-name fragment runs within
        one batch (BSeqFile.read_batch semantics)."""
        ct, np = self._ct, self._np
        ptrs = np.zeros(4, dtype=np.uint64)
        n = self._lib.mgt_seq_read_batch2(self._h, max_bp,
                                          int(frag_mode),
                                          ct.c_void_p(ptrs.ctypes.data))
        if n == -2:
            raise IOError("sequence input truncated or corrupt "
                          "(gzip stream error)")
        if n < 0:
            raise MemoryError("native reader allocation failure")
        if n == 0:
            return None
        sq_off = np.ctypeslib.as_array(
            (ct.c_int64 * (n + 1)).from_address(int(ptrs[1])))
        nm_off = np.ctypeslib.as_array(
            (ct.c_int64 * (n + 1)).from_address(int(ptrs[3])))
        return int(n), int(ptrs[0]), sq_off, int(ptrs[2]), nm_off

    def close(self):
        if self._h:
            self._lib.mgt_seq_close(self._h)
            self._h = None
