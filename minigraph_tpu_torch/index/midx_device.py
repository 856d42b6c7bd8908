"""Minimizer sketches of long sequences on the device: the graph's
segments (`build_index_device`) and contig-scale queries
(mapping/seeds.py `collect_minimizers_device`, --seed-device).

Port of the JAX package's index/midx_device.py.  Sequences are cut into
chunk jobs, packed into fixed-shape batches and swept by the
position-aligned sketch (ops/sketch.py `sketch_planes`: the `sketch`
kernel, csrc/sketch.cu, for tensors on the card, its plain version on
the CPU).  The planes come back to the host once a batch and are decoded
into the host sketch's (x, y) records; table assembly (one lexsort)
stays on the host.

Chunk-halo correctness: an emission with payload end position p is
triggered at some t in [p, p + w], and the sketch state at trigger t
depends only on bases [t - (w + k - 1), t].  Chunking by payload ranges
[a, b) with context [a - (w + k + 1), b + w) therefore reproduces every
emission exactly once; the end-of-sequence state emission is taken from
the final chunk only.  A sequence whose planes raise `overflow` (two
ties at one trigger) is sketched whole on the host.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..ops.sketch import META_Q_BITS, encode_batch
from ..ops.sketch import sketch_planes as _sketch_planes
from .sketch import sketch as host_sketch

# (chunk payload length, batch) buckets of the sweep
DEV_BUCKETS: Tuple[Tuple[int, int], ...] = ((4096, 128), (32768, 16))


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to sketch with the plain version")
    return dev


def chunk_jobs(seqs: List[str], w: int, k: int, max_pay: int):
    """The chunk jobs of `seqs`: (seq index, payload start, context text,
    payload offset in the context, payload length, is_last)."""
    halo = w + k + 1
    jobs = []
    for si, s in enumerate(seqs):
        n = len(s)
        a = 0
        while a < n:
            b = min(a + max_pay, n)
            c0 = max(0, a - halo)
            c1 = min(n, b + w)
            jobs.append((si, a, s[c0:c1], a - c0, b - a, b == n))
            a = b
    return jobs


def sketch_segments_device(seqs: List[str], w: int, k: int,
                           buckets=DEV_BUCKETS, device="cuda", mesh=None):
    """Sketch many sequences on `device`; returns per-sequence (x, y)
    uint64 record arrays equal to the host sketch's with rid 0 (callers
    rebase).  Each batch is padded with empty rows to its bucket's batch
    size and width pad_len + halo + w + 1.

    With `mesh` (parallel/shard.py make_mesh; every rank of the process
    group calls this with the same sequences), the chunk batches are
    split data-parallel over its "data" axis, the layout for sketching
    one chromosome-scale sequence on several devices: each data rank
    sketches its contiguous block of every batch's rows, the planes are
    all-gathered over "data", and every rank decodes the same records as
    without a mesh.  The batch sizes must divide over the data ranks."""
    dev = _device(device)
    sketch = sketch_planes if mesh is None else _mesh_sketch(mesh)
    halo = w + k + 1
    jobs = chunk_jobs(seqs, w, k, buckets[-1][0])
    out_x: List[List[np.ndarray]] = [[] for _ in seqs]
    out_y: List[List[np.ndarray]] = [[] for _ in seqs]
    fallback = set()

    by_bucket = {}
    for j, job in enumerate(jobs):
        L = len(job[2]) + w + 1
        for pad_len, _ in buckets:
            if L <= pad_len + halo + w + 1:
                by_bucket.setdefault(pad_len, []).append(j)
                break
        else:
            by_bucket.setdefault(buckets[-1][0], []).append(j)

    for pad_len, idxs in by_bucket.items():
        bsz = dict(buckets)[pad_len]
        width = pad_len + halo + w + 1
        for c0 in range(0, len(idxs), bsz):
            chunk_ids = idxs[c0: c0 + bsz]
            texts = [jobs[j][2] for j in chunk_ids]
            texts += [""] * (bsz - len(texts))
            codes, lens = encode_batch(texts, pad_to=width)
            planes, ovf = sketch(torch.from_numpy(codes).to(dev),
                                 torch.from_numpy(lens).to(dev), w, k)
            # one copy to the host a batch; the planes hold u32 values
            hh, hl, meta, thh, thl, tmeta = \
                planes.cpu().numpy().astype(np.uint32)
            ovf = ovf.cpu().numpy()
            for bi, j in enumerate(chunk_ids):
                si, pay_a, text, ctx_off, pay_len, is_last = jobs[j]
                if ovf[bi]:
                    fallback.add(si)
                    continue
                xs, ys = _decode_chunk(
                    hh[bi], hl[bi], meta[bi], thh[bi], thl[bi], tmeta[bi],
                    ctx_off, pay_a, pay_len, len(text), is_last,
                    META_Q_BITS)
                out_x[si].append(xs)
                out_y[si].append(ys)

    res = []
    for si, s in enumerate(seqs):
        if si in fallback:
            res.append(host_sketch(s, w, k, rid=0))
        elif out_x[si]:
            res.append((np.concatenate(out_x[si]),
                        np.concatenate(out_y[si])))
        else:
            res.append((np.empty(0, np.uint64), np.empty(0, np.uint64)))
    return res


def sketch_planes(codes, lens, w, k):
    """The six planes of one batch stacked (6, B, L + 1), and overflow."""
    sp = _sketch_planes(codes, lens, w, k)
    return torch.stack(sp[:6]), sp.overflow


def _mesh_sketch(mesh):
    """sketch_planes on this data rank's rows of the batch, the planes
    then all-gathered over "data" in row order."""
    from ..parallel.shard import all_gather
    n_data, d = mesh.size(0), mesh.get_local_rank("data")
    group = mesh.get_group("data")

    def run(codes, lens, w, k):
        B = codes.shape[0]
        if B % n_data:
            raise ValueError(f"sweep batch of {B} rows does not split over "
                             f"{n_data} data ranks")
        b = B // n_data
        planes, ovf = sketch_planes(codes[d * b:(d + 1) * b],
                                    lens[d * b:(d + 1) * b], w, k)
        return (torch.cat(all_gather(planes, group), 1),
                torch.cat(all_gather(ovf, group), 0))

    return run


def _decode_chunk(hh, hl, meta, thh, thl, tmeta, ctx_off, pay_a, pay_len,
                  text_len, is_last, qbits):
    """Planes (uint32 rows) -> (x, y) records in emission order, keeping
    payloads in this chunk's range and rebasing positions to the whole
    sequence."""
    U64 = np.uint64
    qmask = np.uint32((1 << qbits) - 1)
    S = meta.shape[0]
    # interleave main/tie per trigger = emission order
    H = np.empty(2 * S, hh.dtype)
    L = np.empty(2 * S, hl.dtype)
    M = np.empty(2 * S, meta.dtype)
    H[0::2], H[1::2] = hh, thh
    L[0::2], L[1::2] = hl, thl
    M[0::2], M[1::2] = meta, tmeta
    emit = M != np.uint32(0xFFFFFFFF)
    # the final-state emission sits at plane slot text_len (main); drop
    # it for non-final chunks
    if not is_last:
        fin_slot = 2 * text_len
        if fin_slot < 2 * S:
            emit[fin_slot] = False
    H, L, M = H[emit], L[emit], M[emit]
    pos = ((M >> np.uint32(1)) & qmask).astype(np.int64)
    keep = (pos >= ctx_off) & (pos < ctx_off + pay_len)
    H, L, M, pos = H[keep], L[keep], M[keep], pos[keep]
    span = ((M >> np.uint32(qbits + 1)) & np.uint32(0x1F)).astype(np.int64)
    z = (M & np.uint32(1)).astype(np.int64)
    gpos = pos - ctx_off + pay_a
    x = ((H.astype(U64) << U64(32)) | L.astype(U64)) << U64(8)
    x |= span.astype(U64)
    y = (gpos.astype(U64) << U64(1)) | z.astype(U64)
    return x, y


def build_index_device(g, k: int, w: int, mo=None, device="cuda"):
    """mg_index with the sketch stage on `device`; the tables equal
    index/midx.py `build_index`'s.  Uppercases the segments in place."""
    from ..graph.gfa import revcomp
    from ..utils.syslog import mlog
    from .midx import EdSeq, MinimizerIndex, gfa_overlap

    if gfa_overlap(g):
        raise ValueError("graphs with overlapping segments are not supported")
    for s in g.seg:
        if s.seq is not None:
            s.seq = s.seq.upper()
    seqs = [(i, s.seq) for i, s in enumerate(g.seg)
            if s.seq is not None and s.len > 0]
    sk = sketch_segments_device([t for _, t in seqs], w, k, device=device)
    xs_all, ys_all = [], []
    for (rid, _), (x, y) in zip(seqs, sk):
        xs_all.append(x)
        ys_all.append(y | (np.uint64(rid) << np.uint64(32)))
    gi = MinimizerIndex(g, k, w)
    if xs_all:
        x = np.concatenate(xs_all)
        y = np.concatenate(ys_all)
        minier = x >> np.uint64(8)
        order = np.lexsort((y, minier))
        minier = minier[order]
        gi.pos = y[order]
        keys, start, cnt = np.unique(minier, return_index=True,
                                     return_counts=True)
        gi.keys = keys
        gi.key_start = start.astype(np.int64)
        gi.key_cnt = cnt.astype(np.int64)
    gi.es = []
    for s in g.seg:
        gi.es.append(EdSeq(fwd=(s.seq or "").encode("latin-1"),
                           rc=revcomp(s.seq or "").encode("latin-1"),
                           len=s.len))
    mlog("mg_index", "indexed the graph (device sketch)")
    if mo is not None:
        from ..options import opt_update
        opt_update(gi, mo)
    return gi
