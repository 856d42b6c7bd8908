"""Graph-generation drivers (ggen.c): incremental augmentation,
coverage, and bubble calling over whole-assembly mappings.  Contigs map
on the per-read host path (`map_one`), as in the JAX package."""
from __future__ import annotations

import copy
import sys
from typing import List, Optional

import numpy as np

from ..graph.gfa import Graph
from ..index.midx import IndexCache, build_index
from ..mapping.mapper import _map_fragments_parallel, fork_refused, map_one
from ..options import (MG_G_CAL_COV, MG_G_CALL, MG_M_CIGAR, GGOptions,
                       IndexOptions, MapOptions)
from ..seqio.bseq import read_all, toupper
from ..utils.syslog import mlog
from .call import call_asm
from .cov import aux_update_cv, cov_asm
from .ggsimple import ggsimple


def _ggen_map(gi, opt: MapOptions, fn: str, n_threads: int = 1):
    """Map every sequence of one file (ggen_map, ggen.c:39-71): over a
    fork pool of n_threads workers (results in input order) where this
    process may fork (mapping/mapper.py fork_refused), else here."""
    seqs = read_all(fn)
    mlog("ggen_map", f'loaded file "{fn}"')
    for i, s in enumerate(seqs):
        s.rid = i
        s.seq = toupper(s.seq)
    refused = fork_refused() if n_threads > 1 and len(seqs) > 1 else ""
    if refused is None:
        items = [(i, s.name, [s.seq]) for i, s in enumerate(seqs)]
        gcs = _map_fragments_parallel(gi, opt, items, n_threads,
                                      fast_emit=False)
    else:
        if refused:
            mlog("ggen_map", f"no fork pool for -t {n_threads}: {refused}; "
                 f"mapping in this process")
        gcs = [map_one(gi, s.seq, opt, s.name) for s in seqs]
    mlog("ggen_map", f"mapped {len(seqs)} sequence(s) to the graph")
    return seqs, gcs


def ggen_aug(g: Graph, fns: List[str], ipt: IndexOptions, opt0: MapOptions,
             go: GGOptions, n_threads: int = 1) -> int:
    """Incremental construction: for each sample, re-index the current
    graph, map all contigs, then augment (mg_ggen_aug, ggen.c:84-102).

    The per-sample re-index is a DELTA build: augmentation only splits
    segments and adds new ones, so unchanged segments reuse their
    cached sketch records and edseqs (IndexCache) — the dominant
    re-index cost drops from O(graph) to O(changed) per sample."""
    cache = IndexCache()
    for fn in fns:
        opt = copy.copy(opt0)
        cache.hits = cache.misses = 0
        gi = build_index(g, ipt.k, ipt.w, opt, cache=cache)
        if gi is None:
            return -1
        if cache.hits:
            mlog("ggen_aug", f"delta re-index: {cache.hits} segments "
                 f"cached, {cache.misses} re-sketched")
        seqs, gcs = _ggen_map(gi, opt, fn, n_threads)
        ggsimple(g, go, len(seqs), seqs, gcs,
                 use_cigar=bool(opt0.flag & MG_M_CIGAR))
    return 0


def ggen_cov(g: Graph, fns: List[str], ipt: IndexOptions, opt0: MapOptions,
             go: GGOptions, n_threads: int = 1) -> int:
    """Assembly coverage annotation (mg_ggen_cov, ggen.c:104-126)."""
    opt = copy.copy(opt0)
    gi = build_index(g, ipt.k, ipt.w, opt)
    if gi is None:
        return -1
    cov_seg = np.zeros(g.n_seg, dtype=np.float64)
    cov_link = np.zeros(g.n_arc, dtype=np.float64)
    for fn in fns:
        seqs, gcs = _ggen_map(gi, opt, fn, n_threads)
        cov_asm(g, len(seqs), gcs, go.min_mapq, go.min_map_len,
                cov_seg, cov_link)
    cov_seg /= len(fns)
    cov_link /= len(fns)
    aux_update_cv(g, "cf", cov_seg, cov_link)
    return 0


def ggen_call(g: Graph, fn: str, ipt: IndexOptions, opt0: MapOptions,
              go: GGOptions, out=sys.stdout, n_threads: int = 1) -> int:
    """Bubble path calling (mg_ggen_call, ggen.c:128-139)."""
    opt = copy.copy(opt0)
    gi = build_index(g, ipt.k, ipt.w, opt)
    if gi is None:
        return -1
    seqs, gcs = _ggen_map(gi, opt, fn, n_threads)
    call_asm(g, len(seqs), seqs, gcs, go.min_mapq, go.min_map_len, out)
    return 0


def ggen(g: Graph, fns: List[str], ipt: IndexOptions, opt: MapOptions,
         go: GGOptions, out=sys.stdout, n_threads: int = 1) -> int:
    if go.flag & MG_G_CALL:
        return ggen_call(g, fns[0], ipt, opt, go, out, n_threads)
    if go.flag & MG_G_CAL_COV:
        return ggen_cov(g, fns, ipt, opt, go, n_threads)
    return ggen_aug(g, fns, ipt, opt, go, n_threads)
