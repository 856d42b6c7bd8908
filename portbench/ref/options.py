"""Option structs, presets and validation (options.c, minigraph.h:46-91)."""
from __future__ import annotations

from dataclasses import dataclass

# mapping flags (minigraph.h:9-31)
MG_M_SPLICE = 0x10
MG_M_SR = 0x20
MG_M_FRAG_MODE = 0x40
MG_M_FRAG_MERGE = 0x80
MG_M_FOR_ONLY = 0x100
MG_M_REV_ONLY = 0x200
MG_M_HEAP_SORT = 0x400
MG_M_VERTEX_COOR = 0x800
MG_M_ALL_CHAINS = 0x1000
MG_M_PRINT_2ND = 0x2000
MG_M_CAL_COV = 0x4000
MG_M_RMQ = 0x8000
MG_M_COPY_COMMENT = 0x10000
MG_M_INDEPEND_SEG = 0x20000
MG_M_NO_QUAL = 0x40000
MG_M_2_IO_THREADS = 0x80000
MG_M_SHOW_UNMAP = 0x100000
MG_M_NO_COMP_PATH = 0x200000
MG_M_NO_DIAG = 0x400000
MG_M_WRITE_LCHAIN = 0x800000
MG_M_WRITE_MZ = 0x1000000
MG_M_SKIP_GCHECK = 0x2000000
MG_M_CIGAR = 0x4000000

# seed flags (mgpriv.h:18-27)
MG_SEED_IGNORE = 1 << 41
MG_SEED_TANDEM = 1 << 42
MG_SEED_FIXED = 1 << 43
MG_MAX_SEG = 255
MG_SEED_SEG_SHIFT = 48
MG_SEED_SEG_MASK = 0xFF << MG_SEED_SEG_SHIFT
MG_SEED_OCC_SHIFT = 56
MG_MAX_SHORT_K = 15


@dataclass
class IndexOptions:
    k: int = 17
    w: int = 11


@dataclass
class MapOptions:
    flag: int = 0
    mini_batch_size: int = 500_000_000
    seed: int = 11
    max_qlen: int = 0
    pe_ori: int = 0
    occ_max1: int = 50
    occ_max1_cap: int = 250
    occ_max1_frac: float = 2e-4
    bw: int = 500
    bw_long: int = 20000
    rmq_size_cap: int = 100000
    rmq_rescue_size: int = 1000
    rmq_rescue_ratio: float = 0.1
    max_gap_pre: int = 1000
    max_gap: int = 5000
    max_gap_ref: int = -1
    max_frag_len: int = 0
    div: float = 0.1
    chn_pen_gap: float = 1.0
    chn_pen_skip: float = 0.05
    max_lc_skip: int = 25
    max_lc_iter: int = 5000
    max_gc_skip: int = 25
    min_lc_cnt: int = 5
    min_lc_score: int = 40
    min_gc_cnt: int = 5
    min_gc_score: int = 50
    gdp_max_ed: int = 10000
    lc_max_trim: int = 50
    lc_max_occ: int = 2
    mask_level: float = 0.5
    sub_diff: int = 6
    best_n: int = 5
    pri_ratio: float = 0.8
    ref_bonus: int = 0
    # the allocator cap (--cap-calloc, read by no stage) and the coverage
    # thresholds of --cov
    cap_kalloc: int = 1_000_000_000
    min_cov_mapq: int = 20
    min_cov_blen: int = 1000


def opt_set(preset: str | None, io: IndexOptions, mo: MapOptions) -> int:
    """Apply a preset on top of existing options (options.c:65-108)."""
    if preset is None or preset == "lr":
        return 0
    if preset in ("asm", "ggs"):
        io.k, io.w = 19, 10
        mo.flag |= MG_M_RMQ
        mo.occ_max1, mo.occ_max1_cap = 10, 100
        mo.bw, mo.bw_long = 1000, 150000
        mo.max_gap, mo.max_gap_pre = 10000, 1000
        mo.min_lc_cnt, mo.min_lc_score = 5, 40
        mo.min_gc_cnt, mo.min_gc_score = 5, 1000
        mo.min_cov_mapq = 5
        mo.min_cov_blen = 100000
        mo.max_lc_skip = mo.max_gc_skip = 50
        mo.div = 0.01
        mo.mini_batch_size = 4_000_000_000
        if preset == "ggs":
            mo.best_n = 0
    elif preset in ("se", "sr"):
        io.k, io.w = 21, 10
        mo.flag |= MG_M_SR | MG_M_HEAP_SORT | MG_M_2_IO_THREADS
        mo.occ_max1 = 1000
        mo.occ_max1_cap = 2500
        mo.max_gap = 100
        mo.bw = mo.bw_long = 100
        mo.max_frag_len = 800
        mo.pri_ratio = 0.5
        mo.min_lc_cnt, mo.min_lc_score = 2, 25
        mo.min_gc_cnt, mo.min_gc_score = 3, 40
        mo.mini_batch_size = 50_000_000
        mo.min_cov_blen = 50
        mo.chn_pen_gap = 0.2
        mo.ref_bonus = 1
        if preset == "sr":
            mo.flag |= MG_M_FRAG_MODE | MG_M_FRAG_MERGE
            mo.pe_ori = 0 << 1 | 1  # FR
    else:
        return -1
    return 0


def opt_update(gi, mo: MapOptions) -> None:
    """Dynamic occurrence thresholds from index quantiles (options.c:120)."""
    q = gi.cal_quantile([0.1, mo.occ_max1_frac])
    if q[0] > mo.lc_max_occ:
        mo.lc_max_occ = q[0]
    if mo.lc_max_occ > mo.occ_max1_cap:
        mo.lc_max_occ = mo.occ_max1_cap
    if q[1] > mo.occ_max1:
        mo.occ_max1 = q[1]
    if mo.occ_max1 > mo.occ_max1_cap:
        mo.occ_max1 = mo.occ_max1_cap
    if mo.bw_long < mo.bw:
        mo.bw_long = mo.bw


# debug flags (mgpriv.h:7-16), set by the command line's --dbg-* and
# --no-kalloc.  Any bit keeps reads off the native batch and file loops,
# the whole native tail and the device front: they run the per-read
# path's decomposed stages, where the dumps are written.
MG_DBG_NO_KALLOC = 0x1  # allocator flag in the reference; writes nothing
MG_DBG_QNAME = 0x2
MG_DBG_SEED = 0x4
MG_DBG_LCHAIN = 0x8
MG_DBG_INSERT = 0x10
MG_DBG_SHORTK = 0x20    # allocator-mode switch in the reference; writes nothing
MG_DBG_GC1 = 0x40
MG_DBG_LC_PROF = 0x80
MG_DBG_MINIWFA = 0x100
MG_DBG_MWF_SEQ = 0x200
DBG = {"flag": 0}
