"""Option structs, presets and validation (options.c, minigraph.h:46-91)."""
from __future__ import annotations

from dataclasses import dataclass

# mapping flags (minigraph.h:9-31)
MG_M_SPLICE = 0x10
MG_M_SR = 0x20
MG_M_HEAP_SORT = 0x400
MG_M_PRINT_2ND = 0x2000
MG_M_RMQ = 0x8000
MG_M_SHOW_UNMAP = 0x100000
MG_M_NO_COMP_PATH = 0x200000
MG_M_NO_DIAG = 0x400000
MG_M_CIGAR = 0x4000000
# seed flags (mgpriv.h:18-27)
MG_SEED_IGNORE = 1 << 41
MG_SEED_TANDEM = 1 << 42
MG_SEED_FIXED = 1 << 43
MG_MAX_SEG = 255
MG_SEED_SEG_SHIFT = 48
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


def opt_set(preset: str | None, io: IndexOptions, mo: MapOptions) -> int:
    """Apply a preset (options.c:65-108).  The port maps long reads
    only, so it knows the default `lr` preset and rejects the others."""
    if preset is None or preset == "lr":
        return 0
    return -1


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
