"""Command line of the port (main.c:96-301): read mapping, graph
generation, bubble calling and coverage.

    python -m minigraph_tpu_torch [options] <target.gfa> <query.fa> [...]

Options, as minigraph's:
  -x STR   preset: lr (default), asm, sr, se, ggs
  -k INT -w INT          k-mer size and minimizer window
  -t INT                 host threads
  -f FLOAT -U INT[,INT]  occurrence thresholds
  -g NUM -F NUM -r NUM[,NUM] -n INT[,INT] -m INT[,INT]  chaining gaps,
                         fragment length, bandwidths, minimum counts and
                         scores
  -K NUM -p FLOAT -N INT -M FLOAT -j FLOAT  mini-batch size, secondary
                         ratio, secondary count, mask level, divergence
  -c                     base-level alignment (cg:Z, ds:Z)
  -P -D -S               all chains, skip self-diagonal hits, write
                         linear chains
  --write-mz             -S with each chain's minimizer positions
  -o FILE                output file
  --vc --secondary=yes|no --heap-sort=yes|no --show-unmap=yes|no
  --rmq[=yes|no] --no-comp-path --frag --gap-pen FLOAT --ref-bonus INT
  --max-gap-pre NUM --max-lc-skip INT --max-gc-skip INT
  --max-lc-iter NUM --max-rmq-size NUM --gdp-max-ed NUM
  --cap-calloc NUM --min-cov-blen NUM --min-cov-mapq INT --version
  --ggen[=simple|none] -l NUM -d NUM -q INT -L INT --gg-min-end-cnt INT
  --gg-min-end-frac FLOAT --gg-match-pen INT --ins-qovlp=yes|no
  --inv=yes|no           graph generation (rGFA to -o or stdout)
  --call                 bubble calls of one assembly (BED)
  --cov                  segment and link coverage written into the GFA
                         (dc:f; with graph generation, the assemblies'
                         cf:f)
  --device cuda|cpu|none  where the seed (and chain) stages run: cuda
                         (default) on the card, cpu their plain versions,
                         none every read on the native host path.
  --tpu                  --device cuda
  --gwfa-device          bridge the graph chains with the device GWFA
                         pool: on the card with --device cuda or none,
                         its plain version with --device cpu.
  --seed-device          sketch queries of 16384 bp or more that take the
                         per-read path (graph generation, the Python
                         reader loop) with the chunk-halo sweep: on the
                         card with --device cuda or none, its plain
                         version with --device cpu.
  --dbg-seed --dbg-lchain --dbg-gc1 --dbg-qname --dbg-insert
  --dbg-lc-prof --dbg-mwf-long --dbg-mwf-seq --dbg-shortk --no-kalloc
                         minigraph's debug dumps (stderr; --dbg-lchain's
                         LC lines on stdout).  Any of them maps every
                         read on the per-read path; --dbg-shortk and
                         --no-kalloc write nothing.
"""
from __future__ import annotations

import getopt
import sys
from typing import List, Optional

from . import MG_VERSION_COMPAT
from .ggen.driver import ggen
from .graph.bubbles import sort_ref_arc
from .graph.gfa_io import read_gfa, write_gfa
from .mapping.mapper import SEED_DEVICE, map_files
from .options import (DBG, MG_DBG_GC1, MG_DBG_INSERT, MG_DBG_LC_PROF,
                      MG_DBG_LCHAIN, MG_DBG_MINIWFA, MG_DBG_MWF_SEQ,
                      MG_DBG_NO_KALLOC, MG_DBG_QNAME, MG_DBG_SEED,
                      MG_DBG_SHORTK, MG_G_CAL_COV, MG_G_CALL, MG_G_GGSIMPLE, MG_G_NO_INV,
                      MG_G_NO_QOVLP, MG_M_ALL_CHAINS, MG_M_CAL_COV,
                      MG_M_CIGAR, MG_M_FRAG_MERGE, MG_M_FRAG_MODE,
                      MG_M_HEAP_SORT, MG_M_NO_COMP_PATH, MG_M_NO_DIAG,
                      MG_M_PRINT_2ND, MG_M_RMQ, MG_M_SHOW_UNMAP,
                      MG_M_SKIP_GCHECK, MG_M_VERTEX_COOR, MG_M_WRITE_LCHAIN,
                      MG_M_WRITE_MZ, GGOptions, IndexOptions, MapOptions, opt_check,
                      opt_set)
from .utils.syslog import final_log, mlog

_SHORT = "x:k:w:t:r:m:n:g:K:o:p:N:Pq:d:l:f:U:M:F:j:L:DSc"
_LONG = [
    "version", "vc", "secondary=", "ins-qovlp=", "heap-sort=", "show-unmap=",
    "ggen", "ggen-arg=", "rmq", "rmq-arg=", "gg-min-end-cnt=",
    "gg-min-end-frac=",
    "no-comp-path", "gg-match-pen=", "frag", "cov", "min-cov-blen=",
    "min-cov-mapq=", "gap-pen=", "ref-bonus=", "max-gap-pre=", "max-lc-skip=",
    "max-gc-skip=", "max-lc-iter=", "max-rmq-size=", "inv=", "write-mz",
    "call", "cap-calloc=", "gdp-max-ed=", "dbg-seed",
    "dbg-lchain", "dbg-gc1", "dbg-shortk", "dbg-qname", "dbg-insert",
    "dbg-lc-prof", "dbg-mwf-long", "dbg-mwf-seq", "no-kalloc", "tpu",
    "gwfa-device", "seed-device", "device=",
]
# the debug bits of --dbg-* and --no-kalloc (process-wide, as in
# minigraph)
_DBG_BITS = {
    "--dbg-seed": MG_DBG_SEED, "--dbg-lchain": MG_DBG_LCHAIN,
    "--dbg-gc1": MG_DBG_GC1, "--dbg-shortk": MG_DBG_SHORTK,
    "--dbg-qname": MG_DBG_QNAME, "--dbg-insert": MG_DBG_INSERT,
    "--dbg-lc-prof": MG_DBG_LC_PROF, "--dbg-mwf-long": MG_DBG_MINIWFA,
    "--dbg-mwf-seq": MG_DBG_MWF_SEQ, "--no-kalloc": MG_DBG_NO_KALLOC,
}
# options whose argument is optional (--rmq, --rmq=no): getopt has no
# such kind, so the attached form is renamed before it parses
_OPTIONAL_ARG = ("--rmq", "--ggen")
USAGE = ("Usage: python -m minigraph_tpu_torch [options] <target.gfa> "
         "<query.fa> [...]\n")


def _parse_num(s: str) -> int:
    mult = 1
    t = s
    if t and t[-1] in "GgMmKk":
        mult = {"g": 1e9, "m": 1e6, "k": 1e3}[t[-1].lower()]
        t = t[:-1]
    return int(float(t) * mult + 0.499)


def _parse_num2(s: str):
    """A[,B] -> (A, B or None)."""
    if "," in s:
        a, b = s.split(",", 1)
        return _parse_num(a), _parse_num(b)
    return _parse_num(s), None


def _yes_no(flag: int, bit: int, arg: str, yes_to_set: bool = True) -> int:
    yes = arg in ("yes", "y")
    no = arg in ("no", "n")
    if not yes and not no:
        sys.stderr.write("[WARNING] option only accepts 'yes' or 'no'.\n")
        return flag
    return flag | bit if yes == yes_to_set else flag & ~bit


def _split_optional(argv: List[str]) -> List[str]:
    """--rmq=V -> --rmq-arg=V (likewise --ggen), up to a lone --."""
    out = []
    for i, a in enumerate(argv):
        if a == "--":
            return out + argv[i:]
        name, eq, val = a.partition("=")
        out.append(f"{name}-arg={val}" if eq and name in _OPTIONAL_ARG
                   else a)
    return out


def main(argv: Optional[List[str]] = None, map_fn=None) -> int:
    """The command line.  `map_fn` maps the reads (default
    mapping/mapper.py map_files; parallel/dist.py passes its
    distributed version, which takes the same arguments)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    io_, mo, go = IndexOptions(), MapOptions(), GGOptions()
    try:
        opts, args = getopt.gnu_getopt(_split_optional(argv), _SHORT,
                                       _LONG)
    except getopt.GetoptError as e:
        sys.stderr.write(f"[ERROR] {e}\n")
        return 1
    # first pass: presets
    for k, v in opts:
        if k == "-x" and opt_set(v, io_, mo, go) < 0:
            sys.stderr.write(f"[ERROR] unknown preset '{v}'\n")
            return 1
    out = sys.stdout
    n_threads = 4
    device = "cuda"
    gwfa_device = seed_device = False
    for k, v in opts:
        if k == "-w":
            io_.w = int(v)
        elif k == "-k":
            io_.k = int(v)
        elif k == "-t":
            n_threads = int(v)
        elif k == "-f":
            mo.occ_max1_frac = float(v)
        elif k == "-g":
            mo.max_gap = _parse_num(v)
        elif k == "-F":
            mo.max_frag_len = _parse_num(v)
        elif k == "-K":
            mo.mini_batch_size = _parse_num(v)
        elif k == "-p":
            mo.pri_ratio = float(v)
        elif k == "-N":
            mo.best_n = _parse_num(v)
        elif k == "-P":
            mo.flag |= MG_M_ALL_CHAINS
        elif k == "-D":
            mo.flag |= MG_M_NO_DIAG
        elif k == "-M":
            mo.mask_level = float(v)
        elif k == "-j":
            mo.div = float(v)
        elif k == "-l":
            go.min_map_len = _parse_num(v)
        elif k == "-d":
            go.min_depth_len = _parse_num(v)
        elif k == "-q":
            go.min_mapq = int(v)
        elif k == "-L":
            go.min_var_len = int(v)
        elif k == "-S":
            mo.flag |= MG_M_WRITE_LCHAIN
        elif k == "-c":
            mo.flag |= MG_M_CIGAR
        elif k == "-U":
            mo.occ_max1, b = _parse_num2(v)
            if b is not None:
                mo.occ_max1_cap = b
        elif k == "-r":
            mo.bw, b = _parse_num2(v)
            if b is not None:
                mo.bw_long = b
        elif k == "-n":
            mo.min_gc_cnt, b = _parse_num2(v)
            if b is not None:
                mo.min_lc_cnt = b
        elif k == "-m":
            mo.min_gc_score, b = _parse_num2(v)
            if b is not None:
                mo.min_lc_score = b
        elif k == "-o":
            if v != "-":
                out = open(v, "w")
        elif k == "--version":
            print(MG_VERSION_COMPAT)
            return 0
        elif k == "--vc":
            mo.flag |= MG_M_VERTEX_COOR
        elif k == "--secondary":
            mo.flag = _yes_no(mo.flag, MG_M_PRINT_2ND, v)
        elif k == "--ins-qovlp":
            go.flag = _yes_no(go.flag, MG_G_NO_QOVLP, v)
        elif k == "--heap-sort":
            mo.flag = _yes_no(mo.flag, MG_M_HEAP_SORT, v)
        elif k == "--show-unmap":
            mo.flag = _yes_no(mo.flag, MG_M_SHOW_UNMAP, v)
        elif k in ("--ggen", "--ggen-arg"):
            if v in ("", "simple"):
                go.algo = MG_G_GGSIMPLE
            elif v == "none":
                go.algo = 0
            else:
                sys.stderr.write(f"ERROR: unknown ggen algorithm \"{v}\"\n")
                return 1
        elif k == "--gg-min-end-cnt":
            go.ggs_min_end_cnt = int(v)
        elif k == "--gg-min-end-frac":
            go.ggs_min_end_frac = float(v)
        elif k == "--gg-match-pen":
            go.match_pen = int(v)
        elif k == "--inv":
            go.flag = _yes_no(go.flag, MG_G_NO_INV, v, yes_to_set=False)
        elif k == "--call":
            go.flag |= MG_G_CALL
            mo.flag |= MG_M_SKIP_GCHECK
        elif k == "--cov":
            mo.flag |= MG_M_CAL_COV | MG_M_SKIP_GCHECK
            go.flag |= MG_G_CAL_COV
        elif k == "--gwfa-device":
            gwfa_device = True
        elif k == "--seed-device":
            seed_device = True
        elif k == "--tpu":
            device = "cuda"
        elif k == "--write-mz":
            mo.flag |= MG_M_WRITE_MZ | MG_M_WRITE_LCHAIN
        elif k in _DBG_BITS:
            DBG["flag"] |= _DBG_BITS[k]
        elif k == "--rmq":
            mo.flag |= MG_M_RMQ
        elif k == "--rmq-arg":
            mo.flag = _yes_no(mo.flag, MG_M_RMQ, v)
        elif k == "--no-comp-path":
            mo.flag |= MG_M_NO_COMP_PATH
        elif k == "--frag":
            mo.flag |= MG_M_FRAG_MODE | MG_M_FRAG_MERGE
        elif k == "--min-cov-blen":
            mo.min_cov_blen = _parse_num(v)
        elif k == "--min-cov-mapq":
            mo.min_cov_mapq = int(v)
        elif k == "--gap-pen":
            mo.chn_pen_gap = float(v)
        elif k == "--ref-bonus":
            mo.ref_bonus = int(v)
        elif k == "--max-gap-pre":
            mo.max_gap_pre = _parse_num(v)
        elif k == "--max-lc-skip":
            mo.max_lc_skip = int(v)
        elif k == "--max-gc-skip":
            mo.max_gc_skip = int(v)
        elif k == "--max-lc-iter":
            mo.max_lc_iter = _parse_num(v)
        elif k == "--max-rmq-size":
            mo.rmq_size_cap = _parse_num(v)
        elif k == "--cap-calloc":
            mo.cap_kalloc = _parse_num(v)
        elif k == "--gdp-max-ed":
            mo.gdp_max_ed = _parse_num(v)
        elif k == "--device":
            if v not in ("cuda", "cpu", "none"):
                sys.stderr.write(f"[ERROR] unknown device '{v}'\n")
                return 1
            device = None if v == "none" else v
    if opt_check(io_, mo, go) < 0:
        return 1
    if not args:
        sys.stderr.write(USAGE)
        return 1
    # the device pools follow --device: the plain versions on the CPU,
    # else the card
    pool_dev = "cpu" if device == "cpu" else "cuda"
    if seed_device:
        SEED_DEVICE.update(on=True, device=pool_dev)
    g = read_gfa(args[0])
    mlog("main", f'loaded the graph from "{args[0]}"')
    if go.algo == 0 and not (go.flag & MG_G_CALL):
        pool = pool_dev if gwfa_device else None
        ret = (map_fn or map_files)(
            g, args[1:], io_, mo, out=out, n_threads=n_threads,
            device=device, gwfa_device=pool)
    else:
        if go.flag & MG_G_CALL:
            sort_ref_arc(g)
        ret = ggen(g, args[1:], io_, mo, go, out=out, n_threads=n_threads)
    if (go.algo != 0 or (mo.flag & MG_M_CAL_COV)) \
            and not (go.flag & MG_G_CALL):
        write_gfa(g, out)
    if out is not sys.stdout:
        out.close()
    final_log(MG_VERSION_COMPAT, ["minigraph_tpu_torch"] + argv)
    return 1 if ret else 0


if __name__ == "__main__":
    sys.exit(main())
