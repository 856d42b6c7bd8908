"""Offline post-processing utilities, part 2 (port of the JAX
package's tools/mgutils2.py).

Equivalents of the remaining misc/mgutils.js (dispatch at
misc/mgutils.js:1437-1449) and misc/mgutils-es6.js (:306-308)
subcommands: FASTA housekeeping (renamefa, joinfa), GAF coordinate
conversion (stableGaf, subgaf), SV callset evaluation (sveval, the
paper's dipcall-concordance tool), alignment-derived blacklists
(paf2bl), assembly-gap extraction (extractseg), segment/repeat
summaries (segfreq, anno2tbl), SQL export (bed2sql) and merged-BED
helpers (addsample, getlcr).

`anno` and `genecopy` live in mgutils3.py, the command table in
mgutils.py `commands()`.  Each command writes to `out` (sys.stdout
when None); segfreq's repeat-length table goes to `err` (sys.stderr
when None).
"""
from __future__ import annotations

import getopt
import re
import sys
from typing import List

from .mgutils import _open


# ---------------------------------------------------------------- helpers

def _it_overlap(intervals, st, en):
    """All intervals [s,e) overlapping [st,en) (it_overlap analog)."""
    return [iv for iv in intervals if iv[0] < en and st < iv[1]]


def _it_contained(intervals, st, en):
    """True if [st,en) is contained in one interval (it_contained)."""
    return any(s <= st and en <= e for s, e, *_ in intervals)


def classify_repeat(anno: str) -> str:
    """Repeat-class label (mgutils.js mg_classify_repeat)."""
    if anno == "mini":
        return "11_VNTR"
    if anno == "micro":
        return "12_STR"
    if anno == "lcr":
        return "13_Other-LCR"
    if anno in ("LINE/L1", "LINE/L1HS"):
        return "02_L1"
    if anno in ("SINE/Alu", "SINE/AluY"):
        return "01_Alu"
    if anno == "Retroposon/SVA":
        return "03_SVA"
    if anno == "LTR/ERV":
        return "04_ERV"
    if anno == "inter" or re.match(r"^(DNA|LINE|SINE|LTR)", anno or ""):
        return "05_Other-TE"
    if re.match(r"^Satellite", anno or "") or anno in ("alpha", "hsat2/3",
                                                       "_sat"):
        return "10_Satellite"
    if anno in ("self", "none", "partial"):
        return "30_Low-repeat"
    if anno == "segdup":
        return "21_SegDup"
    return "20_Other-repeat"


# ------------------------------------------------------------ subcommands

def cmd_renamefa(argv: List[str], out=None) -> int:
    """Prefix FASTA names PanSN-style (mgutils.js mg_cmd_renamefa)."""
    out = out or sys.stdout
    opts, args = getopt.gnu_getopt(argv, "d:")
    sep = "#"
    for k, v in opts:
        if k == "-d":
            sep = v
    if len(args) < 2:
        sys.stderr.write(
            "Usage: mgutils renamefa [-d delimiter] <prefix> <in.fa>\n")
        return 1
    prefix = args[0]
    with _open(args[1]) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                name = re.sub(r"^\S+#", "", line[1:])
                out.write(f">{prefix}{sep}{name}\n")
            else:
                out.write(line + "\n")
    return 0


def cmd_joinfa(argv: List[str], out=None) -> int:
    """Concatenate FASTA records with N spacers (mg_cmd_joinfa)."""
    out = out or sys.stdout
    opts, args = getopt.gnu_getopt(argv, "n:l:s:")
    len_n, min_len, name = 20, 150, "decoy-cat"
    for k, v in opts:
        if k == "-l":
            min_len = int(v)
        elif k == "-n":
            len_n = int(v)
        elif k == "-s":
            name = v
    if not args:
        sys.stderr.write("Usage: mgutils joinfa [options] <in.fa>\n")
        return 1
    parts, cur = [], []
    with _open(args[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                s = "".join(cur)
                if len(s) >= min_len:
                    parts.append(s)
                cur = []
            else:
                cur.append(line)
    s = "".join(cur)
    if len(s) >= min_len:
        parts.append(s)
    out.write(f">{name}\n{('N' * len_n).join(parts)}\n")
    return 0


def cmd_paf2bl(argv: List[str], out=None) -> int:
    """Blacklist regions from self-alignment PAF (mg_cmd_paf2bl)."""
    out = out or sys.stdout
    opts, args = getopt.gnu_getopt(argv, "d:s")
    min_de, max_de, sub_de, min_mapq, min_len = 0.01, 0.1, 0.002, 5, 500
    is_sub = False
    for k, v in opts:
        if k == "-d":
            min_de = float(v)
        elif k == "-s":
            is_sub = True
    if not args:
        sys.stderr.write("Usage: mgutils paf2bl <ins.paf>\n")
        return 1
    with _open(args[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            if re.search(r"\ttp:A:[SI]", line):
                continue
            t = line.split("\t")
            if len(t) < 12 or int(t[11]) < min_mapq or int(t[10]) < min_len:
                continue
            m = re.search(r"\tde:f:(\S+)", line)
            if not m:
                continue
            de = float(m.group(1))
            if is_sub:
                if de > sub_de:
                    continue
            elif de < min_de or de > max_de:
                continue
            out.write(f"{t[5]}\t{t[7]}\t{t[8]}\n")
    return 0


def cmd_stable_gaf(argv: List[str], out=None) -> int:
    """Convert GAF vertex coordinates to stable coordinates
    (mg_cmd_stableGaf; same transform as the -c/--vc writer inverse)."""
    out = out or sys.stdout
    if not argv:
        sys.stderr.write("Usage: mgutils stableGaf <graph.gfa> [aln.gaf]\n")
        return 1
    segh = {}
    pri_len = {}
    tag_re = re.compile(r"\t(LN|SN|SO|SR):[Zi]:(\S+)")
    with _open(argv[0]) as f:
        for line in f:
            m = re.match(r"^S\t(\S+)\t(\S+)(\t.*)?", line.rstrip("\n"))
            if not m:
                continue
            seg, sq, tags = m.group(1), m.group(2), m.group(3) or ""
            ln = 0 if sq == "*" else len(sq)
            sn, so, sr = None, -1, -1
            for tm in tag_re.finditer(tags):
                if tm.group(1) == "LN":
                    ln = int(tm.group(2))
                elif tm.group(1) == "SN":
                    sn = tm.group(2)
                elif tm.group(1) == "SO":
                    so = int(tm.group(2))
                elif tm.group(1) == "SR":
                    sr = int(tm.group(2))
            if sn is None or so < 0 or sr < 0 or ln <= 0:
                raise ValueError(f"failed to parse tags '{tags}'")
            segh[seg] = (sn, so, so + ln, sr)
            if sr == 0:
                pri_len[sn] = max(pri_len.get(sn, 0), so + ln)
    walk_re = re.compile(r"([><])([^\s><]+)")
    gaf = _open(argv[1]) if len(argv) > 1 else sys.stdin
    for line in gaf:
        m = re.match(r"^(\S+)\t(\d+\t\d+\t\d+)\t([+-])\t(\S+)\t(\d+)"
                     r"\t(\d+)\t(\d+)\t(.*)", line.rstrip("\n"))
        if not m:
            continue
        a = []
        for wm in walk_re.finditer(m.group(4)):
            if wm.group(2) not in segh:
                raise ValueError(f"failed to find segment '{wm.group(2)}'")
            sn, s0, s1, sr = segh[wm.group(2)]
            add_new = True
            if a:
                b = a[-1]
                if b[0] == wm.group(1) and sr == b[4] and sn == b[1]:
                    if b[0] == ">":
                        if s0 == b[3]:
                            b[3] = s1
                            add_new = False
                    else:
                        if s1 == b[2]:
                            b[2] = s0
                            add_new = False
            if add_new:
                a.append([wm.group(1), sn, s0, s1, sr])
        path_len = sum(x[3] - x[2] for x in a)
        if path_len != int(m.group(5)):
            raise ValueError(
                f"inconsistent path length for '{m.group(1)}': "
                f"{path_len}!={m.group(5)}")
        strand, qs, qe = m.group(3), int(m.group(6)), int(m.group(7))
        if len(a) == 1 and a[0][1] in pri_len:
            if a[0][0] == ">":
                qs += a[0][2]
                qe += a[0][2]
            else:
                strand = "-" if strand == "+" else "+"
                st = a[0][2] + (path_len - 1 - qe)
                en = a[0][2] + (path_len - 1 - qs)
                qs, qe = st, en
            path = a[0][1]
            path_len = pri_len[a[0][1]]
        else:
            path = "".join(f"{x[0]}{x[1]}:{x[2]}-{x[3]}" for x in a)
        out.write("\t".join(map(str, [m.group(1), m.group(2), strand,
                                      path, path_len, qs, qe,
                                      m.group(8)])) + "\n")
    return 0


def cmd_subgaf(argv: List[str], out=None) -> int:
    """Select GAF records overlapping a stable region (mg_cmd_subgaf)."""
    out = out or sys.stdout
    if len(argv) < 2:
        sys.stderr.write("Usage: mgutils subgaf <in.gaf> <reg>\n")
        return 1
    m = re.match(r"^(\S+):(\S+)-(\S+)", argv[1])
    if not m:
        sys.stderr.write("ERROR: region must be ctg:start-end\n")
        return 1
    ctg, st, en = m.group(1), int(m.group(2)), int(m.group(3))
    seg_re = re.compile(r"([><])([^\s><]+):(\d+)-(\d+)")
    with _open(argv[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 9:
                continue
            ln, s, e = int(t[6]), int(t[7]), int(t[8])
            regs = []
            if t[5][:1] in "><":
                x = 0
                for sm in seg_re.finditer(t[5]):
                    a, b = int(sm.group(3)), int(sm.group(4))
                    c = b - a
                    if x == 0:
                        if b - a <= s:
                            raise ValueError("Inconsistent!")
                        a += s
                    if x + c == ln:
                        b -= ln - e
                    regs.append((sm.group(2), a, b))
                    x += c
            else:
                regs.append((t[5], s, e))
            if any(r[0] == ctg and r[2] > st and en > r[1] for r in regs):
                out.write(line)
    return 0


def cmd_sveval(argv: List[str], out=None) -> int:
    """SV callset sensitivity/specificity vs a truth VCF
    (mg_cmd_sveval; the paper's dipcall concordance evaluation)."""
    out = out or sys.stdout
    opts, args = getopt.gnu_getopt(argv, "f:v:t:s:aeF")
    flank, min_var_len, min_test_len, min_sc = 100, 100, 50, 20.0
    non_chr = out_err = flt_vcf = False
    for k, v in opts:
        if k == "-f":
            flank = int(v)
        elif k == "-v":
            min_var_len = int(v)
        elif k == "-t":
            min_test_len = int(v)
        elif k == "-s":
            min_sc = float(v)
        elif k == "-a":
            non_chr = True
        elif k == "-e":
            out_err = True
        elif k == "-F":
            flt_vcf = True
    if len(args) < 3:
        sys.stderr.write(
            "Usage: mgutils sveval [options] <true.vcf> <true.bed> "
            "<call.txt>\n")
        return 1

    bed = {}
    with _open(args[1]) as f:
        for line in f:
            t = line.split("\t")
            if len(t) < 3:
                continue
            if not non_chr and re.match(r"^(chr)?[XY]$", t[0]):
                continue
            bed.setdefault(t[0], []).append((int(t[1]), int(t[2])))

    vcf = {}
    with _open(args[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("#") or len(t) < 10:
                continue
            flt = t[6] not in (".", "PASS")
            if flt_vcf and flt:
                continue
            if t[0] not in bed:
                continue
            ref = t[3]
            st = int(t[1]) - 1
            en = st + len(ref)
            al = [ref] + t[4].split(",")
            max_diff = max((abs(len(a) - len(ref)) for a in al[1:]),
                           default=0)
            if max_diff < min_test_len:
                continue
            s = t[9].split(":")
            if not s:
                continue
            gt = re.split(r"[|/]", s[0])
            max_ev = max_diff = 0
            for g in gt:
                if g == ".":
                    continue
                ln = len(al[int(g)]) - len(ref)
                if abs(ln) > max_diff:
                    max_diff, max_ev = abs(ln), ln
            if max_diff < min_test_len:
                continue
            vcf.setdefault(t[0], []).append(
                (st, en, max_diff, max_ev, flt, s[0]))

    rst = {}
    with _open(args[2]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 9 or float(t[3]) < min_sc:
                continue
            if t[0] not in bed:
                continue
            ref_len = 0 if t[7] == "*" else len(t[7])
            max_diff = max_ev = 0
            for i in range(8, len(t)):
                alt_len = 0 if t[i] == "*" else len(t[8])
                ln = alt_len - ref_len
                if abs(ln) > max_diff:
                    max_diff, max_ev = abs(ln), ln
            rst.setdefault(t[0], []).append(
                (int(t[1]), int(t[2]), max_diff, max_ev))

    n_vcf = [0, 0, 0]
    fn = [0, 0, 0]
    for ctg, vl in vcf.items():
        for v in vl:
            if v[2] < min_var_len or v[4]:
                continue
            st, en = max(v[0] - flank, 0), v[1] + flank
            if not _it_contained(bed[ctg], st, en):
                continue
            sub = 1 if v[3] < 0 else 2
            n_vcf[0] += 1
            n_vcf[sub] += 1
            if not _it_overlap(rst.get(ctg, []), st, en):
                if out_err:
                    out.write(f"FN\t{ctg}\t{v[0]}\t{v[1]}\t{v[3]}\t{v[5]}\n")
                fn[0] += 1
                fn[sub] += 1

    n_rst = [0, 0, 0]
    fp = [0, 0, 0]
    for ctg, rl in rst.items():
        for v in rl:
            if v[2] < min_var_len:
                continue
            st, en = max(v[0] - flank, 0), v[1] + flank
            if not _it_contained(bed[ctg], st, en):
                continue
            sub = 1 if v[3] < 0 else 2
            n_rst[0] += 1
            n_rst[sub] += 1
            if not _it_overlap(vcf.get(ctg, []), st, en):
                if out_err:
                    out.write(f"FP\t{ctg}\t{v[0]}\t{v[1]}\t{v[3]}\n")
                fp[0] += 1
                fp[sub] += 1

    def frac(a, b):
        return f"{a / b:.4f}" if b else "0.0000"

    for tag, f_, n_ in (("NA", fn[0], n_vcf[0]), ("ND", fn[1], n_vcf[1]),
                        ("NI", fn[2], n_vcf[2]), ("PA", fp[0], n_rst[0]),
                        ("PD", fp[1], n_rst[1]), ("PI", fp[2], n_rst[2])):
        out.write(f"{tag}\t{f_}\t{n_}\t{frac(f_, n_)}\n")
    return 0


def cmd_extractseg(argv: List[str], out=None) -> int:
    """Extract regions between two anchor segments from -S/--write-mz
    GAF dumps (mg_cmd_extractseg)."""
    out = out or sys.stdout
    opts, args = getopt.gnu_getopt(argv, "el:")
    min_len, is_end = 100000, False
    for k, v in opts:
        if k == "-l":
            min_len = int(v)
        elif k == "-e":
            is_end = True
    if len(args) < 3:
        sys.stderr.write(
            "Usage: mgutils extractseg <seg1> <seg2> <in.gaf> [...]\n")
        return 1
    seg = (args[0], args[1])

    def process(ctg, first, last):
        if ctg is None or first[0] is None or first[1] is None:
            return
        if first[0][7] == first[1][7]:
            return
        if first[0][7] < first[1][7]:
            if last[0][7] >= first[1][7]:
                return
            if is_end:
                out.write(f"{ctg}\t{last[0][8]}\t{first[1][7]}\t*\t0\t+\n")
            else:
                out.write(f"{ctg}\t{last[0][7]}\t{first[1][8]}\t*\t0\t+\n")
        else:
            if last[1][7] >= first[0][7]:
                return
            if is_end:
                out.write(f"{ctg}\t{last[1][8]}\t{first[0][7]}\t*\t0\t-\n")
            else:
                out.write(f"{ctg}\t{last[1][7]}\t{first[0][8]}\t*\t0\t-\n")

    for fn in args[2:]:
        flt = False
        first = [None, None]
        last = [None, None]
        ctg = None
        with _open(fn) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                if t[0] != "*":
                    process(ctg, first, last)
                    flt = (int(t[3]) - int(t[2]) < min_len
                           or int(t[8]) - int(t[7]) < min_len)
                    first = [None, None]
                    last = [None, None]
                    ctg = t[0]
                elif not flt:
                    s = t[1][1:]
                    t[7], t[8] = int(t[7]), int(t[8])
                    for j in (0, 1):
                        if s == seg[j] and t[3] != "0":
                            if first[j] is None:
                                first[j] = list(t)
                            last[j] = list(t)
        process(ctg, first, last)
    return 0


def cmd_anno2tbl(argv: List[str], out=None) -> int:
    """Summarize anno output into a repeat-class table
    (mg_cmd_anno2tbl)."""
    out = out or sys.stdout
    f = _open(argv[0]) if argv else sys.stdin
    h = {}
    for line in f:
        t = line.rstrip("\n").split("\t")
        if len(t) < 12 or t[11] == "gap":
            continue
        if re.search(r"chrUn|_random", t[0]):
            continue
        ti = [int(t[i]) for i in range(1, 8)]
        na = min(ti[3], 4)
        key = classify_repeat(t[11])
        if key not in h:
            h[key] = [0.0] * 11
        h[key][na] += 1
        h[key][na + 3] += ti[6]
        if int(t[8]) >= 0 and int(t[10]) >= 0:
            h[key][na + 6] += int(t[8]) - int(t[10])
    for key in sorted(h):
        label = re.sub(r"^[0-9]+_", "", key)
        vals = "\t".join(str(int(x)) if float(x).is_integer() else str(x)
                         for x in h[key][2:])
        out.write(f"{key}\t{label}\t{vals}\n")
    return 0


def cmd_addsample(argv: List[str], out=None) -> int:
    """Rewrite the merged-BED header with sample names
    (mgutils-es6.js mg_cmd_addsample)."""
    out = out or sys.stdout
    if len(argv) < 2:
        sys.stderr.write("Usage: mgutils addsample <merged.bed> "
                         "<sample.txt>\n")
        return 1
    samples = []
    with _open(argv[1]) as f:
        for line in f:
            samples.append(line.split()[0])
    with _open(argv[0]) as f:
        for line in f:
            if not line.startswith("#") or line.startswith("##"):
                out.write(line)
            else:
                out.write("#CHROM\tSTART\tEND\tINFO\tFORMAT\t"
                          + "\t".join(samples) + "\n")
    return 0


def cmd_getlcr(argv: List[str], out=None) -> int:
    """Extract low-complexity regions from merged BED
    (mgutils-es6.js mg_cmd_getlcr)."""
    out = out or sys.stdout
    opts, args = getopt.gnu_getopt(argv, "a:r:e:f:")
    ext, min_lcr, min_ac, ref_idx = 5, 0.7, 5, 0
    for k, v in opts:
        if k == "-r":
            ref_idx = int(v)
        elif k == "-e":
            ext = int(v)
        elif k == "-f":
            min_lcr = float(v)
        elif k == "-a":
            min_ac = int(v)
    if not args:
        sys.stderr.write("Usage: mgutils getlcr [options] <merged.bed>\n")
        return 1
    info_re = re.compile(r"([^\s=;]+)=([^\s=;]+)")
    with _open(args[0]) as f:
        for line in f:
            if line.startswith("#"):
                continue
            t = line.rstrip("\n").split("\t", 5 + ref_idx)
            ldust = lbb = 0
            anno = alen = ac = None
            for m in info_re.finditer(t[3]):
                if m.group(1) == "LBUBBLE":
                    lbb = int(m.group(2))
                elif m.group(1) == "LDUST":
                    ldust = int(m.group(2))
                elif m.group(1) == "ANNO":
                    anno = m.group(2)
                elif m.group(1) == "ALEN":
                    alen = m.group(2).split(",")
                elif m.group(1) == "AC":
                    ac = m.group(2).split(",")
            if alen is None:
                continue
            is_lcr = bool(re.match(r"^(lcr|mini|micro|ldust)$", anno or ""))
            if anno == "segdup" and lbb > 0 and ldust >= lbb * min_lcr:
                is_lcr = True
            if not is_lcr:
                continue
            m = re.match(r"^(\d+)", t[4 + ref_idx])
            if not m:
                continue
            ref = int(m.group(1))
            alen_sel = [int(alen[i]) for i in range(len(ac))
                        if i == ref or int(ac[i]) >= min_ac]
            if len(alen_sel) < 2:
                continue
            ctg = re.sub(r"^[^\s#]+#\d#", "", t[0])
            st, en = int(t[1]), int(t[2])
            mx = max([en - st] + alen_sel)
            st = st - ext if st > ext else 0
            out.write(f"{ctg}\t{st}\t{en + ext}\tmg\t{mx}\n")
    return 0


def cmd_bed2sql(argv: List[str], out=None) -> int:
    """Export pasted per-sample BEDs as SQL inserts (mg_cmd_bed2sql)."""
    out = out or sys.stdout
    if not argv:
        sys.stderr.write("Usage: paste *.bed | mgutils bed2sql "
                         "<sample.list> | sqlite3 rGFA.db\n")
        return 1
    samples = []
    with _open(argv[0]) as f:
        for line in f:
            samples.append(line.split("\t")[0].strip())
    src = _open(argv[1]) if len(argv) >= 2 and argv[1] != "-" else sys.stdin
    out.write("DROP INDEX IF EXISTS idx_bwalk;\n")
    out.write("DROP INDEX IF EXISTS idx_cst;\n")
    out.write("DROP INDEX IF EXISTS idx_cen;\n")
    out.write("BEGIN TRANSACTION;\n")
    wid = bid = 0
    ins_walk = []
    for line in src:
        t = line.rstrip("\n").split("\t")
        if len(t) != len(samples) * 6:
            raise ValueError("Different number of samples")
        h = {}
        for j, i in enumerate(range(5, len(t), 6)):
            if t[i] == ".":
                continue
            s = t[i].split(":")
            if s[0] not in h:
                h[s[0]] = wid
                ins_walk.append((wid, bid, s[1], s[0]))
                wid += 1
            v = [bid, samples[j], h[s[0]], s[3], s[4], s[5],
                 1 if s[2] == "+" else -1]
            vals = ",".join(f"'{x}'" for x in v)
            out.write("INSERT INTO call (bid,sample,wid,ctg,start,end,"
                      f"strand) VALUES ({vals});\n")
        bid += 1
    for w in ins_walk:
        vals = ",".join(f"'{x}'" for x in w)
        out.write(f"INSERT INTO bwalk (wid,bid,len,walk) VALUES ({vals});\n")
    out.write("END TRANSACTION;\n")
    out.write("CREATE INDEX IF NOT EXISTS idx_bwalk ON bwalk (bid);\n")
    out.write("CREATE INDEX IF NOT EXISTS idx_cst   ON call  (ctg, start);\n")
    out.write("CREATE INDEX IF NOT EXISTS idx_cen   ON call  (ctg, end);\n")
    return 0


def cmd_segfreq(argv: List[str], out=None, err=None) -> int:
    """Per-segment allele frequencies from merged calls
    (mg_cmd_segfreq)."""
    out = out or sys.stdout
    err = err or sys.stderr
    opts, args = getopt.gnu_getopt(argv, "f:")
    min_af = 0.05
    for k, v in opts:
        if k == "-f":
            min_af = float(v)
    if len(args) < 2:
        sys.stderr.write("Usage: mgutils segfreq [-f minFreq=0.05] "
                         "<gfa2bed.bed> <merged.txt> [bubble.bed]\n")
        return 1
    h = {}
    a = []
    with _open(args[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            h[t[3]] = len(a)
            a.append([t[0], t[1], t[2], t[3], int(t[4]), 0, 0, "N/A",
                      "N/A", 0, ".", ".", "."])
    info_re = re.compile(r"([^\s=;]+)=([^\s=;]+)")
    walk_re = re.compile(r"([><])([^\s><]+)")
    bb = {}
    with _open(args[1]) as f:
        for line in f:
            if line.startswith("#"):
                continue
            t = line.rstrip("\n").split("\t", 4)
            anno = walk = ac = None
            for m in info_re.finditer(t[3]):
                if m.group(1) == "ANNO":
                    anno = m.group(2)
                elif m.group(1) == "AWALK":
                    walk = m.group(2).split(",")
                elif m.group(1) == "AC":
                    ac = [int(x) for x in m.group(2).split(",")]
            if ac is None or walk is None:
                raise ValueError("Missing AC or AWALK")
            if len(ac) != len(walk):
                raise ValueError("Inconsistent AC or AWALK")
            anno = anno or "N/A"
            bb[f"{t[0]}_{t[1]}_{t[2]}"] = anno
            ns = sum(ac)
            dup = set()
            for i, wlk in enumerate(walk):
                if wlk == "*":
                    continue
                for m in walk_re.finditer(wlk):
                    s = m.group(2)
                    if s not in h:
                        raise ValueError(f"Missing segment {s}")
                    if s in dup:
                        continue
                    dup.add(s)
                    b = a[h[s]]
                    b[5] = ns
                    b[6] += ac[i]
                    b[7] = anno
                    b[8] = classify_repeat(anno)
                    b[9] = len(walk)
    if len(args) >= 3:
        with _open(args[2]) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                s = t[11].split(",")
                anno = bb.get(f"{t[0]}_{t[1]}_{t[2]}")
                if anno is None:
                    raise ValueError("Missing bubble")
                for seg in s[1:-1]:
                    if seg not in h:
                        raise ValueError("Inconsistent bubble file")
                    b = a[h[seg]]
                    b[10], b[11], b[12] = t[0], t[1], t[2]
                    b[7] = anno
                    b[8] = classify_repeat(anno)
    replen = {}
    for b in a:
        out.write("\t".join(map(str, b)) + "\n")
        anno = b[8]
        ln = int(b[2]) - int(b[1])
        if b[4] > 0 and b[5] > 0 and b[6] >= b[5] * min_af:
            if anno not in replen:
                replen[anno] = [0, 0, 0]
            if b[9] == 2:
                replen[anno][0] += ln
            elif b[9] == 3:
                replen[anno][1] += ln
            elif b[9] > 3:
                replen[anno][2] += ln
    for x in sorted(replen):
        y = re.sub(r"^\d+_", "", x)
        err.write(f"{x}\t{y}\t" + "\t".join(map(str, replen[x])) + "\n")
    return 0
