"""Offline post-processing utilities, part 3 (port of the JAX
package's tools/mgutils3.py): bubble annotation and gene-copy analysis
(misc/mgutils.js mg_cmd_anno :174-551 and mg_cmd_genecopy :1250-1410).

`anno` merges per-bubble feature intervals from external annotators
(RepeatMasker .out, etrf, sdust, seqtk gap, dna-brnn, self-PAF,
gfatools bubble + segdup/longdust coverage) and classifies each
bubble; `genecopy` ranks gene-to-graph GAF hits by alignment score and
greedily selects non-redundant gene copies.  Both reproduce the
reference's output byte layout, including its quirks (the growing
`substr` window in the hsat motif scan and the segment-local walk
offset arithmetic), so existing downstream pipelines keep working.
Each command writes to `out` (sys.stdout when None).
"""
from __future__ import annotations

import getopt
import re
import sys
from typing import List

from .mgutils import _open
from .mgutils2 import _it_overlap

_COMP = {"A": "T", "T": "A", "C": "G", "G": "C"}


def _hsat_motifs(motif0: str = "GGAAT"):
    """(GGAAT)n rotations/revcomp + all single-base mutations
    (mgutils.js:288-322)."""
    motif = [motif0]
    motif += ["".join(_COMP[c] for c in reversed(m)) for m in motif]
    rot = []
    for m in motif:
        for j in range(1, len(m)):
            rot.append(m[j:] + m[:j])
    motif += rot
    motif_hash = {m: i for i, m in enumerate(motif)}
    motif_mut = {}
    for x in list(motif_hash):
        for i in range(len(x)):
            for b in "ACGT":
                if x[i] == b:
                    continue
                a = list(x)
                a[i] = b
                motif_mut["".join(a)] = 1
    return motif_hash, motif_mut


def cmd_anno(argv: List[str], out=None) -> int:
    """Annotate bubble/insert sequences (mg_cmd_anno,
    misc/mgutils.js:174-551)."""
    out = out or sys.stdout
    min_feat_len, min_centro_len, micro_cap = 30, 200, 6
    mobile, max_mobile_div = False, 2.0
    min_segdup_frac, min_ld_frac = 0.2, 0.7
    fn = {k: None for k in "epgdrcbsx"}
    opts, args = getopt.gnu_getopt(argv, "e:p:g:d:r:c:l:S:L:b:s:mx:X:")
    for o, a in opts:
        if o == "-l":
            min_feat_len = int(a)
        elif o == "-S":
            min_segdup_frac = float(a)
        elif o == "-m":
            mobile = True
        elif o in ("-e", "-p", "-g", "-d", "-r", "-c", "-b", "-s", "-x"):
            fn[o[1]] = a
        # -L/-X accepted but unused, like the reference option loop
    if not args:
        sys.stderr.write("Usage: mgutils anno [options] <in.bed>\n")
        return 1

    bb, bba, seg, ld = {}, [], {}, {}
    with _open(args[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 4:
                continue
            key = f"{t[0]}_{t[1]}_{t[2]}"
            length = int(t[3])
            if length < int(t[2]) - int(t[1]):
                raise SystemExit(
                    "ERROR: event length smaller than interval length")
            bb[key] = [length, {}]
            bba.append(key)

    if fn["b"]:
        for tag, dst in (("s", seg), ("x", ld)):
            if fn[tag]:
                with _open(fn[tag]) as f:
                    for line in f:
                        t = line.rstrip("\n").split("\t")
                        dst[t[3]] = [int(t[4]), int(t[2]) - int(t[1]),
                                     int(t[6])]
        with _open(fn["b"]) as f:   # gfatools bubble output
            for line in f:
                t = line.rstrip("\n").split("\t")
                key = f"{t[0]}_{t[1]}_{t[2]}"
                if key not in bb:
                    continue
                bb[key].extend(t[3:11])
                s = t[11].split(",")
                tot_len = tot_sd = tot_ld = ref_len = 0
                dup = {}
                for i in range(1, len(s) - 1):
                    if s[i] not in seg and s[i] not in ld:
                        continue
                    if s[i] in dup:
                        continue
                    dup[s[i]] = 1
                    if s[i] in seg:
                        tot_len += seg[s[i]][1]
                        tot_sd += seg[s[i]][2]
                        if seg[s[i]][0] == 0:
                            ref_len += seg[s[i]][1]
                        if s[i] in ld:
                            tot_ld += ld[s[i]][2]
                    else:
                        tot_len += ld[s[i]][1]
                        tot_ld += ld[s[i]][2]
                        if ld[s[i]][0] == 0:
                            ref_len += ld[s[i]][1]
                bb[key][7] = tot_len
                bb[key][8] = tot_sd
                bb[key][9] = tot_ld

    if fn["r"]:   # RepeatMasker .out
        motif0 = "GGAAT"
        motif_hash, motif_mut = _hsat_motifs(motif0)

        def process_rm(lines):
            if not lines:
                return
            key = lines[0][4]
            if key not in bb:
                raise SystemExit("ERROR: missing key: " + key)
            h = bb[key][1]
            for t in lines:
                st, en = int(t[5]) - 1, int(t[6])
                h.setdefault(t[10], []).append([st, en])

        lines: List[List[str]] = []
        with _open(fn["r"]) as f:
            for raw in f:
                t = re.split(r"\s+", raw.rstrip("\n").lstrip())
                if len(t) < 15:
                    continue
                if t[9] == "ALR/Alpha":
                    t[10] = "alpha"
                elif t[9] == "HSATII":
                    t[10] = "hsat2/3"
                elif t[10].startswith("LTR/ERV"):
                    t[10] = "LTR/ERV"
                elif t[10].startswith("LTR"):
                    t[10] = "LTR/misc"
                elif t[10].startswith("DNA"):
                    t[10] = "DNA/misc"
                elif re.search(r"rRNA|scRNA|snRNA|srpRNA", t[10]):
                    t[10] = "RNAmisc"
                elif t[10].startswith("LINE") and t[10] != "LINE/L1":
                    t[10] = "LINE/misc"
                elif t[10] in ("Simple_repeat", "Satellite"):
                    m4 = re.match(r"^\(([ACGT]+)\)n", t[9])
                    if m4 is not None:
                        mseq = m4.group(1)
                        if mseq in motif_hash:
                            t[10] = "hsat2/3"
                        elif len(mseq) % len(motif0) == 0:
                            c = c_mut = 0
                            for j in range(0, len(mseq), len(motif0)):
                                # reference substr(j, j+5): the window
                                # length GROWS with j (mgutils.js:357)
                                s = mseq[j: j + (j + len(motif0))]
                                if s in motif_hash:
                                    c += 1
                                elif s in motif_mut:
                                    c_mut += 1
                            if c > 0 and (c + c_mut) * len(motif0) \
                                    == len(mseq):
                                t[10] = "hsat2/3"
                if mobile:
                    if t[10] == "LINE/L1" and t[9] == "L1HS" \
                            and float(t[1]) < max_mobile_div:
                        t[10] = "LINE/L1HS"
                    if t[10] == "SINE/Alu" and t[9].startswith("AluY") \
                            and float(t[1]) < max_mobile_div:
                        t[10] = "SINE/AluY"
                if t[10] in ("Simple_repeat", "Low_complexity"):
                    t[10] = "LCR"
                if lines and lines[0][4] != t[4]:
                    process_rm(lines)
                    lines = []
                lines.append(t)
        process_rm(lines)

        for key in bba:
            h = bb[key][1]
            groups = (("_inter", r"^(DNA|SINE|LINE|Retroposon|LTR)"),
                      ("_sat", r"^(Satellite|hsat2/3|alpha)"),
                      ("_alu", r"^(SINE/Alu)"),
                      ("_l1", r"^(LINE/L1)"))
            adds = {}
            for name, pat in groups:
                acc = []
                for k2 in h:
                    if re.match(pat, k2):
                        acc.extend(h[k2])
                if acc:
                    adds[name] = acc
            h.update(adds)

    if fn["e"]:   # etrf tandem repeats
        with _open(fn["e"]) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                period = int(t[4])
                if period == 1:
                    continue
                anno = "micro" if period <= micro_cap else "mini"
                st, en = int(t[1]), int(t[2])
                bb[t[0]][1].setdefault(anno, []).append([st, en])
                bb[t[0]][1].setdefault("LCR", []).append([st, en])
    if fn["d"]:   # sdust LCRs
        with _open(fn["d"]) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                bb[t[0]][1].setdefault("LCR", []).append(
                    [int(t[1]), int(t[2])])
    if fn["p"]:   # self-alignment PAF
        with _open(fn["p"]) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                bb[t[0]][1].setdefault("self", []).append(
                    [int(t[2]), int(t[3])])
    if fn["g"]:   # seqtk gap (N stretches)
        with _open(fn["g"]) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                bb[t[0]][1].setdefault("gap", []).append(
                    [int(t[1]), int(t[2])])
    if fn["c"]:   # dna-brnn centromeric repeats
        with _open(fn["c"]) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                anno = "hsat2/3" if t[3] == "1" else "alpha"
                st, en = int(t[1]), int(t[2])
                if en - st >= min_centro_len:
                    bb[t[0]][1].setdefault(anno, []).append([st, en])

    for key in bba:
        h, length = bb[key][1], bb[key][0]
        m = re.match(r"^(\S+)_(\d+)_(\d+)", key)
        if m is None:
            raise SystemExit("Bug!")
        t = [m.group(1), m.group(2), m.group(3)]
        if fn["b"]:
            t.extend(bb[key][2:10])
        else:
            t.append(length)
        x = {}
        for c in h:   # merged feature coverage
            s = sorted(h[c], key=lambda iv: iv[0])
            st = en = cov = 0
            for iv in s:
                if iv[0] > en:
                    cov += en - st
                    st, en = iv[0], iv[1]
                else:
                    en = max(en, iv[1])
            cov += en - st
            if cov >= min_feat_len:
                x[c] = cov
        type_ = "none"
        mx = mx2 = 0
        mx_c = mx_c2 = None
        tot = tot_misc = 0
        lcr = x.get("LCR", 0)
        self_len = x.get("self", 0)
        for c in x:
            if c in ("LCR", "self") or c.startswith("_"):
                continue
            tot += x[c]
            if c not in ("mini", "micro"):
                tot_misc += x[c]
            if mx < x[c]:
                mx2, mx_c2, mx, mx_c = mx, mx_c, x[c], c
            elif mx2 < x[c]:
                mx2, mx_c2 = x[c], c
        if mx >= length * 0.7:
            type_ = mx_c
        elif lcr >= length * 0.7:
            type_ = "lcr"
            if mx_c in ("mini", "micro"):
                y = x.get("mini", 0) + x.get("micro", 0)
                if mx >= y * 0.7:
                    type_ = mx_c
        elif mx_c in ("mini", "micro") and mx2 < mx * 0.1:
            type_ = mx_c
        elif x.get("_alu") is not None and x["_alu"] >= length * 0.7:
            type_ = "SINE/Alu"
        elif x.get("_l1") is not None and x["_l1"] >= length * 0.7:
            type_ = "LINE/L1"
        elif x.get("_inter") is not None and x["_inter"] >= length * 0.7:
            type_ = "inter"
        elif x.get("_sat") is not None and x["_sat"] >= length * 0.5:
            type_ = "Satellite"
        elif tot_misc + lcr >= length * 0.7:
            type_ = "mixed"
        elif tot + lcr > length * 0.05:
            type_ = "partial"
        elif self_len >= length * 0.5:
            type_ = "self"
        if type_ in ("partial", "self", "none", "mixed") and fn["b"]:
            if int(t[8]) >= 50 and int(t[10]) >= int(t[8]) * min_ld_frac:
                type_ = "ldust"
            if int(t[8]) >= 1000 and int(t[9]) >= int(t[8]) \
                    * min_segdup_frac:
                type_ = "segdup"
        t.append(type_)
        for c in x:
            t.append(f"{c}:{x[c]}")
        out.write("\t".join(str(v) for v in t) + "\n")
    return 0


_RE_CG = re.compile(r"(\d+)([MIDNSHP=X*])")
_RE_WALK = re.compile(r"([><])([^\s><]+):(\d+)-(\d+)")


def _js_num(v):
    """JS-style number stringification (ints without .0)."""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _js_join(arr):
    """JS Array.join("\\t"): nested arrays flatten with commas."""
    parts = []
    for v in arr:
        if isinstance(v, list):
            parts.append(",".join(
                ",".join(_js_num(w) for w in e) if isinstance(e, list)
                else _js_num(e) for e in v))
        else:
            parts.append(_js_num(v))
    return "\t".join(parts)


def cmd_genecopy(argv: List[str], out=None) -> int:
    """Gene copy analysis over gene-to-graph GAF
    (mg_cmd_genecopy, misc/mgutils.js:1250-1410)."""
    out = out or sys.stdout
    min_cov, min_rel_cov, mm, gapo = 0.8, 0.85, 4, 5
    max_prev_ovlp = 0.5
    opts, args = getopt.gnu_getopt(argv, "c:r:")
    for o, a in opts:
        if o == "-c":
            min_cov = float(a)
        elif o == "-r":
            min_rel_cov = float(a)
    if len(args) < 2:
        sys.stderr.write(
            "Usage: mgutils genecopy [options] <in.gaf> <src.bed>\n")
        return 1

    src = {}
    with _open(args[1]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            src[t[3]] = [t[0], int(t[1]), int(t[2]),
                         1 if t[5] == "+" else -1]

    gene, reg = {}, {}
    with _open(args[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if re.search(r"\|([A-Z]+\d*\.\d+|ENSG\d+)$", t[0]):
                continue
            ti = [int(t[i]) for i in (1, 2, 3)]
            t6 = [int(t[i]) for i in range(6, 12)]
            if ti[2] - ti[1] < ti[0] * min_cov:
                continue
            if t[0] in gene:
                g0 = gene[t[0]][0]
                if ti[2] - ti[1] < (g0[2] - g0[1]) * min_rel_cov:
                    continue
            cg = None
            for fld in t[12:]:
                if fld.startswith("cg:Z"):
                    cg = fld[5:]
            if cg is None:
                raise SystemExit("no cg")
            blen = mlen = sc = 0
            for m in _RE_CG.finditer(cg):
                ln = int(m.group(1))
                if m.group(2) == "=":
                    mlen += ln
                    blen += ln
                    sc += ln
                else:
                    blen += 1
                    if m.group(2) == "*":
                        sc -= mm
                    else:
                        sc -= gapo + ln
            de = (blen - mlen) / blen
            intv = []
            if t[5][0] in "><":
                ln = 0
                for m in _RE_WALK.finditer(t[5]):
                    st, en = int(m.group(3)), int(m.group(4))
                    ss, ee = st, en
                    if ln <= t6[1] < ln + en - st:
                        # segment-local offset kept as the reference
                        # computes it (mgutils.js:1320-1326)
                        if m.group(1) == ">":
                            ss = st + t6[1]
                        else:
                            ee = en - t6[1]
                    elif ln <= t6[2] < ln + en - st:
                        if m.group(1) == ">":
                            ee = st + t6[2] - ln
                        else:
                            ss = st + t6[0] - t6[2]
                    intv.append([m.group(2), ss, ee,
                                 1 if m.group(1) == ">" else -1])
                    ln += en - st
            else:
                intv.append([t[5], t6[1], t6[2],
                             1 if t[4] == "+" else -1])
            if t[0] not in gene:
                gene[t[0]] = []
            for x in intv:
                ok = True
                reg.setdefault(x[0], [])
                if t[0] in src:
                    y = src[t[0]]
                    if y[0] == x[0] and y[1] < x[2] and x[1] < y[2]:
                        ll = min(x[2], y[2]) - max(x[1], y[1])
                        if ll > (x[2] - x[1]) * 0.99:
                            ok = False
                reg[x[0]].append([x[1], x[2], 0, t[0], len(gene[t[0]]),
                                  ok, x[3]])
            gene[t[0]].append([ti[0], ti[1], ti[2], sc, de, intv])

    a = []
    for g in gene:
        for i, hit in enumerate(gene[g]):
            a.append([hit[3], g, i])
    a.sort(key=lambda v: -v[0])

    good_hit = []
    for x in a:
        h = gene[x[1]][x[2]]
        intv = h[5]
        cov_tot = len_tot = 0
        ovlp_gene = {}
        for y in intv:
            len_tot += y[2] - y[1]
            if y[0] not in reg:
                continue
            b = _it_overlap(reg[y[0]], y[1], y[2])
            cov_st = cov_en = cov = 0
            for bk in b:
                if bk[5] or bk[6] != y[3]:
                    continue
                ovlp_gene[bk[3]] = 1
                st1, en1 = max(bk[0], y[1]), min(bk[1], y[2])
                if st1 > cov_en:
                    cov += cov_en - cov_st
                    cov_st, cov_en = st1, en1
                else:
                    cov_en = max(cov_en, en1)
            cov += cov_en - cov_st
            cov_tot += cov
        if ovlp_gene:
            out.write("OG\t%s\t%s\t%s\t%s\t%s\n"
                      % (x[1], x[2], cov_tot, len_tot,
                         ",".join(ovlp_gene)))
        if cov_tot < len_tot * max_prev_ovlp:
            good_hit.append([x[1], x[2]])
            for y in intv:
                if y[0] not in reg:
                    continue
                for bk in _it_overlap(reg[y[0]], y[1], y[2]):
                    if bk[3] == x[1] and bk[4] == x[2]:
                        bk[5] = False

    counts = {g: [len(gene[g]), 0] for g in gene}
    for g, i in good_hit:
        out.write("GH\t%s\t%s\n" % (g, _js_join(gene[g][i])))
        counts[g][1] += 1
    for g in counts:
        out.write("GC\t%s\t%d\t%d\n" % (g, counts[g][0], counts[g][1]))
    return 0
