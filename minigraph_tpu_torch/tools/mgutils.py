"""Offline post-processing utilities (ports of misc/mgutils.js `merge`
and misc/mgutils-es6.js `merge2vcf`), and the command table of all
sixteen mgutils subcommands.

Cookbook chain (minigraph's README.md:142-163):
  per-sample `--call` BEDs -> `paste *.bed | mgutils merge -` ->
  `mgutils merge2vcf merged.bed > out.vcf`

Run:  python -m minigraph_tpu_torch.tools.mgutils <command> [args]

Host code with no device part; its output is byte for byte the JAX
package's tools' (minigraph_tpu/tools/mgutils*.py).  Each command
writes to `out` (sys.stdout when None) and reads gzip or plain files,
or stdin for "-".
"""
from __future__ import annotations

import getopt
import re
import sys
from typing import List, Optional


def _open(fn):
    if fn == "-":
        return sys.stdin
    import gzip
    with open(fn, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(fn, "rt")
    return open(fn)


def cmd_merge(argv: List[str], out=None) -> int:
    """Merge pasted per-sample --call BEDs (mgutils.js:1041-1148)."""
    out = out or sys.stdout
    opts, args = getopt.gnu_getopt(argv, "a:s:")
    fn_anno = fn_sample = None
    for k, v in opts:
        if k == "-a":
            fn_anno = v
        elif k == "-s":
            fn_sample = v
    if not args:
        sys.stderr.write("Usage: paste *.bed | mgutils merge -\n")
        return 1
    anno = {}
    anno_len = {}
    if fn_anno:
        with _open(fn_anno) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                key = "_".join(t[:3])
                anno[key] = t[11]
                totbb, segdup, ldust = int(t[8]), int(t[9]), int(t[10])
                if totbb > 0:
                    anno_len[key] = (totbb, segdup, ldust)
    hdr = ["#CHROM", "START", "END", "INFO", "FORMAT"]
    if fn_sample:
        with _open(fn_sample) as f:
            for line in f:
                hdr.append(line.split()[0])
    w = out.write
    w('##INFO=<ID=NS,Number=1,Type=Integer,Description="Number of samples'
      ' with data">\n')
    w('##INFO=<ID=NA,Number=1,Type=Integer,Description="Number of alleles">\n')
    w('##INFO=<ID=AC,Number=.,Type=Integer,Description="Allele count">\n')
    w('##INFO=<ID=ALEN,Number=.,Type=Integer,Description="Length of each'
      ' allele">\n')
    w('##INFO=<ID=ANNO,Number=1,Type=String,Description="Annotation">\n')
    w('##INFO=<ID=VS,Number=1,Type=String,Description="Start vertex">\n')
    w('##INFO=<ID=VE,Number=1,Type=String,Description="End vertex">\n')
    w('##INFO=<ID=AWALK,Number=.,Type=String,Description="Walk of each'
      ' allele">\n')
    w('##INFO=<ID=LBUBBLE,Number=1,Type=Integer,Description="Total sequence'
      ' length in the bubble">\n')
    w('##INFO=<ID=LSEGDUP,Number=1,Type=Integer,Description="Length of'
      ' segdup">\n')
    w('##INFO=<ID=LDUST,Number=1,Type=Integer,Description="Length of'
      ' low-complex regions">\n')
    w('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
    w('##FORMAT=<ID=CSTRAND,Number=1,Type=String,Description="Contig'
      ' strand">\n')
    w('##FORMAT=<ID=CTG,Number=1,Type=String,Description="Contig name">\n')
    w('##FORMAT=<ID=CS,Number=1,Type=String,Description="Contig start,'
      ' BED-like">\n')
    w('##FORMAT=<ID=CE,Number=1,Type=String,Description="Contig end,'
      ' BED-like">\n')
    w("\t".join(hdr) + "\n")
    with _open(args[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            a = [t[0], t[1], t[2], "", "GT:CSTRAND:CTG:CS:CE"]
            ah = {}
            aa = []
            b = []
            ns = 0
            for j in range(5, len(t), 6):
                if t[j] == ".":
                    b.append(["."])
                    continue
                ns += 1
                s = t[j].split(":")
                if s[0] not in ah:
                    ah[s[0]] = len(aa)
                    aa.append({"walk": s[0], "len": s[1], "cnt": 0})
                k = ah[s[0]]
                aa[k]["cnt"] += 1
                s[0] = k
                b.append(s)
            for i, item in enumerate(aa):
                item["i"] = i
            aa.sort(key=lambda x: -x["cnt"])  # stable, like V8 sort
            i2a = [0] * len(aa)
            alen, awalk, ac = [], [], []
            for i, item in enumerate(aa):
                i2a[item["i"]] = i
                alen.append(item["len"])
                awalk.append(item["walk"])
                ac.append(str(item["cnt"]))
            for bj in b:
                if bj[0] != ".":
                    i = bj.pop(0)
                    bj.insert(0, str(i2a[i]))
                    a.append(":".join(str(x) for x in bj))
                else:
                    a.append(".")
            info = [f"NS={ns}", f"NA={len(aa)}",
                    "ALEN=" + ",".join(alen), "AC=" + ",".join(ac)]
            key = "_".join(t[:3])
            if key in anno:
                info.append("ANNO=" + anno[key])
            if key in anno_len:
                info.append(f"LBUBBLE={anno_len[key][0]}")
                info.append(f"LSEGDUP={anno_len[key][1]}")
                info.append(f"LDUST={anno_len[key][2]}")
            info.append("VS=" + t[3])
            info.append("VE=" + t[4])
            info.append("AWALK=" + ",".join(awalk))
            a[3] = ";".join(info)
            w("\t".join(a) + "\n")
    return 0


def cmd_merge2vcf(argv: List[str], out=None) -> int:
    """Convert merge BED output to VCF (mgutils-es6.js:93-205)."""
    out = out or sys.stdout
    opts, args = getopt.gnu_getopt(argv, "r:a:s:")
    ref_index = 0
    max_allele = 15
    fn_sample = None
    for k, v in opts:
        if k == "-r":
            ref_index = int(v)
        elif k == "-a":
            max_allele = int(v)
        elif k == "-s":
            fn_sample = v
    if not args:
        sys.stderr.write("Usage: mgutils merge2vcf [options] <in.bed>\n")
        return 1
    samples = []
    if fn_sample:
        with _open(fn_sample) as f:
            for line in f:
                samples.append(line.split()[0])
    hdr = ["##fileformat=VCFv4.2",
           '##ALT=<ID=CNV,Description="description">',
           '##FORMAT=<ID=GT0,Number=1,Type=String,Description="Original'
           ' genotype">']
    for i in range(1, max_allele + 1):
        hdr.append(f'##ALT=<ID=X:{i},Description="Allele {i}">')
    n_sample = len(samples)
    w = out.write
    with _open(args[0]) as f:
        for raw in f:
            line = raw.rstrip("\n")
            if line.startswith("##"):
                hdr.append(line)
            elif line.startswith("#"):
                t = line.split("\t")
                a = ["CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER",
                     "INFO", "FORMAT"]
                if len(t) <= 5:
                    if not samples:
                        raise ValueError(
                            "No samples found. Provide names with -s")
                    a.extend(samples)
                else:
                    a.extend(t[5:])
                for h in hdr:
                    w(h + "\n")
                w("#" + "\t".join(a) + "\n")
            else:
                t = line.split("\t")
                if n_sample == 0:
                    n_sample = len(t) - 5
                if n_sample != len(t) - 5:
                    raise ValueError("different number of samples")
                a = [t[0], t[1], ".", "N", "", "30", "PASS"]
                # -r picks the reference sample's column; a "." there
                # leaves ref at -1 and the alleles unrotated
                ref = -1
                m = re.match(r"^(\d+)", t[5 + ref_index])
                if m:
                    ref = int(m.group(1))
                m = re.search(r"\bNA=(\d+)", t[3])
                if m is None:
                    raise ValueError("No NA tag")
                na = int(m.group(1))
                a2v = list(range(na))
                if ref >= 0:
                    for i in range(ref):
                        a2v[i] = i + 1
                    a2v[ref] = 0
                al = [f"<X:{i}>" for i in range(1, min(na - 1, max_allele) + 1)]
                a[4] = ",".join(al) if al else "."
                info = [f"END={t[2]}"]
                for m in re.finditer(r"([^\s=;]+)=([^\s=;]+)", t[3]):
                    tag, val = m.group(1), m.group(2)
                    if tag in ("ALEN", "AWALK", "AC"):
                        s = val.split(",")
                        if len(s) != na:
                            raise ValueError("Inconsistent number of alleles")
                        if tag == "AC":
                            p = [s[i] for i in range(len(s)) if a2v[i] != 0]
                        else:
                            p = [""] * na
                            for i in range(len(s)):
                                p[a2v[i]] = s[i]
                        if tag != "AC" or p:
                            info.append(f"{tag}={','.join(p)}")
                    elif tag == "NS":
                        info.append(f"AN={val}")
                        info.append(f"NS={val}")
                    else:
                        info.append(f"{tag}={val}")
                a.append(";".join(info))
                a.append("GT:GT0")
                for i in range(5, len(t)):
                    if t[i] == ".":
                        a.append(".")
                    else:
                        m = re.match(r"^(\d+)(\S*)", t[i])
                        if m:
                            al_i = a2v[int(m.group(1))]
                            al_cap = al_i if al_i < max_allele else max_allele
                            a.append(f"{al_cap}:{al_i}")
                w("\t".join(a) + "\n")
    return 0


def commands():
    """Every subcommand by name (misc/mgutils.js:1437-1449 and
    misc/mgutils-es6.js:306-308)."""
    from . import mgutils2 as m2
    from . import mgutils3 as m3
    return {
        "merge": cmd_merge,
        "merge2vcf": cmd_merge2vcf,
        "anno": m3.cmd_anno,
        "genecopy": m3.cmd_genecopy,
        "renamefa": m2.cmd_renamefa,
        "joinfa": m2.cmd_joinfa,
        "paf2bl": m2.cmd_paf2bl,
        "stableGaf": m2.cmd_stable_gaf,
        "subgaf": m2.cmd_subgaf,
        "sveval": m2.cmd_sveval,
        "extractseg": m2.cmd_extractseg,
        "anno2tbl": m2.cmd_anno2tbl,
        "addsample": m2.cmd_addsample,
        "getlcr": m2.cmd_getlcr,
        "bed2sql": m2.cmd_bed2sql,
        "segfreq": m2.cmd_segfreq,
    }


def main(argv: Optional[List[str]] = None) -> int:
    table = commands()
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        names = "  ".join(sorted(table))
        sys.stderr.write(
            "Usage: mgutils <command> [args]\n"
            f"Commands:\n  {names}\n")
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd in table:
        return table[cmd](rest)
    sys.stderr.write(f"ERROR: unknown command '{cmd}'\n")
    return 1


if __name__ == "__main__":
    sys.exit(main())
