"""The port's offline tools (minigraph_tpu_torch/tools/mgutils{,2,3}.py)
against the JAX package's: all sixteen mgutils subcommands on the same
argument lists, in process, with stdout, stderr and the return code
equal (or the same exception type and message where a command raises),
and the command line `python -m ...tools.mgutils` in subprocesses
(usage, unknown command, stdin, gzip, an exception's last line).

Inputs are built here: the GAF, -S and --write-mz dumps and the --call
BEDs come from the port's own command line on a tools/synth.py bubble
graph augmented with one sample (-cxggs); PAF, VCF, FASTA and the
annotator outputs (RepeatMasker .out, etrf, sdust, seqtk gap,
dna-brnn, gfatools bubble, segdup and longdust coverage) are text
written from numpy seed 1313, in the shapes tests/test_mgutils3.py
uses.  Tolerance: exact equality."""
import contextlib
import gzip
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from minigraph_tpu.tools import mgutils as jax_m1
from minigraph_tpu.tools import mgutils2 as jax_m2
from minigraph_tpu_torch import cli
from minigraph_tpu_torch.tools import mgutils, mgutils2
from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                             make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = 1313
JAX_CMDS = {"merge": jax_m1.cmd_merge, "merge2vcf": jax_m1.cmd_merge2vcf,
            **jax_m2.COMMANDS}
PORT_CMDS = mgutils.commands()
COMP = str.maketrans("ACGTN", "TGCAN")


def port_run(argv, out_path):
    with contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["-t1", "--device", "none", "-o", out_path] + argv)
    assert rc == 0


def seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def text_inputs(d: Path, rng):
    """The seeded text inputs; returns {name: path}."""
    f = {}

    def put(name, text, gz=False):
        p = d / name
        if gz:
            with gzip.open(p, "wt") as fh:
                fh.write(text)
        else:
            p.write_text(text)
        f[name] = str(p)

    # FASTA (renamefa, joinfa): names with and without PanSN prefixes,
    # empty and short records
    lines = []
    for i in range(14):
        name = ["ctg{i}", "old#ctg{i}", "a#1#ctg{i} desc"][i % 3]
        s = seq(rng, int(rng.integers(0, 400)) if i != 5 else 0)
        lines.append(">" + name.format(i=i))
        lines += [s[j:j + 60] for j in range(0, len(s), 60)]
    put("in.fa", "\n".join(lines) + "\n")
    put("in.fa.gz", "\n".join(lines) + "\n", gz=True)

    # PAF (paf2bl): tp:A:S/I/P, de:f present or not, short lines
    rows = []
    for i in range(300):
        qlen = int(rng.integers(300, 5000))
        qs = int(rng.integers(0, qlen // 2))
        blen = int(rng.integers(200, 3000))
        t = [f"q{i}", qlen, qs, qs + blen // 2, "+-"[i % 2],
             f"t{int(rng.integers(3))}", 100000,
             int(rng.integers(0, 50000)), 0, blen - 50, blen,
             int(rng.integers(0, 61))]
        t[8] = t[7] + blen
        tags = [f"tp:A:{rng.choice(list('PSI'))}"] if rng.random() < .7 else []
        if rng.random() < 0.9:
            de = rng.choice([0.001, 0.0015, 0.005, 0.02, 0.08, 0.2])
            tags.append(f"de:f:{de}")
        rows.append("\t".join(map(str, t[:12 if i % 29 else 9] + tags)))
    put("in.paf", "\n".join(rows) + "\n")

    # sveval: truth VCF, confident BED, calls
    vcf = ["##fileformat=VCFv4.2",
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS"]
    for i in range(120):
        ctg = rng.choice(["chr1", "chr2", "chrX", "chr3"])
        ref = seq(rng, int(rng.choice([1, rng.integers(2, 400)])))
        n_alt = int(rng.integers(1, 3))
        alts = [seq(rng, int(rng.choice([1, rng.integers(2, 400)])))
                for _ in range(n_alt)]
        gt = rng.choice(["0/1", "1/1", "1|0", "./1", "0/0", "."]
                        + (["1/2"] if n_alt > 1 else []))
        vcf.append("\t".join([ctg, str(int(rng.integers(1, 200000))),
                              f"v{i}", ref, ",".join(alts), ".",
                              rng.choice(["PASS", ".", "LowQual"]), ".",
                              "GT:DP", f"{gt}:30"]))
    # next to the gap in chr1's confident regions: not contained
    vcf.append("chr1\t149990\tgap\tA\t" + "A" * 300 + "\t.\tPASS\t.\tGT\t1/1")
    vcf.append("chr1\t5\tshort\tA\tC")
    put("true.vcf", "\n".join(vcf) + "\n")
    put("conf.bed", "chr1\t0\t150000\nchr1\t160000\t200000\n"
        "chr2\t0\t200000\nchrX\t0\t200000\nchrY\t0\t1000\nshort\n")
    calls = []
    for i in range(120):
        ctg = rng.choice(["chr1", "chr2", "chrX", "chr4"])
        st = int(rng.integers(0, 199000))
        alts = ["*" if rng.random() < .2
                else seq(rng, int(rng.integers(1, 400)))
                for _ in range(int(rng.integers(1, 3)))]
        en = st + int(rng.integers(1, 500))
        ref = "*" if rng.random() < .3 else seq(rng, int(rng.integers(1, 300)))
        calls.append("\t".join([ctg, str(st), str(en),
                                str(int(rng.integers(0, 60))), ".", ".", ".",
                                ref] + alts))
    calls.append("chr1\t149950\t150010\t50\t.\t.\t.\t*\t" + "C" * 300)
    calls.append("chr1\t1\t2")
    put("calls.txt", "\n".join(calls) + "\n")

    # anno: bubbles (key = ctg_st_en, event length), the annotators'
    # outputs keyed by bubble, gfatools bubble with segdup/longdust
    keys, bed, bub, segdup, ld = [], [], [], [], []
    for i in range(48):
        ctg = f"chr{1 + i % 3}"
        st = 1000 * i
        en = st + int(rng.choice([0, rng.integers(1, 400)]))
        ln = max(en - st, int(rng.choice([60, 300, 1500, 5000])))
        keys.append((f"{ctg}_{st}_{en}", ln))
        bed.append(f"{ctg}\t{st}\t{en}\t{ln}")
        names = [f"b{i}s{j}" for j in range(int(rng.integers(3, 6)))]
        if i == 0:   # a segment listed twice
            names.insert(2, names[1])
        bub.append("\t".join([ctg, str(st), str(en)]
                             + [str(int(rng.integers(0, 9)))
                                for _ in range(8)] + [",".join(names)]))
        # segdup and longdust coverage: name, rank, length, covered
        for j, nm in enumerate(names[1:-1]):
            sl = int(rng.integers(10, 3000))
            row = f"{ctg}\t{st}\t{st + sl}\t{nm}\t{int(j > 0 or i % 2)}\tx"
            for dst, p in ((segdup, .8), (ld, .6)):
                if rng.random() < p:
                    dst.append(f"{row}\t{int(rng.integers(0, sl + 1))}")
    # bubbles of 1 kb for the cascade's branches (rm: name, class,
    # divergence, start, end; self: the self-alignment): two Alu
    # classes, LINE/L1 with L1HS (LINE/L1HS under -m), DNA with LTR,
    # snRNA with dust, self only, a young AluY (-m)
    special = [[("AluSx", "SINE/AluS", 12.0, 0, 400),
                ("AluY", "SINE/AluT", 12.0, 500, 900)],
               [("L1HS", "LINE/L1", 0.5, 0, 400),
                ("L1PA2", "LINE/L1", 12.0, 500, 900)],
               [("Tigger1", "DNA/TcMar", 12.0, 0, 400),
                ("LTR12", "LTR/Gypsy", 12.0, 500, 900)],
               [("U6", "snRNA", 12.0, 0, 400)], [],
               [("AluYa5", "SINE/Alu", 0.5, 0, 900)], []]
    rm = []
    for i, feats in enumerate(special):
        key = f"chr9_{i}_{i}"
        keys.append((key, 1000))
        bed.append(f"chr9\t{i}\t{i}\t1000")
        bub.append(f"chr9\t{i}\t{i}\t" + "\t".join(["1"] * 8)
                   + f"\tx,ld{i},y")
        for name, cls, div, a, b in feats:
            rm.append(f"900 {div} 0.0 0.0 {key} {a + 1} {b} (0) + {name} "
                      f"{cls} 1 {b - a} (0) 1")
    # the last one's inner segment lies in the longdust file alone, on
    # the reference and covered whole: ldust
    ld.append("chr9\t0\t500\tld6\t0\tx\t500")
    bed.append("short\tline")
    bub.append("chr8\t1\t2\t" + "\t".join(["1"] * 8) + "\tx,y,z")
    put("bub.in.bed", "\n".join(bed) + "\n")
    put("bubble.txt", "\n".join(bub) + "\n")
    put("segdup.bed", "\n".join(segdup) + "\n")
    put("ld.bed", "\n".join(ld) + "\n")

    def ivs(ln, n):
        for _ in range(n):
            a = int(rng.integers(0, max(1, ln)))
            b = a + int(max(1, rng.choice([0.05, 0.3, 0.75, 0.95]) * ln))
            yield a, b

    etrf, dust, gap, brnn = [], ["chr9_3_3\t500\t850"], [], []
    paf = ["chr9_4_4\t1000\t0\t600\t+\tt\t9"]
    rm_kinds = [("ALR/Alpha", "Satellite/centr"), ("HSATII", "Satellite"),
                ("MER4", "LTR/ERVL"), ("LTR12", "LTR/Gypsy"),
                ("Tigger1", "DNA/TcMar"), ("U6", "snRNA"), ("L2a", "LINE/L2"),
                ("L1HS", "LINE/L1"), ("L1PA2", "LINE/L1"),
                ("AluYa5", "SINE/Alu"), ("AluSx", "SINE/Alu"),
                ("(GGAAT)n", "Simple_repeat"), ("(ATTCC)n", "Satellite"),
                ("(GGAATGGAAT)n", "Simple_repeat"),
                ("(GGAATGGAATGGAAT)n", "Simple_repeat"),
                ("(GGAATGGACT)n", "Simple_repeat"),
                ("(GGACTGGAAT)n", "Satellite"), ("(CA)n", "Simple_repeat"),
                ("A-rich", "Low_complexity"), ("SVA_D", "Retroposon/SVA"),
                ("MIR", "SINE/MIR"), ("Charlie1", "DNA")]
    for key, ln in keys[:48]:
        kind = int(rng.integers(0, 6))
        for a, b in ivs(ln, int(rng.integers(0, 3))):
            period = int(rng.choice([1, 2, 3, 6, 7, 20]))
            etrf.append(f"{key}\t{a}\t{b}\tAAT\t{period}\t9")
        if kind == 1:
            for a, b in ivs(ln, 2):
                dust.append(f"{key}\t{a}\t{b}")
        if kind in (2, 3):
            for a, b in ivs(ln, 1):
                paf.append(f"{key}\t{ln}\t{a}\t{b}\t+\tt\t9")
        if kind == 3:
            for a, b in ivs(ln, 1):
                gap.append(f"{key}\t{a}\t{b}")
        if kind in (4, 5):
            for a, b in ivs(ln, 2):
                brnn.append(f"{key}\t{a}\t{b}\t{rng.choice(['1', '2'])}")
        for a, b in ivs(ln, int(rng.integers(0, 4))):
            name, cls = rm_kinds[int(rng.integers(len(rm_kinds)))]
            rm.append(" ".join([str(int(rng.integers(200, 3000))),
                                f"{rng.choice([0.5, 1.5, 12.0])}", "0.0",
                                "0.0", key, str(a + 1), str(b), "(0)", "+",
                                name, cls, "1", str(b - a), "(0)", "1"]))
    rm.insert(3, "")
    rm.insert(5, "short line")
    put("etrf.txt", "\n".join(etrf) + "\n")
    put("dust.txt", "\n".join(dust) + "\n")
    put("self.paf", "\n".join(paf) + "\n")
    put("gap.txt", "\n".join(gap) + "\n")
    put("brnn.txt", "\n".join(brnn) + "\n")
    put("rm.out", "\n".join(rm) + "\n")
    put("bad.bed", "chr1\t100\t300\t150\n")
    put("empty.out", "")
    put("rm_missing.out",
        "1 1.0 0 0 chr9_1_2 1 50 (0) + L1HS LINE/L1 1 50 (0) 1\n")

    # genecopy: gene-to-graph hits, walk and contig paths, names that
    # are skipped, the source loci
    gaf, src = [], []
    for gi in range(10):
        g = f"gene{gi}" + ("|ENSG0001" if gi == 7 else "|NM_1.2" if gi == 8
                           else "")
        qlen = int(rng.integers(300, 2000))
        src.append(f"chr1\t{10000 * gi}\t{10000 * gi + qlen}\t{g}\t0\t"
                   f"{rng.choice(['+', '-'])}")
        for h in range(int(rng.integers(1, 5))):
            qs = int(rng.integers(0, qlen // 5))
            qe = qlen - int(rng.integers(0, qlen // 4))
            blen = qe - qs
            n_x = int(rng.integers(0, 4))
            cg = (f"{blen - n_x - 3}=" + f"{n_x}*" * (n_x > 0) + "2I1="
                  if h % 2 else f"{blen}=")
            if h == 0 or rng.random() < .4:
                base = 10000 * gi + (0 if h == 0 else int(rng.integers(0, 20)))
                path, plen, ps = "chr1", 400000, base
                strand = rng.choice(["+", "-"])
            else:
                parts, x = [], 0
                for k in range(int(rng.integers(1, 4))):
                    st = int(rng.integers(0, 500))
                    sl = int(rng.integers(200, 900))
                    ori = rng.choice(['>', '<'])
                    parts.append(f"{ori}g{gi}s{k}:{st}-{st + sl}")
                    x += sl
                path, plen, strand = "".join(parts), x, "+"
                ps = int(rng.integers(0, max(1, x - blen)))
            gaf.append("\t".join(map(str, [g, qlen, qs, qe, strand, path, plen,
                                           ps, ps + blen, blen - n_x, blen, 60,
                                           "tp:A:P", f"cg:Z:{cg}"])))
    # a second hit that covers 82% of the gene: above -c, below -r of
    # the first hit's cover
    gaf += [f"geneR\t1000\t0\t{ln}\t+\tchr2\t9000\t{st}\t{st + ln}\t{ln}"
            f"\t{ln}\t60\tcg:Z:{ln}=" for st, ln in ((0, 1000), (3000, 820))]
    put("genes.gaf", "\n".join(gaf) + "\n")
    put("src.bed", "\n".join(src) + "\n")
    put("nocg.gaf", "g\t100\t0\t100\t+\tchr1\t1000\t0\t100\t100\t100\t60\n")

    # a pasted BED of four samples, PanSN contig names, varied alleles
    rows = []
    for i in range(40):
        ctg = rng.choice(["HG1#1#chr1", "chr2"])
        st = 500 * i
        en = st + int(rng.integers(0, 300))
        base = f"{ctg}\t{st}\t{en}\t>s{i}\t>s{i + 1}"
        cols = []
        walks = ["*", f">a{i}", f">a{i}>b{i}", f">c{i}"]
        for s in range(4):
            if rng.random() < .1 or (i, s) in ((3, 0), (4, 1)):
                cols.append(base + "\t.")
                continue
            k = int(rng.integers(0, 4))
            strand = rng.choice(['+', '-'])
            cols.append(base + f"\t{walks[k]}:{100 * k}:{strand}"
                        f":ctg{s}:{st}:{st + 100 * k}")
        rows.append("\t".join(cols))
    put("pasted4.bed", "\n".join(rows) + "\n")
    put("samples4.txt", "A\nB extra\nC\nD\n")
    annos = ["lcr", "mini", "micro", "ldust", "segdup", "LINE/L1", "none",
             "Satellite"]
    anno = []
    for r in rows:
        t = r.split("\t")
        tot = int(rng.choice([0, 100, 1000]))
        anno.append("\t".join(t[:3] + ["0"] * 5 + [
            str(tot), str(int(rng.integers(0, tot + 1))),
            str(int(rng.integers(0, tot + 1))),
            annos[int(rng.integers(len(annos)))]]))
    put("anno4.tsv", "\n".join(anno) + "\n")
    put("samples2.txt", "A\nB\n")
    # gfa2bed and gfatools bubble for pasted4's segments: the flanks
    # s<i> (rank 0) and the alleles a<i>, b<i>, c<i>
    g2b, bub4 = [], []
    for i, r in enumerate(rows):
        t = r.split("\t")
        for j, nm in enumerate((f"a{i}", f"b{i}", f"c{i}")):
            g2b.append(f"{t[0]}\t{t[1]}\t{int(t[1]) + 10 * j + 5}\t{nm}\t"
                       f"{int(rng.integers(0, 3))}")
        bub4.append("\t".join(t[:3] + ["5"] * 8
                               + [f"s{i},a{i},b{i},c{i},s{i + 1}"]))
    g2b += [f"chr2\t{i}\t{i + 1}\ts{i}\t0" for i in range(41)]
    put("g2b4.bed", "\n".join(g2b) + "\n")
    put("g2b4_miss.bed", "\n".join(x for x in g2b if "\ta0\t" not in x)
        + "\n")
    put("bub4.txt", "\n".join(bub4) + "\n")
    put("bub4_miss.txt", "chr9\t0\t1\t" + "\t".join(["5"] * 8) + "\ts0,s1\n")
    put("bub4_badseg.txt", bub4[0].rsplit("\t", 1)[0] + "\ts0,zz,s1\n")
    # an -S dump: per record, the segments' first and last hits decide
    # (equal starts, A again after B, B again after A, A then B, B then
    # A, a record below -l, a zero-count line, a record with A only)
    dump = []
    for name, hits in (("r1", [("A", 100), ("B", 100)]),
                       ("r2", [("A", 10), ("B", 50), ("A", 80)]),
                       ("r3", [("B", 10), ("A", 50), ("B", 80)]),
                       ("r4", [("A", 10), ("B", 50)]),
                       ("r5", [("B", 10), ("A", 50)]),
                       ("r6", [("A", 1), ("B", 5)]),
                       ("r7", [("A", 10), ("B", 50, "0")]),
                       ("r8", [("A", 10)])):
        span = 5 if name == "r6" else 500
        dump.append(f"{name}\t600\t0\t{span}\t+\tchr1\t900\t0\t{span}"
                    f"\t9\t9\t60")
        for h in hits:
            dump.append(f"*\t>{h[0]}\t100\t{h[2] if len(h) > 2 else 7}"
                        f"\t0.01\t0\t10\t{h[1]}\t{h[1] + 10}")
    put("craft.S.gaf", "\n".join(dump) + "\n")
    return f


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mgutils")
    rng = np.random.default_rng(SEED)
    f = text_inputs(d, rng)
    ref = make_reference(200_000, seed=131)
    hap = write_bubble_rgfa(ref, 132, str(d / "g.gfa"), seg_len=20_000)
    for i, sd in enumerate((133, 135, 137)):
        ctg = cut_contigs(make_haplotype(ref, sd, sv_per_mb=40), sd + 1,
                          mean_len=15000, min_len=4000, max_len=30000)
        if i == 2:   # every other contig reverse-complemented
            ctg = [(n, s[::-1].translate(COMP) if k % 2 else s)
                   for k, (n, s) in enumerate(ctg)]
        write_fasta(str(d / f"s{i}.fa"), ctg)
    # the contigs of the graph's own sample (paths through its inserted
    # segments) and those of sample 2, half of them reverse-complemented
    (d / "asm.fa").write_text((d / "s0.fa").read_text()
                              + (d / "s2.fa").read_text())
    write_fasta(str(d / "r.fa"),
                simulate_reads([hap, ref], 40, seed=139, mean_len=3000,
                               min_len=500, max_len=6000))
    gg = str(d / "gg.gfa")
    port_run(["-cxggs", "-l5k", "-d5k", str(d / "g.gfa"), str(d / "s0.fa")],
             gg)
    f["gg.gfa"] = gg
    for i in range(3):
        port_run(["-cxasm", "--call", "-l5k", gg, str(d / f"s{i}.fa")],
                 str(d / f"call{i}.bed"))
    rows = [open(d / f"call{i}.bed").read().splitlines() for i in range(3)]
    assert len({len(r) for r in rows}) == 1 and rows[0]
    (d / "pasted.bed").write_text(
        "\n".join("\t".join(p) for p in zip(*rows)) + "\n")
    with gzip.open(d / "pasted.bed.gz", "wt") as fh:
        fh.write((d / "pasted.bed").read_text())
    (d / "samples.txt").write_text("s0\ns1\ns2\n")
    for name in ("pasted.bed", "pasted.bed.gz", "samples.txt"):
        f[name] = str(d / name)
    for name, argv in (("vc.gaf", ["--vc", gg, str(d / "r.fa")]),
                       ("stable.gaf", [gg, str(d / "r.fa")]),
                       ("vc_asm.gaf", ["-xasm", "--vc", gg,
                                       str(d / "asm.fa")]),
                       ("stable_asm.gaf", ["-xasm", gg, str(d / "asm.fa")]),
                       ("S.gaf", ["-xasm", "-S", gg, str(d / "asm.fa")]),
                       ("mz.gaf", ["-xasm", "--write-mz", gg,
                                   str(d / "s1.fa")])):
        port_run(argv, str(d / name))
        f[name] = str(d / name)
    # merged BEDs (the JAX tool's output: the port's is held to it below)
    for name, argv in (("merged.bed", ["-s", f["samples.txt"],
                                       f["pasted.bed"]]),
                       ("merged_nos.bed", [f["pasted.bed"]]),
                       ("merged4.bed", ["-a", f["anno4.tsv"], "-s",
                                        f["samples4.txt"],
                                        f["pasted4.bed"]])):
        buf = io.StringIO()
        assert jax_m1.cmd_merge(argv, out=buf) == 0
        (d / name).write_text(buf.getvalue())
        f[name] = str(d / name)
    (d / "merged_noac.bed").write_text(
        re.sub(r";AC=[^;]*", "", (d / "merged.bed").read_text()))
    (d / "merged_nona.bed").write_text(
        re.sub(r"NA=\d+;", "", (d / "merged_nos.bed").read_text()))
    m4 = (d / "merged4.bed").read_text().split("\n")
    first = next(k for k, x in enumerate(m4) if x and x[0] != "#")
    odd = list(m4)
    odd[first] = re.sub(r"ALEN=[^;]*;", "", odd[first])
    (d / "merged4_odd.bed").write_text("\n".join(odd))
    odd = list(m4)
    odd[first] = re.sub(r"(ALEN=[^;]*)", r"\1,9", odd[first])
    (d / "merged4_badalen.bed").write_text("\n".join(odd))
    odd = list(m4)
    odd[first] = re.sub(r"(AC=[^;]*)", r"\1,9", odd[first])
    (d / "merged4_badac.bed").write_text("\n".join(odd))
    for name in ("merged4_odd.bed", "merged4_badalen.bed",
                 "merged4_badac.bed"):
        f[name] = str(d / name)
    (d / "vc_unmapped.gaf").write_text(
        (d / "vc.gaf").read_text()
        + "q\t100\t*\t*\t*\t*\t*\t*\t*\t*\t*\t255\n")
    f["vc_unmapped.gaf"] = str(d / "vc_unmapped.gaf")
    f["merged_noac.bed"] = str(d / "merged_noac.bed")
    f["merged_nona.bed"] = str(d / "merged_nona.bed")
    # gfatools gfa2bed of the graph (segfreq): SN, SO, SO+LN, name, SR
    g2b = []
    for ln in open(gg):
        if ln.startswith("S\t"):
            t = ln.rstrip("\n").split("\t")
            tag = dict(x.split(":", 2)[::2] for x in t[3:])
            so, sl = int(tag["SO"]), int(tag["LN"])
            g2b.append(f"{tag['SN']}\t{so}\t{so + sl}\t{t[1]}\t{tag['SR']}")
    (d / "gfa2bed.bed").write_text("\n".join(g2b) + "\n")
    # gfatools bubble over the called bubbles: the flanks and every
    # segment of the calls' walks
    bub = []
    for k, r in enumerate(rows[0]):
        t = r.split("\t")
        inner = []
        for w in sorted({rr[k].split("\t")[5].split(":")[0] for rr in rows}):
            inner += [m for m in re.findall(r"[><]([^><]+)", w)
                      if m not in inner]
        bub.append("\t".join(t[:3] + [str(len(inner) + 2), "2"] + ["0"] * 6
                             + [",".join([t[3][1:]] + inner + [t[4][1:]])]))
    (d / "callbub.txt").write_text("\n".join(bub) + "\n")
    for name in ("gfa2bed.bed", "callbub.txt"):
        f[name] = str(d / name)
    # anno with gfatools bubble input: anno2tbl's input (12+ columns),
    # with the lines anno2tbl skips
    buf = io.StringIO()
    assert jax_m2.COMMANDS["anno"](
        ["-b", f["bubble.txt"], "-s", f["segdup.bed"], "-x", f["ld.bed"],
         "-e", f["etrf.txt"], "-r", f["rm.out"], "-d", f["dust.txt"],
         f["bub.in.bed"]], out=buf) == 0
    extra = ("chrUn_1\t0\t1\t1\t1\t1\t1\t1\t5\t0\t0\tlcr\n"
             "chr1_random\t0\t1\t1\t1\t1\t1\t1\t5\t0\t0\tlcr\n"
             "chr1\t0\t1\t1\t1\t1\t1\t1\t5\t0\t0\tgap\n"
             "chr1\t0\t1\t1\t9\t1\t1\t1\t-1\t0\t0\tmini\nchr1\t0\n")
    for i, c in enumerate(["mini", "micro", "lcr", "LINE/L1", "LINE/L1HS",
                           "SINE/Alu", "SINE/AluY", "Retroposon/SVA",
                           "LTR/ERV", "inter", "DNA/misc", "Satellite",
                           "alpha", "hsat2/3", "_sat", "self", "none",
                           "partial", "segdup", "weird"]):
        extra += (f"chr2\t{i}\t{i + 9}\t1\t{i % 6}\t1\t1\t{i}\t{3 * i}"
                  f"\t0\t{i}\t{c}\n")
    (d / "anno_b.tsv").write_text(buf.getvalue() + extra)
    f["anno_b.tsv"] = str(d / "anno_b.tsv")
    # two segments a contig of the -S dump passes in turn (extractseg)
    segs_of = {}
    for ln in open(f["S.gaf"]):
        t = ln.split("\t")
        if t[0] != "*":
            cur = segs_of.setdefault(t[0], [])
        elif t[1][1:] not in cur:
            cur.append(t[1][1:])
    pairs = [v for v in segs_of.values() if len(v) >= 2]
    f["seg_a"], f["seg_b"] = pairs[0][0], pairs[0][-1]
    # GAF lines subgaf and stableGaf refuse
    f["bad_seg.gaf"] = str(d / "bad_seg.gaf")
    (d / "bad_seg.gaf").write_text(
        "q\t100\t0\t100\t+\t>s1>nope\t200\t0\t100\t100\t100\t60\n")
    f["bad_len.gaf"] = str(d / "bad_len.gaf")
    (d / "bad_len.gaf").write_text(
        "q\t100\t0\t100\t+\t>s1\t7\t0\t100\t100\t100\t60\n")
    f["incons.gaf"] = str(d / "incons.gaf")
    (d / "incons.gaf").write_text(
        "short\t1\nq\t100\t0\t100\t+\t>chr1:0-50>chr1:50-300\t300\t60\t160"
        "\t100\t100\t60\n")
    f["plain.gfa"] = str(d / "plain.gfa")
    (d / "plain.gfa").write_text("S\ts1\tACGT\n")
    return f


# command: [(argv with {file} names, stdin file or None), ...]
CASES = {
    "renamefa": [(["s1", "{in.fa}"], None), (["-d", ".", "s1", "{in.fa.gz}"],
                                            None),
                 (["s1", "-"], "in.fa"), (["s1"], None)],
    "joinfa": [(["{in.fa}"], None),
               (["-l", "50", "-n", "5", "-s", "x", "{in.fa.gz}"], None),
               ([], None)],
    "paf2bl": [(["{in.paf}"], None), (["-s", "{in.paf}"], None),
               (["-d", "0.004", "{in.paf}"], None), ([], None)],
    "stableGaf": [(["{gg.gfa}", "{vc.gaf}"], None),
                  (["{gg.gfa}", "{vc_asm.gaf}"], None),
                  (["{gg.gfa}"], "vc_unmapped.gaf"),
                  (["{gg.gfa}", "{bad_seg.gaf}"],
                                             None),
                  (["{gg.gfa}", "{bad_len.gaf}"], None),
                  (["{plain.gfa}", "{vc.gaf}"], None), ([], None)],
    "subgaf": [(["{stable.gaf}", "chr1:0-200000"], None),
               (["{stable.gaf}", "chr1:50000-90000"], None),
               (["{stable.gaf}", "chr2:0-10"], None),
               (["{stable_asm.gaf}", "chr1:0-200000"], None),
               (["{stable_asm.gaf}", "chr1:20000-35000"], None),
               (["{incons.gaf}", "chr1:0-10"], None),
               (["{stable.gaf}", "chr1"], None), (["{stable.gaf}"], None)],
    "sveval": [(["{true.vcf}", "{conf.bed}", "{calls.txt}"], None),
               (["-e", "{true.vcf}", "{conf.bed}", "{calls.txt}"], None),
               (["-a", "-e", "-F", "{true.vcf}", "{conf.bed}",
                 "{calls.txt}"], None),
               (["-f", "50", "-v", "50", "-t", "30", "-s", "10", "-e",
                 "{true.vcf}", "{conf.bed}", "{calls.txt}"], None),
               (["{true.vcf}", "{conf.bed}"], None)],
    "extractseg": [(["-l", "1000", "{seg_a}", "{seg_b}", "{S.gaf}"], None),
                   (["-l", "1000", "{seg_b}", "{seg_a}", "{S.gaf}",
                     "{mz.gaf}"], None),
                   (["-e", "-l", "1000", "{seg_a}", "{seg_b}", "{S.gaf}"],
                    None),
                   (["-e", "-l", "1000", "{seg_b}", "{seg_a}", "{S.gaf}"],
                    None),
                   (["{seg_a}", "{seg_b}", "{S.gaf}"], None),
                   (["-l", "10", "A", "B", "{craft.S.gaf}"], None),
                   (["-e", "-l", "10", "A", "B", "{craft.S.gaf}"], None),
                   (["{seg_a}", "{seg_b}"], None)],
    "anno2tbl": [(["{anno_b.tsv}"], None), ([], "anno_b.tsv")],
    "addsample": [(["{merged.bed}", "{samples4.txt}"], None),
                  (["{merged_nos.bed}", "{samples.txt}"], None),
                  (["{merged.bed}"], None)],
    "getlcr": [(["{merged4.bed}"], None),
               (["-r", "1", "-a", "1", "{merged4.bed}"], None),
               (["-r", "2", "-a", "0", "-e", "100", "-f", "0.2",
                 "{merged4_odd.bed}"], None),
               (["-r", "1", "-a", "1", "{merged.bed}"], None), ([], None)],
    "bed2sql": [(["{samples.txt}", "{pasted.bed}"], None),
                (["{samples.txt}", "-"], "pasted.bed"),
                (["{samples4.txt}"], "pasted4.bed"),
                (["{samples2.txt}", "{pasted.bed}"], None), ([], None)],
    "segfreq": [(["{gfa2bed.bed}", "{merged.bed}"], None),
                (["-f", "0.5", "{gfa2bed.bed}", "{merged.bed}",
                  "{callbub.txt}"], None),
                (["{g2b4.bed}", "{merged4.bed}", "{bub4.txt}"], None),
                (["-f", "0.01", "{g2b4.bed}", "{merged4.bed}"], None),
                (["{gfa2bed.bed}", "{merged_noac.bed}"], None),
                (["{g2b4.bed}", "{merged4_badac.bed}"], None),
                (["{g2b4_miss.bed}", "{merged4.bed}"], None),
                (["{g2b4.bed}", "{merged4.bed}", "{bub4_miss.txt}"], None),
                (["{g2b4.bed}", "{merged4.bed}", "{bub4_badseg.txt}"],
                 None),
                (["{gfa2bed.bed}"], None)],
    "anno": [(["-e", "{etrf.txt}", "-d", "{dust.txt}", "-p", "{self.paf}",
               "-g", "{gap.txt}", "-c", "{brnn.txt}", "{bub.in.bed}"], None),
             (["-r", "{rm.out}", "{bub.in.bed}"], None),
             (["-r", "{rm.out}", "-m", "-l", "10", "{bub.in.bed}"], None),
             (["-e", "{etrf.txt}", "-p", "{self.paf}", "-g", "{gap.txt}",
               "-d", "{dust.txt}", "-r", "{rm.out}", "-c", "{brnn.txt}",
               "-l", "20", "-S", "0.1", "-L", "5", "-b", "{bubble.txt}",
               "-s", "{segdup.bed}", "-m", "-x", "{ld.bed}", "-X", "3",
               "{bub.in.bed}"], None),
             (["-r", "{empty.out}", "{bub.in.bed}"], None),
             (["{bad.bed}"], None),
             (["-r", "{rm_missing.out}", "{bub.in.bed}"], None), ([], None)],
    "genecopy": [(["{genes.gaf}", "{src.bed}"], None),
                 (["-c", "0.5", "-r", "0.5", "{genes.gaf}", "{src.bed}"],
                  None),
                 (["{nocg.gaf}", "{src.bed}"], None), (["{genes.gaf}"], None)],
    "merge": [(["-s", "{samples.txt}", "{pasted.bed}"], None),
              (["-a", "{anno4.tsv}", "-s", "{samples4.txt}",
                "{pasted4.bed}"], None),
              (["{pasted.bed.gz}"], None), (["-"], "pasted4.bed"),
              ([], None)],
    "merge2vcf": [(["-r", "0", "{merged.bed}"], None),
                  (["-r", "1", "-a", "2", "{merged4.bed}"], None),
                  (["-s", "{samples.txt}", "{merged_nos.bed}"], None),
                  (["{merged_nos.bed}"], None),
                  (["-s", "{samples.txt}", "{merged_nona.bed}"], None),
                  (["{merged4_badalen.bed}"], None),
                  (["-s", "{samples4.txt}", "{merged_nos.bed}"], None),
                  ([], None)],
}
# the runs that write nothing: a region or length nothing passes, and
# getlcr's reference column at -r 0 (the FORMAT column, no allele
# number) or with no ANNO tag in the merged BED
EMPTY = {("subgaf", 2), ("extractseg", 4), ("getlcr", 0), ("getlcr", 3)}
IDS = [(cmd, i) for cmd in CASES for i in range(len(CASES[cmd]))]


def run_cmd(fn, argv, stdin, segfreq):
    """(return code or (exception type, message), stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(open(stdin).read()) if stdin else old
    try:
        with contextlib.redirect_stderr(err):
            kw = {"err": err} if segfreq else {}
            rc = fn(argv, out=out, **kw)
    except (ValueError, SystemExit, KeyError, IndexError) as e:
        rc = (type(e).__name__, str(e))
    finally:
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


def test_command_table():
    assert sorted(PORT_CMDS) == sorted(JAX_CMDS)
    assert len(PORT_CMDS) == 16


@pytest.mark.parametrize("cmd,i", IDS, ids=[f"{c}-{i}" for c, i in IDS])
def test_command_matches_jax(files, cmd, i):
    argv, stdin = CASES[cmd][i]
    argv = [files[a[1:-1]] if a.startswith("{") else a for a in argv]
    stdin = files[stdin] if stdin else None
    want = run_cmd(JAX_CMDS[cmd], argv, stdin, cmd == "segfreq")
    got = run_cmd(PORT_CMDS[cmd], argv, stdin, cmd == "segfreq")
    assert got == want
    if want[0] == 0 and len(argv) > 1:
        # every run that succeeds on real input writes something, except
        # the filters nothing passes
        assert bool(want[1]) != ((cmd, i) in EMPTY), (cmd, i)


@pytest.mark.parametrize("vc,stable", [("vc.gaf", "stable.gaf"),
                                       ("vc_asm.gaf", "stable_asm.gaf")])
def test_stable_gaf_against_stable_output(files, vc, stable):
    """stableGaf of a --vc GAF against the port's own stable-coordinate
    GAF of the same run, columns 1-9 (the JAX test holds the reference
    binary's on MT.gfa): equal, except that a reverse-strand record on
    one primary contig comes out one base to the left.  That is the
    tools' arithmetic (`path_len - 1 - qe`, mgutils2.py cmd_stable_gaf),
    which the port keeps byte for byte with the JAX tool."""
    out = io.StringIO()
    assert mgutils2.cmd_stable_gaf([files["gg.gfa"], files[vc]],
                                   out=out) == 0
    want = [ln.split("\t")[:9] for ln in open(files[stable])
            if ln.split("\t")[5] != "*"]
    got = [ln.split("\t")[:9] for ln in out.getvalue().splitlines()]
    assert len(got) == len(want) >= 10
    n_rev = 0
    for g, w in zip(got, want):
        if w[4] == "-" and w[5][0] not in "<>":
            n_rev += 1
            g = g[:7] + [str(int(g[7]) + 1), str(int(g[8]) + 1)]
        assert g == w
    assert 0 < n_rev < len(want)
    if vc == "vc_asm.gaf":
        assert any(w[5][0] in "<>" for w in want)


def sh(module, args, stdin=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120,
                       input=open(stdin).read() if stdin else None)
    return r.returncode, r.stdout, r.stderr


MAIN_CASES = [([], None), (["bogus"], None), (["merge"], None),
              (["merge", "-s", "{samples.txt}", "-"], "pasted.bed"),
              (["renamefa", "s1", "{in.fa.gz}"], None),
              (["segfreq", "{gfa2bed.bed}", "{merged.bed}"], None),
              (["anno2tbl"], "anno_b.tsv"),
              (["merge2vcf", "{merged_nos.bed}"], None)]


@pytest.mark.parametrize("i", range(len(MAIN_CASES)))
def test_main_matches_jax(files, i):
    """The command line: usage, unknown command, stdin, gzip, segfreq's
    stderr table; where a command raises, the exit code and the
    traceback's last line (the paths in it differ)."""
    argv, stdin = MAIN_CASES[i]
    argv = [files[a[1:-1]] if a.startswith("{") else a for a in argv]
    stdin = files[stdin] if stdin else None
    want = sh("minigraph_tpu.tools.mgutils", argv, stdin)
    got = sh("minigraph_tpu_torch.tools.mgutils", argv, stdin)
    if "Traceback" in want[2]:
        assert got[:2] == want[:2] and want[0] == 1
        assert got[2].splitlines()[-1] == want[2].splitlines()[-1]
        assert "No samples found" in want[2]
        return
    assert got == want
    if argv in ([], ["bogus"], ["merge"]):
        assert want[0] == 1 and want[2]
    else:
        assert want[0] == 0 and want[1]
