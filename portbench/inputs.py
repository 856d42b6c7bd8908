"""A cell's inputs from its configuration, its traffic mix and the seed.

The configuration fixes the graph (variation sites on a synthetic
MHC-like reference at a published graph's densities, from its
`graph_seed`) and the preset; the traffic file fixes the query files of
the pool, which the window maps one after another.  Each sample
haplotype walks the graph (`alt_freq`: the odds of a site's other
alleles), with its own SVs, SNPs and small indels over the walk
(`haplotype`):

- kind "reads": `reads_per_file` reads a file off `haplotypes` sample
  haplotypes, lengths lognormal (`length`), errors (`errors`);
- kind "contigs": each file is one haplotype assembly, the haplotype cut
  into consecutive contigs of lognormal length, every `long_every`-th
  one `long_len` long.

What decides the work is the same for every seed: the graph, the
haplotypes' walks and SVs, each file's reads (lengths, places, strands, order)
or contigs (lengths, order) come from fixed seeds (`graph_seed`, the
mix's `sample_seed`).  The run's seed draws the reads' sequencing
errors, and the SNP and small-indel layer of each assembly's
haplotype.  A query's cost depends on where it lies and where it
stands in its file (the split sends a file's first eligible queries to
the host; a slow query late in a batch holds the batch): with these
drawn from the seed, the rate moved by a quarter between seeds
(PERF.md, section 6).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import numpy as np

from . import gen


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of a seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class Inputs:
    gfa: str
    files: List[str]                     # the pool, in window order
    bp: List[int] = field(default_factory=list)
    reads: List[int] = field(default_factory=list)


def _lengths(tr: dict, i: int, n: int) -> np.ndarray:
    ln = tr["length"]
    rng = np.random.default_rng(sub_seed(tr["sample_seed"], 5, i))
    return gen.lognormal_lengths(rng, n, ln["mean"], ln["sigma"], ln["min"],
                                 ln["max"], ln.get("mu_shift", 0.0))


def _haplotype(pg: dict, tr: dict, i: int,
               snp_seed: int = None) -> np.ndarray:
    h = tr["haplotype"]
    walk = gen.walk(pg, np.random.default_rng(
        sub_seed(tr["sample_seed"], 2, i)), h["alt_freq"])
    return gen.make_haplotype(walk, sub_seed(tr["sample_seed"], 3, i),
                              h["sv_per_mb"], h["snp"], h["small_indel"],
                              snp_seed)


def make_inputs(config: dict, traffic: dict, seed: int,
                workdir: Path) -> Inputs:
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    g = config["graph"]
    ref = gen.make_reference(config["graph_bp"], config["graph_seed"],
                             g["repeat_frac"])
    pg = gen.make_pangraph(ref, config["graph_seed"] + 1, g)
    gfa = str(workdir / "graph.gfa")
    gen.write_rgfa(pg, gfa)
    tr = traffic
    out = Inputs(gfa=gfa, files=[])
    if tr["kind"] == "reads":
        haps = [_haplotype(pg, tr, h) for h in range(tr["haplotypes"])]
    for i in range(tr["pool_files"]):
        if tr["kind"] == "reads":
            e = tr["errors"]
            names, seq, off = gen.simulate_reads(
                haps, _lengths(tr, i, tr["reads_per_file"]),
                np.random.default_rng(sub_seed(tr["sample_seed"], 4, i)),
                np.random.default_rng(sub_seed(seed, 4, i)), e["sub"],
                e["indel"], e["indel_max"], prefix=f"f{i}rd")
        elif tr["kind"] == "contigs":
            hap = _haplotype(pg, tr, i, snp_seed=sub_seed(seed, 3, i))
            ln = tr["length"]
            n = int(len(hap) * 1.5 / ln["mean"]) + ln["long_every"]
            lens = _lengths(tr, i, n)
            lens[ln["long_every"] - 1:: ln["long_every"]] = ln["long_len"]
            names, seq, off = gen.cut_contigs(hap, lens, prefix=f"f{i}ctg")
        else:
            raise ValueError(f"unknown traffic kind {tr['kind']!r}")
        path = str(workdir / f"pool{i}.fa")
        gen.write_fasta(path, names, seq, off)
        out.files.append(path)
        out.bp.append(int(off[-1]))
        out.reads.append(len(names))
    return out
