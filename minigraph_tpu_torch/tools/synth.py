"""Deterministic synthetic pangenome generator (MHC-class workloads).

The real minigraph cookbook (reference README.md:142-163) builds a
61-haplotype human-MHC graph (~5 Mb) with `-cxggs`, then calls per-
sample bubble alleles with `-cxasm --call` and merges them to a VCF.
The Zenodo tarball is unavailable in this environment, so this module
generates an MHC-like region instead: a multi-Mb reference with
interspersed diverged repeat families (so the minimizer occurrence
spectrum has a heavy tail like real sequence), plus haplotypes carrying
structural variants (deletions, insertions, tandem duplications,
inversions) over a SNP/indel background — the same variant classes
minigraph's graph construction targets (ggsimple.c).

`write_bubble_rgfa` turns a reference into a small rGFA pangraph with
insertion bubbles, so a graph with alternative paths can be written
without running graph generation.

Everything is seeded and platform-independent: tests and chip_smoke.py
regenerate identical inputs anywhere.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = {65: 84, 67: 71, 71: 67, 84: 65, 78: 78}
_CMP_TBL = np.arange(256, dtype=np.uint8)
for _k, _v in _COMP.items():
    _CMP_TBL[_k] = _v


def _rand_seq(rng: np.random.Generator, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, n)]


def _revcomp(a: np.ndarray) -> np.ndarray:
    return _CMP_TBL[a[::-1]]


def _mutate(rng: np.random.Generator, a: np.ndarray, sub: float,
            indel: float = 0.0) -> np.ndarray:
    """Substitutions + small (1-10 bp) indels at the given rates."""
    a = a.copy()
    n_sub = rng.binomial(len(a), sub)
    if n_sub:
        pos = rng.integers(0, len(a), n_sub)
        a[pos] = BASES[(np.searchsorted(BASES, a[pos]) % 4
                        + rng.integers(1, 4, n_sub)) % 4]
    if indel <= 0:
        return a
    n_ind = rng.binomial(len(a), indel)
    if not n_ind:
        return a
    parts = []
    cuts = np.sort(rng.integers(0, len(a), n_ind))
    prev = 0
    for c in cuts.tolist():
        parts.append(a[prev:c])
        ln = int(rng.integers(1, 11))
        if rng.random() < 0.5:
            parts.append(_rand_seq(rng, ln))      # insertion
            prev = c
        else:
            prev = min(len(a), c + ln)            # deletion
    parts.append(a[prev:])
    return np.concatenate(parts)


def make_reference(length: int, seed: int = 0,
                   repeat_frac: float = 0.3) -> str:
    """MHC-like reference: unique blocks + diverged repeat copies."""
    rng = np.random.default_rng(seed)
    lib: List[np.ndarray] = []
    parts: List[np.ndarray] = []
    total = 0
    while total < length:
        if lib and rng.random() < repeat_frac:
            unit = lib[int(rng.integers(0, len(lib)))]
            block = _mutate(rng, unit, float(rng.uniform(0.03, 0.15)))
        else:
            block = _rand_seq(rng, int(rng.integers(500, 5000)))
            if rng.random() < 0.4 and 300 <= len(block) <= 3000:
                lib.append(block)
            if len(lib) > 40:
                lib.pop(0)
        parts.append(block)
        total += len(block)
    return np.concatenate(parts)[:length].tobytes().decode("latin-1")


def make_haplotype(ref: str, seed: int, sv_per_mb: float = 12.0,
                   snp: float = 0.001, small_indel: float = 0.0001) -> str:
    """A haplotype with SVs (del/ins/dup/inv) over a SNP/indel layer."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(ref.encode("latin-1"), dtype=np.uint8)
    n_sv = max(1, int(len(a) / 1e6 * sv_per_mb))
    # non-overlapping SV positions, left to right
    pos = np.sort(rng.integers(1000, max(2000, len(a) - 20000), n_sv))
    parts = []
    prev = 0
    for p in pos.tolist():
        if p < prev:
            continue
        parts.append(a[prev:p])
        kind = rng.choice(["del", "ins", "dup", "inv"],
                          p=[0.35, 0.35, 0.15, 0.15])
        if kind == "del":
            prev = p + int(rng.integers(60, 5000))
        elif kind == "ins":
            if rng.random() < 0.5:        # novel sequence
                parts.append(_rand_seq(rng, int(rng.integers(60, 5000))))
            else:                         # mobile-element-like copy
                src = int(rng.integers(0, len(a) - 3000))
                ln = int(rng.integers(100, 3000))
                parts.append(_mutate(rng, a[src:src + ln], 0.05))
            prev = p
        elif kind == "dup":
            ln = int(rng.integers(60, 2000))
            parts.append(a[p:p + ln])     # tandem: unit appears twice
            prev = p
        else:  # inversion
            ln = int(rng.integers(200, 4000))
            parts.append(_mutate(rng, _revcomp(a[p:p + ln]), 0.01))
            prev = p + ln
    parts.append(a[prev:])
    hap = np.concatenate(parts)
    hap = _mutate(rng, hap, snp, small_indel)
    return hap.tobytes().decode("latin-1")


def simulate_reads(seqs: List[str], n_reads: int, seed: int = 0,
                   mean_len: int = 15000, min_len: int = 1000,
                   max_len: int = 40000, sub: float = 0.02,
                   indel: float = 0.01) -> List[Tuple[str, str]]:
    """Long reads (15 kb-class N50, PacBio-like errors) off haplotypes."""
    rng = np.random.default_rng(seed)
    out = []
    arrs = [np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
            for s in seqs]
    for i in range(n_reads):
        src = int(rng.integers(0, len(arrs)))
        a = arrs[src]
        ln = int(np.clip(rng.lognormal(np.log(mean_len), 0.45),
                         min_len, min(max_len, len(a))))
        st = int(rng.integers(0, len(a) - ln + 1))
        r = a[st:st + ln]
        if rng.random() < 0.5:
            r = _revcomp(r)
        r = _mutate(rng, r, sub, indel)
        out.append((f"rd{i}_h{src}_{st}", r.tobytes().decode("latin-1")))
    return out


def simulate_pairs(seq: str, n_pairs: int, seed: int = 0,
                   read_len: int = 150, insert_mean: int = 400,
                   sub: float = 0.003, indel: float = 0.0002):
    """Paired short reads (FR) off one haplotype: a fragment of
    lognormal length around insert_mean from either strand, mate 1 its
    first read_len bases, mate 2 the reverse complement of its last,
    each mutated on its own.  Returns (mates 1, mates 2) as lists of
    (name, seq) with names frag<i>/1 and frag<i>/2."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    r1, r2 = [], []
    for i in range(n_pairs):
        ln = int(np.clip(rng.lognormal(np.log(insert_mean), 0.2),
                         read_len, 4 * insert_mean))
        st = int(rng.integers(0, len(a) - ln + 1))
        frag = a[st:st + ln]
        if rng.random() < 0.5:
            frag = _revcomp(frag)
        m1 = _mutate(rng, frag[:read_len], sub, indel)
        m2 = _mutate(rng, _revcomp(frag[ln - read_len:]), sub, indel)
        r1.append((f"frag{i}/1", m1.tobytes().decode("latin-1")))
        r2.append((f"frag{i}/2", m2.tobytes().decode("latin-1")))
    return r1, r2


def cut_contigs(seq: str, seed: int = 0, mean_len: int = 12000,
                min_len: int = 2000, max_len: int = 32000,
                long_every: int = 50,
                long_len: int = 200_000) -> List[Tuple[str, str]]:
    """An assembly-like query: `seq` cut into consecutive contigs of
    lognormal length (mean mean_len, clipped to [min_len, max_len]),
    every long_every-th one long_len long, named ctg<i>_<start>."""
    rng = np.random.default_rng(seed)
    out = []
    st = 0
    while st < len(seq):
        if len(out) % long_every == long_every - 1:
            ln = long_len
        else:
            ln = int(np.clip(rng.lognormal(np.log(mean_len) - 0.18, 0.6),
                             min_len, max_len))
        out.append((f"ctg{len(out)}_{st}", seq[st: st + ln]))
        st += ln
    return out


def write_fasta(path: str, recs: List[Tuple[str, str]], width: int = 80):
    with open(path, "w") as fh:
        for name, seq in recs:
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i:i + width] + "\n")


def write_bubble_rgfa(ref: str, seed: int, path: str,
                      seg_len: int = 50_000, bubble_every: int = 4,
                      name: str = "chr1") -> str:
    """Write an rGFA pangraph of `ref` with insertion bubbles to `path`
    and return a haplotype that walks through half of the bubbles.

    The reference is cut into ~seg_len segments s1..sN (SN:Z:name,
    SO:i:offset, SR:i:0) linked in order.  At every `bubble_every`-th
    boundary an alternative segment b1, b2, ... of 100-3000 random bases
    (SN:Z:alt<i>, SO:i:0, SR:i:1) sits between the two reference
    segments beside the direct link, forming an insertion bubble."""
    rng = np.random.default_rng(seed)
    n_seg = max(1, -(-len(ref) // seg_len))
    cuts = [len(ref) * i // n_seg for i in range(n_seg + 1)]
    lines = []
    hap = []
    n_alt = 0
    bubbles = [i for i in range(1, n_seg) if i % bubble_every == 0]
    take = set(rng.permutation(bubbles)[: len(bubbles) // 2].tolist())
    for i in range(n_seg):
        s = ref[cuts[i]: cuts[i + 1]]
        lines.append(f"S\ts{i + 1}\t{s}\tLN:i:{len(s)}\tSN:Z:{name}"
                     f"\tSO:i:{cuts[i]}\tSR:i:0")
        hap.append(s)
        if i + 1 == n_seg:
            break
        lines.append(f"L\ts{i + 1}\t+\ts{i + 2}\t+\t0M\tSR:i:0")
        if i + 1 in bubbles:
            n_alt += 1
            alt = _rand_seq(rng, int(rng.integers(100, 3001))) \
                .tobytes().decode("latin-1")
            lines.append(f"S\tb{n_alt}\t{alt}\tLN:i:{len(alt)}"
                         f"\tSN:Z:alt{n_alt}\tSO:i:0\tSR:i:1")
            lines.append(f"L\ts{i + 1}\t+\tb{n_alt}\t+\t0M\tSR:i:1")
            lines.append(f"L\tb{n_alt}\t+\ts{i + 2}\t+\t0M\tSR:i:1")
            if i + 1 in take:
                hap.append(alt)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return "".join(hap)


def bridge_jobs(g, es, rng: np.random.Generator, n: int, mrate: int = 8,
                qcap: int = 1024, max_ed: int = 120):
    """GWFA bridge-shaped jobs on graph g: a source vertex's suffix, a
    random walk of 0-2 arcs, a target vertex's prefix, point-mutated at
    one base in `mrate` (tests/test_device_gwfa.py's recipe).  Returns
    (query bytes, v0, off0, v1, off1, max_ed) for those of 1..qcap
    bases."""
    def vseq(v):
        return es[v >> 1].fwd if (v & 1) == 0 else es[v >> 1].rc

    jobs = []
    for _ in range(n):
        a = g.arc[int(rng.integers(0, g.n_arc))]
        v0, v1 = a.v_lv >> 32, a.w
        l0 = g.seg[v0 >> 1].len
        end0 = int(rng.integers(max(l0 - 150, 0), l0))
        mid = b""
        vcur = v1
        for _hop in range(int(rng.integers(0, 3))):
            st, cnt = g.arc_range(vcur)
            if cnt == 0:
                break
            ai2 = st + int(rng.integers(0, cnt))
            if vcur != v1:
                mid += vseq(vcur)
            vcur = int(g.arc_w[ai2])
        v1 = vcur
        end1 = int(rng.integers(0, min(150, g.seg[v1 >> 1].len)))
        q = bytearray(vseq(v0)[end0:] + mid + vseq(v1)[: end1 + 1])
        for p in rng.integers(0, max(len(q), 1),
                              size=max(1, len(q) // mrate)):
            q[p] = ord("ACGT"[int(rng.integers(0, 4))])
        if q and len(q) <= qcap:
            jobs.append((bytes(q), int(v0), end0, int(v1), end1, max_ed))
    return jobs


def write_star_gfa(path: str, seed: int, n_out: int = 8,
                   seg_len: int = 600) -> None:
    """A small GFA whose segment hub has n_out successors (a vertex of
    degree n_out), each leading on to one tail segment."""
    rng = np.random.default_rng(seed)

    def seq():
        return _rand_seq(rng, seg_len).tobytes().decode("latin-1")

    lines = [f"S\thub\t{seq()}\tLN:i:{seg_len}",
             f"S\ttail\t{seq()}\tLN:i:{seg_len}"]
    for i in range(n_out):
        lines.append(f"S\tx{i}\t{seq()}\tLN:i:{seg_len}")
        lines.append(f"L\thub\t+\tx{i}\t+\t0M")
        lines.append(f"L\tx{i}\t+\ttail\t+\t0M")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
