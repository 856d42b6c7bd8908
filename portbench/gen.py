"""The benchmark's input generator: the graph and the query files.

`make_reference` and `make_haplotype` are copies of the port's
tools/synth.py generators (an MHC-like reference of unique blocks and
diverged repeat families; haplotypes with SVs over a SNP/indel layer),
`make_haplotype` on byte arrays here.  `make_pangraph` puts variation
sites of several kinds on the reference at the densities a
configuration gives, `write_rgfa` writes them as an rGFA and `walk`
draws a haplotype through them.  The read
simulator draws the same things as synth's `simulate_reads` (a
haplotype and a start uniform, either strand, substitutions and 1-10 bp
indels at the given rates) with whole-array numpy calls instead of a
Python loop a read, so that a 60 Mbp file takes about a second.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_COMP = {65: 84, 67: 71, 71: 67, 84: 65, 78: 78}
_CMP_TBL = np.arange(256, dtype=np.uint8)
for _k, _v in _COMP.items():
    _CMP_TBL[_k] = _v
_CODE = np.zeros(256, dtype=np.int64)
_CODE[BASES] = np.arange(4)


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
                   repeat_frac: float = 0.3) -> np.ndarray:
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
    return np.concatenate(parts)[:length]


def make_haplotype(a: np.ndarray, seed: int, sv_per_mb: float = 12.0,
                   snp: float = 0.001, small_indel: float = 0.0001,
                   snp_seed: int = None) -> np.ndarray:
    """A haplotype of byte array `a` with SVs (del/ins/dup/inv) over a
    SNP/indel layer; the layer from `snp_seed` where it is given."""
    rng = np.random.default_rng(seed)
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
    if snp_seed is not None:
        rng = np.random.default_rng(snp_seed)
    return _mutate(rng, np.concatenate(parts), snp, small_indel)


def _log_uniform(rng: np.random.Generator, lo: int, hi: int) -> int:
    return int(np.exp(rng.uniform(np.log(lo), np.log(hi))))


def make_pangraph(ref: np.ndarray, seed: int, p: dict) -> dict:
    """Variation sites on a reference, as a pangenome graph holds them.

    `p` (a configuration's "graph"): `sites_per_mb`; `kinds`, the share
    of each site kind (whole sites, in an order from the seed); `extra_alleles`, the mean (Poisson) of a site's
    alleles past its first; `inner_splits`, the mean (Poisson) of the
    points inside a deletion or substitution site's reference allele at
    which its alleles may start or end (nested bubbles); `allele_len`,
    `min` and `max` of a log-uniform allele length.  Kinds:

    - "ins": alleles of new sequence at one point: random bases, a
      diverged copy of sequence from elsewhere (mobile-element-like) or
      a copy of the sequence before the point (tandem duplication);
    - "del": the reference allele skipped by a link, and alleles of
      random bases over parts of it;
    - "sub": alleles of random bases in place of parts of the reference
      allele (minigraph adds an allele only below 80% identity);
    - "inv": the reference allele walked in reverse.

    Returns {"ref", "sites"}: each site (kind, its boundary points in
    the reference, its alleles as (first point, last point, bases or
    None for a deletion link))."""
    rng = np.random.default_rng(seed)
    kinds = sorted(p["kinds"])
    share = np.array([p["kinds"][k] for k in kinds], dtype=np.float64)
    lo, hi = p["allele_len"]["min"], p["allele_len"]["max"]
    n = max(1, int(round(len(ref) / 1e6 * p["sites_per_mb"])))
    gap = len(ref) // (n + 1)
    # each kind's share of the sites as near as whole sites allow
    cum = np.round(np.cumsum(share / share.sum()) * n).astype(np.int64)
    order = rng.permutation(np.repeat(np.arange(len(kinds)),
                                      np.diff(np.concatenate([[0], cum]))))
    sites = []
    for i in range(n):
        kind = kinds[int(order[i])]
        # a site in each slot of the reference, 2 kb clear of its ends
        room = gap - hi - 4000
        pos = (i + 1) * gap - gap // 2 + int(rng.integers(0, max(1, room)))
        m = int(rng.poisson(p["extra_alleles"]))
        if kind == "ins":
            pts = [pos]
            alleles = []
            for _ in range(1 + m):
                ln = _log_uniform(rng, lo, hi)
                r = rng.random()
                if r < 0.4:
                    seq = _rand_seq(rng, ln)
                elif r < 0.7:
                    src = int(rng.integers(0, len(ref) - ln))
                    seq = _mutate(rng, ref[src: src + ln],
                                  float(rng.uniform(0.05, 0.15)))
                else:
                    seq = ref[max(0, pos - ln): pos].copy()
                alleles.append((0, 0, seq))
        else:
            ln = _log_uniform(rng, lo, hi)
            inner = 0 if kind == "inv" else \
                int(rng.poisson(p["inner_splits"]))
            cuts = np.unique(rng.integers(1, ln, inner)) if inner else []
            pts = [pos, *[pos + int(c) for c in cuts], pos + ln]
            last = len(pts) - 1
            alleles = []
            if kind == "del":
                alleles.append((0, last, None))
            for _ in range(1 + m if kind == "sub" else
                           (m if kind == "del" else 0)):
                a = int(rng.integers(0, last))
                b = int(rng.integers(a + 1, last + 1))
                alleles.append((a, b, _rand_seq(
                    rng, _log_uniform(rng, lo, hi))))
        sites.append((kind, pts, alleles))
    return {"ref": ref, "sites": sites}


def write_rgfa(pg: dict, path: str, name: str = "chr1") -> Tuple[int, int]:
    """The graph as rGFA: the reference cut at every site's points into
    segments s1..sN (SN:Z:name, SO:i:offset, SR:i:0) linked in order;
    each allele a segment a1, a2, ... (SN:Z:alt<i>, SO:i:0, SR:i:1)
    linked from the segment that ends at its first point to the one that
    starts at its last; a deletion a link between those two; an
    inversion the links into and out of its segment's reverse strand.
    Returns the numbers of segments and links."""
    ref = pg["ref"]
    pts = sorted({x for _, ps, _ in pg["sites"] for x in ps})
    cuts = [0, *pts, len(ref)]
    seg_at = {c: i + 1 for i, c in enumerate(cuts[:-1])}   # starts here
    seg_end = {c: i + 1 for i, c in enumerate(cuts[1:])}   # ends here
    lines, links = [], []
    for i in range(len(cuts) - 1):
        s = ref[cuts[i]: cuts[i + 1]].tobytes().decode("latin-1")
        lines.append(f"S\ts{i + 1}\t{s}\tLN:i:{len(s)}\tSN:Z:{name}"
                     f"\tSO:i:{cuts[i]}\tSR:i:0")
        if i:
            links.append(f"L\ts{i}\t+\ts{i + 1}\t+\t0M\tSR:i:0")
    n_alt = 0
    for kind, ps, alleles in pg["sites"]:
        if kind == "inv":
            a, b = seg_end[ps[0]], seg_at[ps[0]]
            links.append(f"L\ts{a}\t+\ts{b}\t-\t0M\tSR:i:1")
            links.append(f"L\ts{b}\t-\ts{seg_at[ps[1]]}\t+\t0M\tSR:i:1")
            continue
        for a, b, seq in alleles:
            u, v = f"s{seg_end[ps[a]]}", f"s{seg_at[ps[b]]}"
            if seq is None:
                links.append(f"L\t{u}\t+\t{v}\t+\t0M\tSR:i:1")
                continue
            n_alt += 1
            t = seq.tobytes().decode("latin-1")
            lines.append(f"S\ta{n_alt}\t{t}\tLN:i:{len(t)}"
                         f"\tSN:Z:alt{n_alt}\tSO:i:0\tSR:i:1")
            links.append(f"L\t{u}\t+\ta{n_alt}\t+\t0M\tSR:i:1")
            links.append(f"L\ta{n_alt}\t+\t{v}\t+\t0M\tSR:i:1")
    with open(path, "w") as fh:
        fh.write("\n".join(lines + links) + "\n")
    return len(lines), len(links)


def walk(pg: dict, rng: np.random.Generator, alt_freq: float) -> np.ndarray:
    """A haplotype through the graph: at each site the reference allele,
    or with odds `alt_freq` one of the site's alleles (an inversion's
    reverse strand) drawn uniformly."""
    ref = pg["ref"]
    parts, prev = [], 0
    for kind, ps, alleles in pg["sites"]:
        if rng.random() >= alt_freq:
            continue
        if kind == "inv":
            parts += [ref[prev: ps[0]], _revcomp(ref[ps[0]: ps[1]])]
            prev = ps[1]
            continue
        a, b, seq = alleles[int(rng.integers(0, len(alleles)))]
        parts.append(ref[prev: ps[a]])
        if seq is not None:
            parts.append(seq)
        prev = ps[b]
    parts.append(ref[prev:])
    return np.concatenate(parts)


def lognormal_lengths(rng: np.random.Generator, n: int, mean: float,
                      sigma: float, lo: int, hi: int,
                      mu_shift: float = 0.0) -> np.ndarray:
    """n lengths, lognormal around log(mean) + mu_shift, clipped."""
    x = rng.lognormal(np.log(mean) + mu_shift, sigma, n)
    return np.clip(x, lo, hi).astype(np.int64)


def simulate_reads(haps: List[np.ndarray], lengths: np.ndarray,
                   place_rng: np.random.Generator,
                   rng: np.random.Generator, sub: float, indel: float,
                   indel_max: int = 10, prefix: str = "rd",
                   chunk_bp: int = 8_000_000
                   ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Reads of the given lengths off `haps`: for each a haplotype and a
    start uniform, either strand (from `place_rng`); then (from `rng`)
    Binomial(bases, sub) substitutions at uniform places (to one of the
    other three bases) and Binomial(bases, indel) indel events of
    1..indel_max bases, an insertion of random bases before the base or
    a deletion from it, at even odds (synth's _mutate over a chunk of
    reads at once).  Returns (names, concatenated bases, offsets of
    n + 1)."""
    hlen = np.array([len(h) for h in haps], dtype=np.int64)
    n = len(lengths)
    src = place_rng.integers(0, len(haps), n)
    L = np.minimum(lengths, hlen[src])
    st = (place_rng.random(n) * (hlen[src] - L + 1)).astype(np.int64)
    rev = place_rng.random(n) < 0.5
    names = [f"{prefix}{i}_h{s}_{t}" for i, (s, t) in
             enumerate(zip(src.tolist(), st.tolist()))]
    out, out_len = [], np.empty(n, dtype=np.int64)
    a = 0
    while a < n:
        b, tot = a + 1, int(L[a])
        while b < n and tot + L[b] <= chunk_bp:
            tot += int(L[b])
            b += 1
        pieces = []
        for i in range(a, b):
            seg = haps[src[i]][st[i]: st[i] + L[i]]
            pieces.append(_revcomp(seg) if rev[i] else seg)
        s = np.concatenate(pieces)
        ends = np.cumsum(L[a:b])
        starts = ends - L[a:b]
        pos = rng.integers(0, tot, rng.binomial(tot, sub))
        s[pos] = BASES[(_CODE[s[pos]] + rng.integers(1, 4, len(pos))) % 4]
        e = np.sort(rng.integers(0, tot, rng.binomial(tot, indel)))
        ln = rng.integers(1, indel_max + 1, len(e))
        ins = rng.random(len(e)) < 0.5
        rid = np.searchsorted(ends, e, side="right")
        # deleted places: each deletion's run, cut at its read's end
        dpos = e[~ins]
        dlen = np.minimum(dpos + ln[~ins], ends[rid[~ins]]) - dpos
        gone = np.unique(np.repeat(dpos - np.cumsum(dlen) + dlen, dlen)
                         + np.arange(int(dlen.sum())))
        keep = np.ones(tot, dtype=bool)
        keep[gone] = False

        def kept_before(x):
            return x - np.searchsorted(gone, x)
        ipos, iln = e[ins], ln[ins]
        s = np.insert(s[keep], np.repeat(kept_before(ipos), iln),
                      BASES[rng.integers(0, 4, int(iln.sum()))])
        out.append(s)
        out_len[a:b] = (kept_before(ends) - kept_before(starts)
                        + np.bincount(rid[ins], weights=iln,
                                      minlength=b - a).astype(np.int64))
        a = b
    seq = np.concatenate(out)
    off = np.concatenate([[0], np.cumsum(out_len)])
    return names, seq, off


def cut_contigs(hap: np.ndarray, lengths: np.ndarray, prefix: str = "ctg"
                ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """An assembly-like query: `hap` cut into consecutive contigs of the
    given lengths (the last one ends with the haplotype), named
    <prefix><i>_<start>.  Returns (names, bases, offsets)."""
    ends = np.minimum(np.cumsum(lengths), len(hap))
    n = int(np.searchsorted(ends, len(hap))) + 1
    off = np.concatenate([[0], ends[:n]])
    off[-1] = len(hap)
    names = [f"{prefix}{i}_{int(off[i])}" for i in range(n)]
    return names, hap[: off[-1]], off


def write_fasta(path: str, names: List[str], seq: np.ndarray,
                off: np.ndarray) -> None:
    """One header line and one sequence line a record."""
    buf = seq.tobytes()
    parts = []
    for i, nm in enumerate(names):
        parts.append(b">" + nm.encode("latin-1") + b"\n")
        parts.append(buf[int(off[i]): int(off[i + 1])])
        parts.append(b"\n")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
