"""The generator: deterministic for a seed, and its lengths and errors
those of the copied synth parameters."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import gen
from portbench.inputs import make_inputs


def _files(inp):
    return [open(p, "rb").read() for p in [inp.gfa, *inp.files]]


@pytest.mark.parametrize("wl", ["t.lr", "t.asm"])
def test_same_seed_same_inputs(tiny_spec, tmp_path, wl):
    cell = tiny_spec.cell(wl)
    a = make_inputs(cell.config, cell.traffic, 2**31 + 11, tmp_path / "a")
    b = make_inputs(cell.config, cell.traffic, 2**31 + 11, tmp_path / "b")
    c = make_inputs(cell.config, cell.traffic, 2**31 + 12, tmp_path / "c")
    assert _files(a) == _files(b)
    assert _files(a)[1:] != _files(c)[1:]


def _record_lengths(path):
    return [len(line) - 1 for line in open(path) if not line.startswith(">")]


def _records(path):
    lines = open(path).read().split("\n")
    return list(zip(lines[0::2], lines[1::2]))


def test_the_seed_changes_errors_not_work(tiny_spec, tmp_path):
    """The work is the same for every seed: the same graph and the same
    reads' places, lengths and order (contigs: lengths and order); the
    seed draws the reads' errors and the assemblies' SNP layer."""
    for wl in ("t.lr", "t.asm"):
        cell = tiny_spec.cell(wl)
        a = make_inputs(cell.config, cell.traffic, 5, tmp_path / wl / "a")
        b = make_inputs(cell.config, cell.traffic, 6, tmp_path / wl / "b")
        assert open(a.gfa).read() == open(b.gfa).read()
        for fa, fb in zip(a.files, b.files):
            ra, rb = _records(fa), _records(fb)
            if wl == "t.lr":
                assert [n for n, _ in ra] == [n for n, _ in rb]
            else:       # the same cut but for the last contig
                assert [len(s) for _, s in ra[:-1]] == \
                    [len(s) for _, s in rb[:-1]]
            assert sum(x != y for x, y in zip(ra, rb)) > len(ra) // 2


def test_cut_contigs_covers_the_haplotype():
    rng = np.random.default_rng(3)
    hap = gen.BASES[rng.integers(0, 4, 50_000)]
    names, seq, off = gen.cut_contigs(hap, np.full(40, 3000))
    assert bytes(seq) == bytes(hap) and off[-1] == len(hap)
    assert len(names) == 17 and off[1] == 3000


def test_lognormal_lengths_parameters():
    rng = np.random.default_rng(1)
    x = gen.lognormal_lengths(rng, 200_000, 15000, 0.45, 1, 10**9)
    logx = np.log(x)
    assert abs(logx.mean() - np.log(15000)) < 0.01
    assert abs(logx.std() - 0.45) < 0.01
    y = gen.lognormal_lengths(rng, 1000, 15000, 0.45, 1000, 40000)
    assert y.min() >= 1000 and y.max() <= 40000


def _kmer_share(read: bytes, src: bytes, k: int = 16) -> float:
    have = {src[i:i + k] for i in range(len(src) - k + 1)}
    rc = bytes(gen._revcomp(np.frombuffer(read, np.uint8)))
    best = 0.0
    for r in (read, rc):
        km = [r[i:i + k] for i in range(len(r) - k + 1)]
        best = max(best, sum(x in have for x in km) / len(km))
    return best


def test_errors_match_synth():
    """The fast simulator against synth's loop (a read at a time through
    the copied _mutate) on the same sources: mean length and the share
    of a read's 16-mers found in its source agree."""
    rng = np.random.default_rng(7)
    haps = [gen.BASES[rng.integers(0, 4, 400_000)] for _ in range(2)]
    lens = gen.lognormal_lengths(rng, 300, 3000, 0.45, 1000, 8000)
    sub, indel = 0.02, 0.01
    names, seq, off = gen.simulate_reads(
        haps, lens, np.random.default_rng(8), np.random.default_rng(10),
        sub, indel, chunk_bp=200_000)
    fast_len, fast_share = [], []
    for i, nm in enumerate(names):
        h, st = (int(x) for x in nm.split("_h")[1].split("_"))
        r = bytes(seq[off[i]: off[i + 1]])
        src = bytes(haps[h][st: st + lens[i]])
        fast_len.append(len(r) - lens[i])
        fast_share.append(_kmer_share(r, src))
    srng = np.random.default_rng(9)
    slow_len, slow_share = [], []
    for ln in lens:
        h = int(srng.integers(0, 2))
        st = int(srng.integers(0, len(haps[h]) - ln + 1))
        src = haps[h][st: st + ln]
        r = src if srng.random() < 0.5 else gen._revcomp(src)
        r = gen._mutate(srng, r, sub, indel)
        slow_len.append(len(r) - ln)
        slow_share.append(_kmer_share(bytes(r), bytes(src)))
    assert abs(np.mean(fast_share) - np.mean(slow_share)) < 0.02
    assert 0.5 < np.mean(fast_share) < 0.75
    # insertions and deletions at even odds: the mean length is kept
    assert abs(np.mean(fast_len)) < 8 and abs(np.mean(slow_len)) < 8
    assert abs(np.std(fast_len) - np.std(slow_len)) < 0.3 * np.std(slow_len)
