"""Graph generation, bubble calling and coverage of the port (ggen/,
graph/augment.py, graph/bubbles.py, utils/algo.py, the --cov route of
mapping/mapper.py) against the JAX package's command line, in process,
on a 300 kb bubble graph with make_haplotype samples (SVs: deletions,
insertions, duplications, inversions) cut into assembly-like contigs:
-xggs and -cxggs with two samples (the rGFA), -cxasm --call (the BED),
--cov on reads and -cxasm --cov (the GFA with dc:f), -xggs --cov (cf:f),
and one case with -l, -d and --inv=no; the delta re-index (IndexCache)
against a build from scratch.  The port runs with --device none (graph
generation maps without a front, as the JAX package).  Tolerance: exact
equality."""
import contextlib
import io

import numpy as np
import pytest
import torch

from minigraph_tpu import cli as jax_cli
from minigraph_tpu_torch import cli
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import IndexCache, build_index
from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                             make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ggen")
    ref = make_reference(300_000, seed=51)
    hap = write_bubble_rgfa(ref, 52, str(d / "g.gfa"), seg_len=25_000)
    out = {"g": str(d / "g.gfa")}
    for i, seed in enumerate((53, 55, 57)):
        sample = make_haplotype(ref, seed, sv_per_mb=40)
        # two long contigs (past -l's default 100 kb) and short ones
        write_fasta(str(d / f"s{i}.fa"),
                    cut_contigs(sample, seed + 1, mean_len=20000,
                                min_len=5000, max_len=40000, long_every=3,
                                long_len=120_000))
        out[f"s{i}"] = str(d / f"s{i}.fa")
    write_fasta(str(d / "r.fa"),
                simulate_reads([hap, ref], 30, seed=59, mean_len=4000,
                               min_len=1000, max_len=9000))
    out["r"] = str(d / "r.fa")
    return out


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


CASES = {
    "ggs": (["-xggs"], ["s0", "s1"]),
    "ggs_cigar": (["-cxggs"], ["s0", "s1"]),
    "call": (["-cxasm", "--call"], ["s2"]),
    "cov_reads": (["--cov"], ["r"]),
    "cov_asm": (["-cxasm", "--cov"], ["s0"]),
    "cov_ggs": (["-xggs", "--cov"], ["s0", "s1"]),
    "ggs_len_inv": (["-cxggs", "-l", "20k", "-d", "10k", "--inv=no"],
                    ["s0", "s1"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(files, case):
    opts, qs = CASES[case]
    paths = [files["g"]] + [files[q] for q in qs]
    rc, want, err = run(jax_cli.main, ["-t1"] + opts + paths)
    assert rc == 0, err
    rc, got, err = run(cli.main, ["-t2", "--device", "none"] + opts + paths)
    assert rc == 0, err
    assert got == want, case
    # each case does work: segments added, calls made, coverage written
    if case.startswith("ggs"):
        n_seg = sum(1 for ln in got.splitlines() if ln.startswith("S\t"))
        n_in = sum(1 for ln in open(files["g"]) if ln.startswith("S\t"))
        assert n_seg > n_in, (n_seg, n_in)
    elif case == "call":
        assert got.count("\n") >= 3
    else:
        assert "\tdc:f:" in got or "\tcf:f:" in got


def test_delta_index_matches_scratch(files, tmp_path):
    """IndexCache: after augmentation, a cached re-index equals a build
    from scratch (keys, positions, counts, edseqs)."""
    rc, gfa, _ = run(cli.main, ["--device", "none", "-xggs", files["g"],
                                files["s0"]])
    assert rc == 0
    path = str(tmp_path / "aug.gfa")
    open(path, "w").write(gfa)
    cache = IndexCache()
    build_index(read_gfa(files["g"]), 19, 10, cache=cache)
    assert cache.hits == 0 and cache.misses > 0
    g = read_gfa(path)
    got = build_index(g, 19, 10, cache=cache)
    assert cache.hits > 0 and cache.misses > 0
    want = build_index(read_gfa(path), 19, 10)
    for name in ("keys", "pos", "key_start", "key_cnt"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert [(e.fwd, e.rc, e.len) for e in got.es] \
        == [(e.fwd, e.rc, e.len) for e in want.es]
