"""The port's mapping command line against the JAX package's: the
presets field for field (opt_set, opt_check), then both CLIs' main on
one small synthetic bubble graph with identical stdout bytes for every
preset and mapping flag the port takes, the port with --device none
(every read on the native host path) and --device cpu (the device
front's plain PyTorch versions), the JAX package host only.  The JAX
side runs one host thread, the port two: the bytes do not depend on
it.  The options ported from the refusal list (graph generation, --call,
--cov, --gwfa-device, with and without -c) write the JAX CLI's bytes;
the last ones it refused (--seed-device, --write-mz, --tpu, --no-kalloc,
the --dbg-* dumps) are held in tests/test_torch_debug.py.  Tolerance:
exact equality."""
import contextlib
import dataclasses
import io

import pytest
import torch

from minigraph_tpu import cli as jax_cli
from minigraph_tpu import options as jax_options
from minigraph_tpu_torch import cli
from minigraph_tpu_torch import options
from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                             make_reference, simulate_pairs,
                                             simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

PRESETS = [None, "lr", "asm", "ggs", "se", "sr"]


@pytest.mark.parametrize("preset", PRESETS + ["xyz"])
def test_opt_set_matches_jax(preset):
    io_, mo, go = (options.IndexOptions(), options.MapOptions(),
                   options.GGOptions())
    jio, jmo, jgo = (jax_options.IndexOptions(), jax_options.MapOptions(),
                     jax_options.GGOptions())
    assert options.opt_set(preset, io_, mo, go) \
        == jax_options.opt_set(preset, jio, jmo, jgo)
    for mine, theirs in ((io_, jio), (mo, jmo), (go, jgo)):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(theirs, f.name), \
                (preset, f.name)
    assert options.opt_check(io_, mo, go) \
        == jax_options.opt_check(jio, jmo, jgo)
    # fragment mode without merged output is refused by both
    mo.flag |= options.MG_M_FRAG_MODE
    mo.flag &= ~options.MG_M_FRAG_MERGE
    jmo.flag = mo.flag
    assert options.opt_check(io_, mo) == jax_options.opt_check(jio, jmo, jgo)


def test_flags_match_jax():
    for name in dir(options):
        if name.startswith(("MG_M_", "MG_SEED_", "MG_MAX_")):
            assert getattr(options, name) == getattr(jax_options, name), name


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("presets")
    ref = make_reference(200_000, seed=111)
    hap = write_bubble_rgfa(ref, 112, str(d / "g.gfa"), seg_len=20_000)
    reads = simulate_reads([hap, ref], 30, seed=113, mean_len=1500,
                           min_len=300, max_len=3000)
    reads.append(("empty", ""))
    write_fasta(str(d / "r.fa"), reads)
    asm = make_haplotype(ref, 114, sv_per_mb=40)
    write_fasta(str(d / "asm.fa"),
                cut_contigs(asm, 115, mean_len=6000, min_len=1000,
                            max_len=20000, long_every=10, long_len=40000))
    r1, r2 = simulate_pairs(hap, 150, seed=116)
    write_fasta(str(d / "r1.fa"), r1)
    write_fasta(str(d / "r2.fa"), r2)
    return {k: str(d / f"{k}.fa") for k in ("r", "asm", "r1", "r2")} \
        | {"g": str(d / "g.gfa")}


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


# (port options, JAX options where they differ, query files)
CASES = {
    "lr": ([], None, ["r"]),
    "asm": (["-xasm"], None, ["asm"]),
    # the JAX command line cannot spell --ggen=none (its getopt takes
    # --ggen as a flag): ggs without graph generation is asm with -N 0
    "ggs": (["-xggs", "--ggen=none"], ["-xasm", "-N0"], ["asm"]),
    "se": (["-xse"], None, ["r1"]),
    "sr": (["-xsr"], None, ["r1", "r2"]),
    "rmq": (["--rmq"], None, ["r"]),
    "rmq_yes": (["--rmq=yes"], ["--rmq"], ["r"]),
    "asm_rmq_no": (["-xasm", "--rmq=no"], None, ["asm"]),
    "vc": (["--vc"], None, ["r"]),
    "lchain": (["-S"], None, ["r"]),
    "secondary": (["--secondary=yes", "-P"], None, ["r"]),
    "no_diag": (["-D"], None, ["r"]),
    "heap_sort": (["--heap-sort=yes"], None, ["r"]),
    "frag_len": (["-F", "2000"], None, ["r"]),
    "pairs": (["-U", "30,200", "-r", "400,10000", "-n", "4,3", "-m",
               "40,30", "-p", "0.5", "-N", "3", "-M", "0.6", "-j", "0.05",
               "-g", "4000", "-f", "0.001"], None, ["r"]),
    "chain_opts": (["--gap-pen", "0.5", "--ref-bonus", "1", "--max-gap-pre",
                    "800", "--max-lc-skip", "20", "--max-gc-skip", "20",
                    "--max-lc-iter", "4000", "--max-rmq-size", "50000",
                    "--gdp-max-ed", "5000", "--cap-calloc", "100m",
                    "--no-comp-path", "--show-unmap=yes"], None, ["r"]),
    "frag": (["--frag"], None, ["r1", "r2"]),
    "sr_vc": (["-xsr", "--vc"], None, ["r1", "r2"]),
    # base-level alignment: cg:Z and ds:Z
    "cigar": (["-c"], None, ["r"]),
    "cigar_asm": (["-cxasm"], None, ["asm"]),
    "cigar_se": (["-cxse"], None, ["r1"]),
    "cigar_sr": (["-cxsr"], None, ["r1", "r2"]),
    "cigar_vc": (["-c", "--vc"], None, ["r"]),
    "cigar_lchain": (["-c", "-S"], None, ["r"]),
    "cigar_frag": (["-c", "--frag"], None, ["r1", "r2"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(files, case):
    port, jax, qs = CASES[case]
    paths = [files["g"]] + [files[q] for q in qs]
    if case == "asm_rmq_no":
        # --rmq=no after -xasm clears the RMQ bit: asm's other settings
        # with the banded DP.  The JAX command line cannot spell
        # --rmq=no; its options object can
        want = jax_map(files, qs, "asm", clear=jax_options.MG_M_RMQ)
    else:
        rc, want, err = run(jax_cli.main, ["-t1"] + (jax or port) + paths)
        assert rc == 0, err
    assert want.count("\n") >= 20
    for dev in ("none", "cpu"):
        rc, got, err = run(cli.main, ["-t2", "--device", dev] + port + paths)
        assert rc == 0, err
        assert got == want, (case, dev)


def jax_map(files, qs, preset, clear=0):
    from minigraph_tpu.graph.gfa_io import read_gfa
    from minigraph_tpu.mapping.mapper import map_files
    io_, mo, go = (jax_options.IndexOptions(), jax_options.MapOptions(),
                   jax_options.GGOptions())
    jax_options.opt_set(preset, io_, mo, go)
    mo.flag &= ~clear
    out = io.StringIO()
    map_files(read_gfa(files["g"]), [files[q] for q in qs], io_, mo,
              out=out, n_threads=1)
    return out.getvalue()


def test_cli_output_file_and_version(files, tmp_path):
    path = str(tmp_path / "out.gaf")
    rc, out, err = run(cli.main, ["--device", "none", "-o", path, files["g"],
                                  files["r"]])
    assert rc == 0 and out == "", err
    rc, want, _ = run(jax_cli.main, ["-t1", files["g"], files["r"]])
    assert open(path).read() == want
    assert run(cli.main, ["--version"])[:2] == \
        run(jax_cli.main, ["--version"])[:2]


# options the port took over from its refusal list, one parity case each
# (id: the option), on the same inputs: graph generation on the asm
# contigs with -l5k -d5k so that segments are added, --call and --cov,
# and --gwfa-device (with --device cpu: the pool's plain version; the
# JAX run has no front, the bytes are the same).  The JAX command line
# cannot spell --ggen=simple (see CASES "ggs"): it runs --ggen
GG = ["-l5k", "-d5k"]
PORTED = {
    "--call": (["-xasm", "--call"] + GG, None, ["asm"]),
    "--cov": (["--cov"], None, ["r"]),
    "--ggen": (["-xasm", "--ggen"] + GG, None, ["asm"]),
    "--ggen=simple": (["-xasm", "--ggen=simple"] + GG,
                      ["-xasm", "--ggen"] + GG, ["asm"]),
    "-xggs": (["-xggs"] + GG, None, ["asm"]),
    "--gg-min-end-cnt": (["-xggs", "--gg-min-end-cnt", "3"] + GG, None,
                         ["asm"]),
    "--gg-min-end-frac": (["-xggs", "--gg-min-end-frac", "0.3"] + GG, None,
                          ["asm"]),
    "--gg-match-pen": (["-xggs", "--gg-match-pen", "5"] + GG, None,
                       ["asm"]),
    "--ins-qovlp": (["-xggs", "--ins-qovlp=yes"] + GG, None, ["asm"]),
    "--inv": (["-xggs", "--inv=no"] + GG, None, ["asm"]),
    "-l": (["-xggs", "-l", "20k", "-d5k"], None, ["asm"]),
    "-d": (["-xggs", "-l5k", "-d", "12k"], None, ["asm"]),
    "-q": (["-xggs", "-q", "40"] + GG, None, ["asm"]),
    "-L": (["-xggs", "-L", "30"] + GG, None, ["asm"]),
    "--gwfa-device": (["--gwfa-device"], None, ["r"]),
    "-c -xggs": (["-cxggs"] + GG, None, ["asm"]),
    "-c --ggen=simple": (["-c", "-xasm", "--ggen=simple"] + GG,
                         ["-c", "-xasm", "--ggen"] + GG, ["asm"]),
    "-c --gwfa-device": (["-c", "--gwfa-device"], None, ["r"]),
    "-c --call": (["-cxasm", "--call"] + GG, None, ["asm"]),
    "-c --cov": (["-c", "--cov"], None, ["r"]),
}


@pytest.mark.parametrize("case", list(PORTED))
def test_ported_option_matches_jax(files, case):
    port, jax, qs = PORTED[case]
    paths = [files["g"]] + [files[q] for q in qs]
    rc, want, err = run(jax_cli.main, ["-t1"] + (jax or port) + paths)
    assert rc == 0, err
    assert want.count("\n") >= 5
    dev = "cpu" if "--gwfa-device" in port else "none"
    rc, got, err = run(cli.main, ["-t2", "--device", dev] + port + paths)
    assert rc == 0, err
    assert got == want, case
    if "--gwfa-device" in port:
        assert "device GWFA bridges" in err


def test_bad_arguments_exit_1(files):
    for argv in (["-x", "xyz"], ["--device", "tpu"], ["--no-such"]):
        rc, out, err = run(cli.main, argv + [files["g"], files["r"]])
        assert (rc, out) == (1, ""), argv
    assert run(cli.main, [])[0] == 1
