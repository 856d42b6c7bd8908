"""The options the port refused until it had their stages, each held
against the JAX command line in process: --seed-device, --write-mz,
--tpu, --no-kalloc and the nine --dbg-* dumps.  Each case compares
stdout byte for byte, and the option's dump lines on stderr line for
line (--dbg-qname's wall-clock stage times masked, every other field
exact).  The port runs with --device cpu: a device front on the CPU that
the debug bits keep every read off, as the JAX package keeps its front.
--tpu means --device cuda in the port; with no card here the test hands
the front the CPU in its place and checks that the card was asked for;
its JAX counterpart is the host run (the JAX front writes the same
bytes; it compiles for ~50 s on a CPU).  Tolerance: exact equality."""
import contextlib
import io
import re

import numpy as np
import pytest
import torch

from minigraph_tpu import cli as jax_cli
from minigraph_tpu import options as jax_options
from minigraph_tpu.mapping import mapper as jax_mapper
from minigraph_tpu_torch import cli, options
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                             make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("debug")
    ref = make_reference(200_000, seed=121)
    hap = write_bubble_rgfa(ref, 122, str(d / "g.gfa"), seg_len=20_000)
    reads = simulate_reads([hap, ref], 24, seed=123, mean_len=1500,
                           min_len=300, max_len=3000)
    write_fasta(str(d / "r.fa"), reads)
    # reads whose two flanks hold a 6 kb stretch the graph does not have:
    # -c aligns that gap with an exact WFA of score >= 10000, the long-WFA
    # dumps' case (a file of their own: the CPU front's 32 kb bucket runs
    # the plain chain for ~40 s)
    rng = np.random.default_rng(124)
    junk = "".join(rng.choice(list("ACGT"), 6000))
    write_fasta(str(d / "gap.fa"),
                reads[:4] + [("gap6k", hap[30_000:36_000] + junk
                              + hap[42_000:48_000])])
    asm = make_haplotype(ref, 125, sv_per_mb=40)
    write_fasta(str(d / "asm.fa"),
                cut_contigs(asm, 126, mean_len=6000, min_len=1000,
                            max_len=20000, long_every=10, long_len=40000))
    return {k: str(d / f"{k}.{ext}") for k, ext in
            (("g", "gfa"), ("r", "fa"), ("gap", "fa"), ("asm", "fa"))}


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


QNAME = ("QR\t", "Q1\t", "Q2\t", "Q3\t", "Q4\t", "Q5\t", "QM\t")
GG = ["-l5k", "-d5k"]
# (port options, JAX options where they differ, query file, the stderr
# prefixes of the option's dump lines, at least this many such lines)
CASES = {
    "--seed-device": (["-xasm", "-S", "--seed-device"], None, "asm", (), 0),
    "--write-mz": (["--write-mz"], None, "r", (), 0),
    "--tpu": (["--tpu"], [], "r", (), 0),
    "--no-kalloc": (["--no-kalloc"], None, "r", (), 0),
    "--dbg-seed": (["--dbg-seed"], None, "r", ("RS\t", "SD\t"), 1000),
    # LC lines go to stdout
    "--dbg-lchain": (["--dbg-lchain"], None, "r", (), 0),
    "--dbg-gc1": (["--dbg-gc1"], None, "r", ("  [dst", " [opt", "[best"),
                  5),
    "--dbg-shortk": (["--dbg-shortk"], None, "r", (), 0),
    "--dbg-qname": (["--dbg-qname"], None, "r", QNAME, 7 * 24),
    "--dbg-insert": (["-cxggs", "--dbg-insert"] + GG, None, "asm",
                     ("IN\t", "IP\t", "IQ\t", "IS\t"), 4),
    "--dbg-lc-prof": (["--dbg-lc-prof"], None, "r", ("LP\t",), 25),
    "--dbg-mwf-long": (["-c", "--dbg-mwf-long"], None, "gap", ("WL\t",),
                       1),
    "--dbg-mwf-seq": (["-c", "--dbg-mwf-seq"], None, "gap",
                      ("WL\t", "WT\t", "WQ\t"), 3),
}
_TIME = re.compile(r"^(Q[1-5]\t.*\t)[0-9]+\.[0-9]{3}$")


def dump_lines(err, prefixes):
    return [_TIME.sub(r"\1<t>", ln) for ln in err.splitlines()
            if ln.startswith(prefixes)]


@pytest.mark.parametrize("case", list(CASES))
def test_former_refusal_matches_jax(monkeypatch, files, case):
    port, jax, q, prefixes, n_min = CASES[case]
    # process-wide state of both packages, restored after the test
    for dbg in (options.DBG, jax_options.DBG):
        monkeypatch.setitem(dbg, "flag", 0)
    monkeypatch.setitem(jax_mapper.SEED_DEVICE, "on", False)
    monkeypatch.setitem(mapper.SEED_DEVICE, "on", False)
    monkeypatch.setitem(mapper.SEED_DEVICE, "device", "cuda")
    asked = []
    real = mapper.resolve_device

    def no_card(device):
        # --tpu: the front gets the CPU in place of the card
        asked.append(device)
        return real("cpu" if device == "cuda" else device)

    monkeypatch.setattr(mapper, "resolve_device", no_card)
    paths = [files["g"], files[q]]
    rc, want, jerr = run(jax_cli.main, ["-t1"] + (port if jax is None
                                                  else jax) + paths)
    assert rc == 0, jerr
    assert want.count("\n") >= 4
    rc, got, err = run(cli.main, ["-t2", "--device", "cpu"] + port + paths)
    assert rc == 0, err
    assert got == want, case
    assert dump_lines(err, prefixes) == dump_lines(jerr, prefixes)
    assert len(dump_lines(err, prefixes)) >= n_min
    if case == "--tpu":
        assert asked == ["cuda"]
    elif q != "asm":
        assert asked == ["cpu"]
    if case == "--dbg-lchain":
        assert sum(ln.startswith("LC\t") for ln in got.splitlines()) >= 25
    if case == "--write-mz":
        assert sum(ln.startswith("*\t") and ln.count("\t") == 11
                   for ln in got.splitlines()) >= 25
