"""Distributed mapping of the port (minigraph_tpu_torch/parallel/dist.py)
on the CPU: two gloo processes of `python -m
minigraph_tpu_torch.parallel.dist --device cpu` (fragment ordinal mod 2
picks the rank, each rank runs a DeviceFront on the CPU), rank 0's
standard output against the port's single-process command line and the
JAX package's (`python -m minigraph_tpu`, here in process with -t1),
and rank 1's, which stays empty.  Cases: GAF of long reads, --cov (the
graph with dc:f tags, the ranks' vectors summed on rank 0), and paired
reads in two files with -xsr --frag (mates read in step, flipped and
merged as the single-process loop does).  The JAX package's own
distributed test (tests/test_distributed.py) reads a graph that these
tests do not need.  Inputs from tools/synth.py.  Tolerance: exact
equality."""
import contextlib
import io
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from minigraph_tpu import cli as jax_cli
from minigraph_tpu_torch import cli
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_pairs,
                                             simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    ref = make_reference(150_000, seed=91)
    hap = write_bubble_rgfa(ref, 92, str(d / "g.gfa"), seg_len=15_000)
    # reads of the 2 kb bucket, so the CPU front's plain chain stays quick
    write_fasta(str(d / "r.fa"),
                simulate_reads([hap, ref], 60, seed=93, mean_len=1200,
                               min_len=300, max_len=2000))
    r1, r2 = simulate_pairs(hap, 80, seed=94)
    write_fasta(str(d / "r1.fa"), r1)
    write_fasta(str(d / "r2.fa"), r2)
    return {k: str(d / f"{k}.fa") for k in ("r", "r1", "r2")} \
        | {"g": str(d / "g.gfa")}


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, err.getvalue()
    return out.getvalue()


def dist_run(argv, n=2):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "minigraph_tpu_torch.parallel.dist",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(r)] + argv, cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        res = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, res):
        assert p.returncode == 0, err[-3000:]
    return res


CASES = {"gaf": ([], ["r"]),
         "cov": (["--cov"], ["r"]),
         "frag": (["-xsr", "--frag"], ["r1", "r2"])}


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_match_single(files, case):
    opts, qs = CASES[case]
    paths = [files["g"]] + [files[q] for q in qs]
    want = run(jax_cli.main, ["-t1"] + opts + paths)
    single = run(cli.main, ["-t1", "--device", "cpu"] + opts + paths)
    assert single == want
    (out0, err0), (out1, err1) = dist_run(["--device", "cpu"] + opts + paths)
    assert out0 == want
    assert out1 == ""
    # each rank mapped its share of the fragments with its own front
    for r, err in enumerate((err0, err1)):
        assert f"rank {r} of 2: mapped" in err
        assert f"rank {r}: front launches" in err
    if case == "cov":
        assert "\tdc:f:" in out0
    else:
        assert out0.count("\n") >= 40


def test_dist_refuses_output_file(files, tmp_path):
    """Every rank would open -o's file: dist.main refuses it before it
    joins the process group."""
    from minigraph_tpu_torch.parallel import dist
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = dist.main(["--coordinator", "127.0.0.1:1", "--num-processes",
                        "2", "--process-id", "0", "-o",
                        str(tmp_path / "x.gaf"), files["g"], files["r"]])
    assert rc == 1 and "-o" in err.getvalue()
