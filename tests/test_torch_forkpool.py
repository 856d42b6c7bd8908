"""The port's fork pool (mapping/mapper.py _map_fragments_parallel, the
JAX package's pool of the same name) on the CPU: the Python reader loop
with --vc (no front, an output shape the native batch cannot write) and
graph generation (-xggs and -cxggs, then -xasm --call, -cxasm --call
and --cov on the JAX package's -cxggs graph of one sample) at -t 4
against -t 1 and the JAX command line at -t 1;
the guard that keeps a process holding a CUDA context from forking
(torch.cuda.is_initialized patched to true: the same bytes mapped in
this process and one log line saying why); and the GWFA pool route
without a front on the plain pool (map_files(device=None,
gwfa_device="cpu")), which forks as the JAX package does, so the pool
gets no jobs.  Counts of the pool's calls (a wrapper around
_map_fragments_parallel) show which runs forked.  Inputs from
tools/synth.py.  Tolerance: exact equality.  Each test has its own
timeout: a forked child inherits the parent's threads' locks.

The JAX package's pool maps every read with fast_emit=True
(minigraph_tpu/mapping/mapper.py:1239), so without -c its graph
generation at -t > 1 loses the chains of single-segment queries (the
worker gets back only their GAF text, written natively):
test_jax_pool_fault records
that, and the port's workers map as map_one does (fast_emit=False) and
keep the -t 1 bytes."""
import contextlib
import io
import re
import signal

import pytest
import torch

from minigraph_tpu import cli as jax_cli
from minigraph_tpu_torch import cli
from minigraph_tpu_torch.ggen import driver
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.options import IndexOptions, MapOptions
from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                             make_reference, simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

TIMEOUT = 120


@pytest.fixture(autouse=True)
def time_limit():
    def expired(*_):
        raise TimeoutError(f"test exceeded {TIMEOUT} s")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TIMEOUT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("forkpool")
    ref = make_reference(200_000, seed=81)
    hap = write_bubble_rgfa(ref, 82, str(d / "g.gfa"), seg_len=20_000)
    write_fasta(str(d / "r.fa"),
                simulate_reads([hap, ref], 40, seed=83, mean_len=3000,
                               min_len=500, max_len=6000))
    out = {"g": str(d / "g.gfa"), "r": str(d / "r.fa")}
    for i, seed in enumerate((84, 86)):
        sample = make_haplotype(ref, seed, sv_per_mb=40)
        write_fasta(str(d / f"s{i}.fa"),
                    cut_contigs(sample, seed + 1, mean_len=15000,
                                min_len=4000, max_len=30000))
        out[f"s{i}"] = str(d / f"s{i}.fa")
    # the graph of the call and cov cases: the JAX package's -cxggs of
    # sample 0 (-t 1), so that the queries hold bubbles against it
    out["gg"] = str(d / "gg.gfa")
    run(jax_cli.main, ["-t1", "-cxggs", "-l5k", "-d5k", "-o", out["gg"],
                       out["g"], out["s0"]])
    return out


@pytest.fixture
def pool_calls(monkeypatch):
    """The fork pool's calls: (number of items, workers) each."""
    calls = []
    real = mapper._map_fragments_parallel

    def counted(gi, opt, items, n_threads, **kw):
        calls.append((len(items), n_threads))
        return real(gi, opt, items, n_threads, **kw)

    monkeypatch.setattr(mapper, "_map_fragments_parallel", counted)
    monkeypatch.setattr(driver, "_map_fragments_parallel", counted)
    return calls


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    assert rc == 0, err.getvalue()
    return out.getvalue(), err.getvalue()


# name: (options, graph, queries)
CASES = {"vc": (["--vc"], "g", ["r"]),
         "ggs": (["-xggs", "-l5k", "-d5k"], "g", ["s0", "s1"]),
         "ggs_cigar": (["-cxggs", "-l5k", "-d5k"], "g", ["s0", "s1"]),
         "call": (["-xasm", "--call", "-l5k"], "gg", ["s1"]),
         "call_cigar": (["-cxasm", "--call", "-l5k"], "gg", ["s1"]),
         # asm's --min-cov-blen is 100k: no contig here would count
         "cov": (["-xasm", "--cov", "-l5k", "--min-cov-blen", "1k"], "gg",
                 ["s1"])}


def case_paths(files, case):
    opts, g, qs = CASES[case]
    return opts, [files[g]] + [files[q] for q in qs]


@pytest.mark.parametrize("case", list(CASES))
def test_pool_matches_one_thread_and_jax(files, pool_calls, case):
    opts, paths = case_paths(files, case)
    want, _ = run(jax_cli.main, ["-t1"] + opts + paths)
    one, _ = run(cli.main, ["-t1", "--device", "none"] + opts + paths)
    assert not pool_calls
    got, _ = run(cli.main, ["-t4", "--device", "none"] + opts + paths)
    assert pool_calls and all(t == 4 for _, t in pool_calls)
    assert sum(n for n, _ in pool_calls) >= (40 if case == "vc" else 4)
    assert got == one == want
    if case.startswith("ggs"):
        n_seg = sum(ln.startswith("S\t") for ln in got.splitlines())
        assert n_seg > sum(ln.startswith("S\t") for ln in open(files["g"]))
    elif case.startswith("call"):
        assert got.count("\n") > 0
    elif case == "cov":
        assert n_covered(got) > 0


def n_covered(gfa):
    """Segments and links with a coverage above 0."""
    return sum(float(v) > 0 for v in re.findall(r"\tdc:f:([^\t\n]+)", gfa))


@pytest.mark.parametrize("case", list(CASES))
def test_cuda_context_maps_in_process(files, pool_calls, monkeypatch, case):
    """A process that holds a CUDA context does not fork: the same bytes,
    mapped here (the JAX package's -t 1 bytes), and one line in the
    log."""
    opts, paths = case_paths(files, case)
    want, _ = run(jax_cli.main, ["-t1"] + opts + paths)
    one, _ = run(cli.main, ["-t1", "--device", "none"] + opts + paths)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    got, err = run(cli.main, ["-t4", "--device", "none"] + opts + paths)
    assert not pool_calls
    assert got == one == want
    lines = [ln for ln in err.splitlines() if "no fork pool" in ln]
    assert lines and "CUDA context" in lines[0]
    # one line a file loop (the reads), one a sample (graph generation)
    assert len(lines) == len(CASES[case][2])


def test_gwfa_pool_without_front_forks(files, pool_calls):
    """With the GWFA pool on the CPU and no front the reader loop forks,
    as the JAX package's does: the workers bridge on the host engine and
    the pool gets no jobs; the bytes equal the host-only run."""
    io_, mo = IndexOptions(), MapOptions()
    mo.flag |= mapper.MG_M_VERTEX_COOR

    def map_run(**kw):
        buf, st = io.StringIO(), {}
        mapper.map_files(read_gfa(files["g"]), [files["r"]], io_, mo,
                         out=buf, stats=st, **kw)
        return buf.getvalue(), st

    host, _ = map_run(n_threads=1, device=None)
    got, st = map_run(n_threads=2, device=None, gwfa_device="cpu")
    assert pool_calls and st["gwfa_jobs"] == 0
    assert got == host


def test_seed_device_on_card_refuses_fork(monkeypatch):
    """--seed-device on the card keeps the workers off a fork."""
    monkeypatch.setitem(mapper.SEED_DEVICE, "on", True)
    monkeypatch.setitem(mapper.SEED_DEVICE, "device", "cuda")
    assert "seed-device" in mapper.fork_refused()
    monkeypatch.setitem(mapper.SEED_DEVICE, "device", "cpu")
    assert mapper.fork_refused() is None


@pytest.mark.parametrize("case", ["ggs", "ggs_cigar", "call", "call_cigar",
                                  "cov"])
def test_jax_pool_fault(files, case):
    """A fault of the reference, recorded: the JAX package's -t 4 graph
    generation without -c differs from its own -t 1 (fewer segments,
    fewer bubble calls), while the port's -t 4 keeps the -t 1 bytes
    (test_pool_matches_one_thread_and_jax).  -c and --cov are not
    touched: their flags keep the native emit off (the JAX package's
    _EMIT_BAIL_FLAGS)."""
    opts, paths = case_paths(files, case)
    one, _ = run(jax_cli.main, ["-t1"] + opts + paths)
    four, _ = run(jax_cli.main, ["-t4"] + opts + paths)
    n_one, n_four = (sum(ln.startswith("S\t") for ln in x.splitlines())
                     if case.startswith("ggs") else x.count("\n")
                     for x in (one, four))
    print(f"JAX {case}: -t1 {one.count(chr(10))} lines ({n_one} counted), "
          f"-t4 {four.count(chr(10))} lines ({n_four} counted)")
    if case in ("ggs", "call"):
        assert n_four < n_one
    else:
        assert four == one
