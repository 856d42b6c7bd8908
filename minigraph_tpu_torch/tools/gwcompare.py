"""Time the GWFA bridge kernel of several source trees on one card, in
turns, on the same inputs.

    python -m minigraph_tpu_torch.tools.gwcompare [--out DIR] [--reps N]
        TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for example a
`git archive` of another commit unpacked into a directory).  This
process first writes the inputs into DIR with this checkout's package
and chip_smoke.py, before any CUDA call: chip_smoke.py's 5 Mb bubble
graph and its 1152 reads, the host-only GAF, and chip_smoke.py phase
9's three launch shapes of `gwfa_batch`: the 16-job chunk of the QCAP
256 bucket (harvested jobs), the 16-job chunk of the QCAP 1024 bucket
(its harvested jobs, topped up with synthetic ones) and run (b2)'s
launch (every harvested job of the 256 bucket, padded to a multiple of
16).  Then each TREE, in the order given (e.g. parent, change, change,
parent), runs in a child process with TREE first on sys.path: it builds
that tree's kernels, runs its `gwfa_batch` on the saved jobs, holds it
bitwise against its plain `gwfa_batch_ref`, times it (CUDA events over
back-to-back calls, and replayed from a CUDA graph), reads its clock
buffer's phase cycles where it has one, times its pool's wrapper on
(b1)'s launch shape (one harvested job in a 16-row chunk, one call
after another on one thread: the host time of the call, of its
pack_jobs and of its launch call, and the pool's kernel_ms and
batch_ms), and maps the reads with that tree's
`chip_smoke.gwfa_map_run`: run (b1) (the front pinned, one pool call a
read) after a warm-up run, then (b2) (no front, one call a batch), each
with the same wrapper times summed over its calls.  This process then
checks that every run gave the same kernel outputs, the same pool
counts and GAF bytes equal to the host-only run, and prints one JSON
line a run and the card's name and power limit (tools/_treecompare.py
runs the trees).  Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import contextlib
import hashlib
import pickle
import sys
import time
from pathlib import Path

import torch

try:
    from . import _treecompare as tc
except ImportError:         # run as a script, as each tree's worker is
    import _treecompare as tc

ROOT = tc.ROOT
OUT_KEYS = ("s", "flags", "walk", "n_walk")


def make_inputs(work: Path) -> None:
    """chip_smoke.py's graph, reads and host-only GAF, and phase 9's
    three launch shapes."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from minigraph_tpu_torch.align.gwfa_device import J_BUCKET
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.options import IndexOptions, MapOptions
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa,
                                                 write_fasta)
    ref = make_reference(5_000_000, seed=42)
    hap = write_bubble_rgfa(ref, 43, str(work / "mhc5m.gfa"))
    short = simulate_reads([hap], 1024, seed=44, mean_len=1300,
                           min_len=800, max_len=1900)
    long_ = simulate_reads([hap], 128, seed=45, mean_len=15000,
                           min_len=2100, max_len=30000)
    reads = str(work / "reads.fa")
    write_fasta(reads, short + long_)
    io_, mo = IndexOptions(), MapOptions()
    gi = build_index(read_gfa(str(work / "mhc5m.gfa")), io_.k, io_.w, mo)
    host_gaf, _ = cs.host_run(gi, mo, [reads])
    _, per, _ = cs.gwfa_harvest(gi, mo, reads, host_gaf)
    (c256, q256, h256), (c1024, q1024, h1024) = cs.gwfa_chunks(gi, per)
    shapes = [
        {"name": "chunk256", "jobs": c256, "qcap": q256, "J": J_BUCKET,
         "harvested": h256},
        {"name": "chunk1024", "jobs": c1024, "qcap": q1024, "J": J_BUCKET,
         "harvested": h1024},
        {"name": "b2", "jobs": per[0], "qcap": q256,
         "J": J_BUCKET * -(-len(per[0]) // J_BUCKET),
         "harvested": len(per[0])}]
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"shapes": shapes,
                     "host_sha256": hashlib.sha256(
                         host_gaf.encode()).hexdigest()}, f)


def cycle_summary(clk, columns, phases) -> dict:
    """A clock buffer's columns (ops/gwfa.py CLK_COLUMNS): each phase's
    cycles summed over the jobs and its share; the longest job's cycles
    a phase and its other columns, with its synchronisations and cycles
    a wave."""
    c = clk.to(torch.float64)
    n = len(phases)
    tot = c[:, :n].sum(1)
    j = int(tot.argmax())
    col = {name: int(c[j, i]) for i, name in enumerate(columns)}
    waves = max(1, col["waves"])
    all_sum = float(c[:, :n].sum())
    return {
        "sum": {p: int(c[:, i].sum()) for i, p in enumerate(phases)},
        "share": {p: round(float(c[:, i].sum()) / max(1.0, all_sum), 4)
                  for i, p in enumerate(phases)},
        "longest": {"job": j, "cycles": int(tot[j]), **col,
                    "syncs_a_wave": round(col["syncs"] / waves, 1),
                    "cycles_a_wave": round(float(tot[j]) / waves, 1)}}


@contextlib.contextmanager
def wrapper_clock(pool_mod):
    """Host seconds of the pool's `_solve` calls and, inside them, of
    its pack_jobs calls (the jobs filled and sent to the card) and of
    its launch calls (gwfa_launch where the tree has it, else
    gwfa_batch), summed into the dict it yields with the number of
    calls; the rest of a call is the copy back, with its wait for the
    kernel.  pool_mod: the tree's align/gwfa_device.py."""
    acc = {"calls": 0, "solve": 0.0, "pack": 0.0, "launch": 0.0}
    launch = ("gwfa_launch" if hasattr(pool_mod, "gwfa_launch")
              else "gwfa_batch")
    saved = []
    for owner, attr, key in ((pool_mod.DeviceGwfaPool, "_solve", "solve"),
                             (pool_mod, "pack_jobs", "pack"),
                             (pool_mod, launch, "launch")):
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def timed(*a, _fn=fn, _key=key, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc[_key] += time.perf_counter() - t0
                acc["calls"] += _key == "solve"
        setattr(owner, attr, timed)
    try:
        yield acc
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def wrapper_ms(acc) -> dict:
    """wrapper_clock's sums in ms, the rest of the calls beside them."""
    return {"calls": acc["calls"], "solve_ms": acc["solve"] * 1e3,
            "pack_ms": acc["pack"] * 1e3, "launch_ms": acc["launch"] * 1e3,
            "rest_ms": (acc["solve"] - acc["pack"] - acc["launch"]) * 1e3}


def worker(tree: Path, work: Path, tag: str, reps: int) -> dict:
    """One tree's run: its kernel on the saved jobs, its pool routes on
    the reads."""
    import inspect
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from minigraph_tpu_torch import kernels
    from minigraph_tpu_torch.align import gwfa_device as pool_mod
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.ops import gwfa as gw
    from minigraph_tpu_torch.options import IndexOptions, MapOptions
    from minigraph_tpu_torch.utils import native
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{kernels.__file__} is not from {tree}")
    kernels.build()
    native.build()
    with open(work / "inputs.pkl", "rb") as f:
        data = pickle.load(f)
    io_, mo = IndexOptions(), MapOptions()
    gi = build_index(read_gfa(str(work / "mhc5m.gfa")), io_.k, io_.w, mo)
    pool0 = pool_mod.DeviceGwfaPool(gi, device="cuda")
    gd = pool0.graph()
    has_clock = "clock" in inspect.signature(gw.gwfa_batch).parameters
    rows, outs = [], {}
    for sh in data["shapes"]:
        J, qcap = sh["J"], sh["qcap"]
        args = gw.pack_jobs(sh["jobs"][:J], qcap, J, "cuda")
        ref = gw.gwfa_batch_ref(gd, *args)
        got = gw.gwfa_batch(gd, *args)
        bad = [k for k in OUT_KEYS if not torch.equal(got[k], ref[k])]
        if bad:
            raise AssertionError(f"{sh['name']}: {bad} differ from the "
                                 "plain version")
        outs[sh["name"]] = {k: got[k].cpu() for k in OUT_KEYS}
        row = {"shape": sh["name"], "J": J, "qcap": qcap,
               "ms": cs.cuda_time(lambda: gw.gwfa_batch(gd, *args), reps),
               "graph_ms": cs.graph_time(lambda: gw.gwfa_batch(gd, *args),
                                         reps)}
        if has_clock:
            clk = torch.zeros((J, gw.CLK_N), dtype=torch.int64,
                              device="cuda")
            timed = gw.gwfa_batch(gd, *args, clock=clk)
            if any(not torch.equal(timed[k], ref[k]) for k in OUT_KEYS):
                raise AssertionError("the clock buffer changed the outputs")
            row["cycles"] = cycle_summary(clk.cpu(), gw.CLK_COLUMNS,
                                          gw.CLK_PHASES)
        rows.append(row)
    torch.save(outs, work / f"out_{tag}.pt")
    # the pool's wrapper alone at (b1)'s launch shape: one job a call
    sh = data["shapes"][0]
    one = sh["jobs"][:1]
    pool0._solve(one, sh["qcap"], sh["J"])                    # warm-up
    k0, b0 = pool0.kernel_ms, pool0.batch_ms
    n = 10 * reps
    with wrapper_clock(pool_mod) as acc:
        for _ in range(n):
            pool0._solve(one, sh["qcap"], sh["J"])
    alone = {k: v / n for k, v in wrapper_ms(acc).items() if k != "calls"}
    alone.update(calls=n, kernel_ms=(pool0.kernel_ms - k0) / n,
                 batch_ms=(pool0.batch_ms - b0) / n)
    runs = {}
    cs.gwfa_map_run(gi, mo, str(work / "reads.fa"), True)    # warm-up
    for name, front in (("b1", True), ("b2", False)):
        with wrapper_clock(pool_mod) as acc:
            gaf, st, pool, lc = cs.gwfa_map_run(
                gi, mo, str(work / "reads.fa"), front)
        runs[name] = {"map_ms": st["map_ms"], "n_jobs": pool.n_jobs,
                      "n_device": pool.n_device,
                      "n_flagged": pool.n_flagged,
                      "n_batches": pool.n_batches,
                      "launches": lc["gwfa"], "kernel_ms": pool.kernel_ms,
                      "batch_ms": pool.batch_ms,
                      "wrapper": wrapper_ms(acc),
                      "gaf_sha256": hashlib.sha256(
                          gaf.encode()).hexdigest()}
    ptxas = (cs.ptxas_lines(kernels.build_log, ("gwfa_kernel",))
             if kernels.build_log else [])
    return {"tree": str(tree), "run": tag, "ptxas": ptxas, "gwfa": rows,
            "wrapper_alone": alone, "maps": runs}


def check(results, work: Path) -> str:
    """Every run's kernel outputs and pool counts against run 0's, its
    GAF bytes against the host-only run, kernel_ms within batch_ms."""
    with open(work / "inputs.pkl", "rb") as f:
        host_sha = pickle.load(f)["host_sha256"]
    first = torch.load(work / "out_0.pt")
    counts = ("n_jobs", "n_device", "n_flagged", "n_batches", "launches")
    for i, res in enumerate(results):
        outs = torch.load(work / f"out_{i}.pt")
        for name, o in outs.items():
            bad = [k for k in OUT_KEYS if not torch.equal(o[k],
                                                          first[name][k])]
            if bad:
                raise AssertionError(f"run {i} {name}: {bad} differ from "
                                     "run 0")
        for name, m in res["maps"].items():
            if m["gaf_sha256"] != host_sha:
                raise AssertionError(f"run {i} {name}: GAF bytes differ "
                                     "from the host-only run")
            m0 = results[0]["maps"][name]
            if any(m[k] != m0[k] for k in counts):
                raise AssertionError(f"run {i} {name}: pool counts differ "
                                     f"from run 0: {m} against {m0}")
            if not 0 < m["kernel_ms"] <= m["batch_ms"]:
                raise AssertionError(f"run {i} {name}: kernel_ms outside "
                                     "batch_ms")
    return ("the same gwfa outputs, pool counts and GAF bytes equal to the "
            "host-only run")


def main(argv=None) -> int:
    return tc.main(argv, __file__, __doc__, make_inputs, worker, check)


if __name__ == "__main__":
    sys.exit(main())
