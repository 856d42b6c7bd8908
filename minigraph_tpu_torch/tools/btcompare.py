"""Time the backtrack of several source trees on one card, in turns, on
the same inputs.

    python -m minigraph_tpu_torch.tools.btcompare [--out DIR] [--reps N]
        TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for example a
`git archive` of another commit unpacked into a directory).  This
process first writes the inputs into DIR with this checkout's package
and chip_smoke.py: chip_smoke.py's 5 Mb bubble graph and its 1152
reads, and for each of the device front's three buckets one full
batch's anchor planes and K2 outputs (the backtrack's inputs on the
main path, as chip_smoke.py check_buckets makes them).  Then each TREE,
in the order given (e.g. parent, change, change, parent), runs in a
child process with TREE first on sys.path: it builds that tree's
kernels, runs its `backtrack_compact` on the saved inputs, times it
(CUDA events over back-to-back calls, and replayed from a CUDA graph;
the clock buffer's phase cycles where the tree has one) and maps the
reads twice through that tree's `chip_smoke.device_run` (the split
pinned at share 0), reporting the second run's stage ms.  This process
then checks that every run gave the same backtrack outputs and the same
GAF bytes, and prints one JSON line a run and the card's name and power
limit (tools/_treecompare.py runs the trees).  Needs one CUDA card;
exits non-zero without one.
"""
from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import torch

try:
    from . import _treecompare as tc
except ImportError:         # run as a script, as each tree's worker is
    import _treecompare as tc

ROOT = tc.ROOT
BUCKETS = (2048, 8192, 32768)
OUT_KEYS = ("c_axh", "c_axl", "c_ayh", "c_ayl", "u_sc", "u_cnt", "n_u",
            "n_v", "bt_unsure", "steps")


def make_inputs(work: Path) -> None:
    """chip_smoke.py's graph and reads, and the backtrack's inputs at
    each bucket (chip_smoke.py main and check_buckets)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.mapping.device_front import UCAP, DeviceFront
    from minigraph_tpu_torch.ops.chain_exact import lchain_dp_exact_win
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
    mid = simulate_reads([hap], 128, seed=46, mean_len=5000, min_len=2100,
                         max_len=8000)
    write_fasta(str(work / "reads.fa"), short + long_)
    io_, mo = IndexOptions(), MapOptions()
    gi = build_index(read_gfa(str(work / "mhc5m.gfa")), io_.k, io_.w, mo)
    front = DeviceFront(gi, mo, device="cuda")
    batches = ([s for _, s in short[:256]],
               [s for _, s in mid if 2048 < len(s) <= 8192],
               [s for _, s in long_ if 8192 < len(s) <= 32768])
    shapes = []
    for seqs, pad_len in zip(batches, BUCKETS):
        args, W, T = cs.chain_inputs(front, seqs, pad_len)
        f, p, _ = lchain_dp_exact_win(*args, window=W, tile=T)
        shapes.append({"f": f.cpu(), "p": p.cpu(), "n_a": args[4].cpu(),
                       "planes": [x.cpu() for x in args[:4]]})
    kw = dict(min_cnt=int(mo.min_lc_cnt), min_sc=int(mo.min_lc_score),
              max_drop=int(mo.bw), ucap=UCAP)
    torch.save({"shapes": shapes, "kw": kw}, work / "inputs.pt")


def worker(tree: Path, work: Path, tag: str, reps: int) -> dict:
    """One tree's run: its kernels, its backtrack on the saved inputs,
    its device path on the reads."""
    import inspect
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from minigraph_tpu_torch import kernels
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.ops import backtrack as bt
    from minigraph_tpu_torch.options import IndexOptions, MapOptions
    from minigraph_tpu_torch.utils import native
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{kernels.__file__} is not from {tree}")
    kernels.build()
    native.build()
    data = torch.load(work / "inputs.pt")
    kw = data["kw"]
    has_clock = "clock" in inspect.signature(bt.backtrack_compact).parameters
    rows, outs = [], []
    for sh in data["shapes"]:
        args = [sh["f"].cuda(), sh["p"].cuda(), sh["n_a"].cuda(),
                *(x.cuda() for x in sh["planes"])]
        out = bt.backtrack_compact(*args, **kw)
        outs.append({k: out[k].cpu() for k in OUT_KEYS})
        row = {"shape": list(sh["f"].shape),
               "ms": cs.cuda_time(lambda: bt.backtrack_compact(*args, **kw),
                                  reps),
               "graph_ms": cs.graph_time(
                   lambda: bt.backtrack_compact(*args, **kw), reps)}
        if has_clock:
            clk = torch.zeros((sh["f"].shape[0], 4), dtype=torch.int64,
                              device="cuda")
            bt.backtrack_compact(*args, clock=clk, **kw)
            cyc = clk.to(torch.float64)
            row["cycles"] = {name: [int(cyc[:, i].max()),
                                    round(float(cyc[:, i].mean()), 1)]
                             for i, name in enumerate(
                                 ("order", "walk", "flags", "compact"))}
        rows.append(row)
    torch.save(outs, work / f"out_{tag}.pt")
    io_, mo = IndexOptions(), MapOptions()
    gi = build_index(read_gfa(str(work / "mhc5m.gfa")), io_.k, io_.w, mo)
    reads = str(work / "reads.fa")
    cs.device_run(gi, mo, reads)              # pays one-time costs
    kernels.reset_launches()
    gaf, st = cs.device_run(gi, mo, reads)
    return {"tree": str(tree), "run": tag, "backtrack": rows,
            "stage_ms": st["stage_ms"], "map_ms": st["map_ms"],
            "n_batches": st["n_batches"],
            "backtrack_launches": kernels.launches["backtrack"],
            "gaf_sha256": hashlib.sha256(gaf.encode()).hexdigest(),
            "gaf_bytes": len(gaf)}


def check(results, work: Path) -> str:
    """Every run's backtrack outputs and GAF bytes against run 0's."""
    first = torch.load(work / "out_0.pt")
    for i, res in enumerate(results[1:], 1):
        outs = torch.load(work / f"out_{i}.pt")
        for s0, s1 in zip(first, outs):
            bad = [k for k in OUT_KEYS if not torch.equal(s0[k], s1[k])]
            if bad:
                raise AssertionError(f"run {i} differs from run 0: {bad}")
        if res["gaf_sha256"] != results[0]["gaf_sha256"]:
            raise AssertionError(f"run {i}: GAF bytes differ from run 0")
    return "the same backtrack outputs and GAF bytes"


def main(argv=None) -> int:
    return tc.main(argv, __file__, __doc__, make_inputs, worker, check)


if __name__ == "__main__":
    sys.exit(main())
