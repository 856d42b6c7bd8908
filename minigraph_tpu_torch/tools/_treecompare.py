"""The runner the compare tools share (tools/btcompare.py,
tools/gwcompare.py, tools/wxcompare.py): time one kernel of several
source trees on one card, in turns, on the same inputs.

A tool hands `main` three functions.  make_inputs(work) writes the
inputs into the directory `work` with this checkout's package.
worker(tree, work, tag, reps) runs one tree and returns its results as
a dict (one JSON line).  check(results, work) raises where the runs
disagree and returns a phrase for what they share.  Each TREE, in the
order given (e.g. parent, change, change, parent), runs in a child
process: the tool's file as a script, with --worker, so that a tree
without the tool can be timed and the worker imports the tree's own
package.  This module imports only the standard library and torch, so
that a worker imports no other package of this checkout.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def main(argv, script, doc, make_inputs, worker, check) -> int:
    """Run the tool of file `script` (its docstring `doc`): the worker
    when given --worker, else the inputs and every tree in turn, then
    the check and the card's name and power limit."""
    name = Path(script).stem
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / name)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="0", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write(f"{name}: no CUDA device\n")
        return 1
    if a.worker is not None:
        faulthandler.enable()
        print(json.dumps(worker(a.worker.resolve(), a.out, a.tag, a.reps)))
        return 0
    if not a.trees:
        ap.error("give at least one tree")
    a.out.mkdir(parents=True, exist_ok=True)
    make_inputs(a.out)
    results = []
    for i, tree in enumerate(a.trees):
        r = subprocess.run(
            [sys.executable, str(Path(script).resolve()), "--worker",
             str(tree.resolve()), "--out", str(a.out.resolve()), "--tag",
             str(i), "--reps", str(a.reps)], cwd=tree, capture_output=True,
            text=True)
        if r.returncode != 0:
            sys.stderr.write(r.stdout[-4000:] + r.stderr[-8000:])
            raise RuntimeError(f"run {i} on {tree} failed (exit code "
                               f"{r.returncode})")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        results.append(res)
        print(json.dumps(res), flush=True)
    same = check(results, a.out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"every run: {same}; {smi}")
    return 0
