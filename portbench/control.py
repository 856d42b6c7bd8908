"""The control of `correct`: the reference with one guarantee broken.

    python3 portbench/control.py --workload <name> --seeds <a,b,c>

Minigraph states no precision to lower; the guarantee the control
breaks is the long-join rescue re-chain (map-algo.c:407-417), the step
a host-first optimisation would be tempted to drop (half of the native
tail's time on a long read by tools/profmap.py).  For each seed the
control makes the cell's inputs as a run does, maps every file of the
pool with the frozen reference and with it without the rescue, and
counts the reads whose GAF differs, by the comparison a run uses; then
it holds the rescue-less text of a sample, drawn as a run draws it, to
the independent engine (with its rescue).  A
run of the control has to read above the limit (check.LIMITS); the
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from portbench import check, indep  # noqa: E402
from portbench.inputs import make_inputs  # noqa: E402
from portbench.options import of_config  # noqa: E402
from portbench.ref.mapper import Reference, read_fasta  # noqa: E402
from portbench.spec import Spec  # noqa: E402


def control_reading(cell, seed: int) -> dict:
    """The control's numbers for one seed (the names `correct` compares)."""
    work = Path(tempfile.mkdtemp(prefix="portbench-control-"))
    try:
        inp = make_inputs(cell.config, cell.traffic, seed, work)
        switches = of_config(cell.config).output
        ref = Reference(inp.gfa, cell.config["preset"],
                        int(cell.config["threads"]), switches)
        differ = unjudged = 0
        texts = []
        for path in inp.files:
            want = ref.map_file(path)
            got = "".join(t or "" for _, t in ref.map_file(path,
                                                           rescue=False))
            d, u = check.compare_file(got, want)
            differ += d
            unjudged += u
            texts.append(got)
        # the sample a run would draw over one pass of each pool file,
        # the control's text held to the independent engine
        passes = list(range(len(inp.files)))
        sample = indep.draw_sample(seed, passes, inp.reads,
                                   int(cell.traffic["check_sample"]))
        s_differ, _, _ = indep.check_sample(
            inp.gfa, cell.config["preset"], sample, texts,
            [read_fasta(p) for p in inp.files],
            int(cell.config["threads"]), options=switches)
        return {"gaf_reads_differ": differ, "reads_unjudged": unjudged,
                "sample_reads_differ": s_differ, "reads": sum(inp.reads)}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = Spec().cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = control_reading(cell, seed)
        vals = {k: r[k] for k in check.LIMITS}
        print(f"control {args.workload} seed {seed}: {r['reads']} reads; "
              + "; ".join(f"{k} {v} (limit {check.LIMITS[k]})"
                          for k, v in vals.items())
              + f"; correct {check.correct(vals)}; "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    indep.stop_tracker()
    return 0


if __name__ == "__main__":
    sys.exit(main())
