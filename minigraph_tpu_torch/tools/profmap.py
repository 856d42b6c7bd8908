"""Profile the native host mapping path (MGT_PROF=1) on a workload (port
of the JAX package's tools/profmap.py).

Usage: python -m minigraph_tpu_torch.tools.profmap GRAPH.gfa READS.fa [-x lr] [-c] [-n REPS]

Maps the reads through the production host batch driver
(mapping/mapper.py _map_file_frag, one thread, no device) with the
stage profilers on, then prints the per-stage wall-ns dumps from all
four native profilers (batch, tail, gchain, gwfa) normalized per read.
Slot meanings (see native/mgt_{batch,tail,gchain,gwfa}.c):
  batch:  0 collect, 1 map_tail, 2 select, 3 cigar, 4 format
  tail:   0 lchain, 1 rescue, 2 lchain_tail, 3 gchain_full;
          counters 4 rescue calls, 5 rescue anchors, 6 rescue iters,
          7 first-pass anchors
  gchain: 0 gchain1_dp, 1 shortk-in-DP, 2 gchain_gen, 3 gwfa bridges,
          4 shortk bridges, 5 extras; counters 6 DP shortk calls,
          7 gwfa bridge calls
  gwfa:   0 extend, 1 dedup, 2 prune; counters 3 steps, 4 peak wave

The native library reads MGT_PROF once, at its first profiled call
(native/mgt_tail.c mgt_tail_prof), and caches it for the process.  So
importing this module changes nothing; `main` sets MGT_PROF=1 before it
loads the library and raises if the library still reads the profilers
as off (it was called earlier in this process without them).  Run it
in a process of its own.
"""
from __future__ import annotations

import ctypes
import io
import os
import sys
import time
from typing import List, Optional

DUMPS = ("mgt_batch_prof_dump", "mgt_tail_prof_dump8",
         "mgt_gchain_prof_dump", "mgt_gwfa_prof_dump")


def dump(lib, name):
    """Read and reset one profiler's eight slots (None if the library
    lacks it)."""
    fn = getattr(lib, name, None)
    if fn is None:
        return None
    buf = (ctypes.c_int64 * 8)()
    fn.restype = None
    fn.argtypes = [ctypes.POINTER(ctypes.c_int64)]
    fn(buf)
    return list(buf)


def profiled_lib():
    """The native library with its stage profilers on."""
    os.environ["MGT_PROF"] = "1"
    from ..utils.native import get_lib
    lib = get_lib()
    lib.mgt_tail_prof_on.restype = ctypes.c_int
    lib.mgt_tail_prof_on.argtypes = []
    if not lib.mgt_tail_prof_on():
        raise RuntimeError(
            "profmap: the native library reads its profilers as off: it "
            "read MGT_PROF before this process set it, so it would dump "
            "zeros; run profmap in a fresh process")
    return lib


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = [a for a in argv if not a.startswith("-")]
    if len(args) < 2:
        sys.stderr.write("Usage: python -m minigraph_tpu_torch.tools.profmap "
                         "GRAPH.gfa READS.fa [-x lr] [-c] [-n REPS]\n")
        return 1
    lib = profiled_lib()
    from ..graph.gfa_io import read_gfa
    from ..index.midx import build_index
    from ..mapping.mapper import _map_file_frag
    from ..options import (MG_M_CIGAR, GGOptions, IndexOptions, MapOptions,
                           opt_check, opt_set)

    gfa, reads = args[0], args[1]
    preset = "lr"
    if "-x" in argv:
        preset = argv[argv.index("-x") + 1]
    reps = int(argv[argv.index("-n") + 1]) if "-n" in argv else 1
    io_, mo, go = IndexOptions(), MapOptions(), GGOptions()
    opt_set(preset, io_, mo, go)
    if "-c" in argv:
        mo.flag |= MG_M_CIGAR
    opt_check(io_, mo, go)
    g = read_gfa(gfa)
    gi = build_index(g, io_.k, io_.w, mo)
    for name in DUMPS:
        dump(lib, name)  # reset
    with open(reads) as f:
        n_reads = sum(1 for ln in f if ln.startswith(">"))
    t_best = None
    for _ in range(reps):
        for name in DUMPS:
            dump(lib, name)  # keep only the last rep
        sink = io.StringIO()
        t0 = time.time()
        _map_file_frag(gi, [reads], mo, sink, 1, None)
        dt = time.time() - t0
        t_best = dt if t_best is None else min(t_best, dt)
    print(f"== {n_reads} reads, {t_best:.2f}s -> {n_reads/t_best:.0f} reads/s "
          f"({t_best/n_reads*1e3:.3f} ms/read)")
    reps = 1          # dumps were reset before the last rep
    us = 1e3 * reps * n_reads  # ns total -> us/read divisor
    b, t, gc, gw = (dump(lib, name) for name in DUMPS)
    if b:
        print(f"batch us/read: collect {b[0]/us:.1f} map_tail {b[1]/us:.1f} "
              f"select {b[2]/us:.1f} cigar {b[3]/us:.1f} format {b[4]/us:.1f}")
    if t:
        print(f"tail  us/read: lchain {t[0]/us:.1f} rescue {t[1]/us:.1f} "
              f"lchain_tail {t[2]/us:.1f} gchain_full {t[3]/us:.1f} | "
              f"rescue calls {t[4]/reps} anchors {t[5]/reps} "
              f"iters {t[6]/reps} first-pass anchors {t[7]/reps}")
    if gc:
        print(f"gchain us/read: dp {gc[0]/us:.1f} shortk-dp {gc[1]/us:.1f} "
              f"gen {gc[2]/us:.1f} gwfa {gc[3]/us:.1f} shortk-br {gc[4]/us:.1f} "
              f"extras {gc[5]/us:.1f} | shortk calls {gc[6]/reps} "
              f"gwfa calls {gc[7]/reps}")
    if gw:
        print(f"gwfa  us/read: extend {gw[0]/us:.1f} dedup {gw[1]/us:.1f} "
              f"prune {gw[2]/us:.1f} | steps {gw[3]/reps} peak {gw[4]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
