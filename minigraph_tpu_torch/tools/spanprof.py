"""The program's spans (utils/trace.py) on one mapping run, with the
device's idle time put down to them.

    python -m minigraph_tpu_torch.tools.spanprof GRAPH.gfa READS.fa
        [READS.fa ...] [-x lr] [-t 8] [--device cuda|cpu|none]
        [--trace FILE]

Maps the files with map_files (the GAF is discarded) under
torch.profiler, the CPU's activities and, on the card, CUDA's.  While a
profiler records, every span is also the range "mg:<name>" of its
trace, on the kernels' clock.  Prints one JSON object:

- spans: for each span, the host ms and calls that map_files' stats
  hold (span_ms, span_n) beside the ms and count of its ranges in the
  trace.  The profiler records the thread that started it, so the
  reader's prefetch thread (read.arena) and the open split's tail
  worker (its tail.* calls) have no range;
- window_s, busy_s, idle_s: from the first to the last range of the
  main thread, the union of the trace's kernels, copies and memsets,
  and what is left;
- idle_by_span: idle time by the chain of the main thread's ranges the
  host was in at each idle gap's middle (outer > inner), largest first;
  a gap shorter than a span can fall outside it, so a short span's
  share is a lower bound;
- submit_tail_overlap_ms, n_tail_groups, n_arena, and the front's
  bucket batches replayed from CUDA graphs and run eagerly on the card
  (n_step_replays, n_step_eager) from the stats.

--trace keeps the exported trace in FILE; it is deleted otherwise.
`profile_spans` runs any call the same way.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def ranges(events: List[dict]) -> Dict[str, List[Tuple[float, float, object]]]:
    """The trace's "mg:" ranges by span name: [(start, end, thread)] in
    microseconds (the device-side copies of annotations left out)."""
    out: Dict[str, list] = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") == "X" and name.startswith(trace.PREFIX) \
                and e.get("cat") != "gpu_user_annotation":
            a = float(e["ts"])
            out.setdefault(name[len(trace.PREFIX):], []).append(
                (a, a + float(e["dur"]), e.get("tid")))
    return out


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(events: List[dict]) -> Optional[dict]:
    """The ranges' totals and the device's idle time by span (see the
    module's docstring); None when the trace has no range."""
    rg = ranges(events)
    if not rg:
        return None
    main_tid = min((a, t) for v in rg.values() for a, _, t in v)[1]
    spans = sorted((a, b, k) for k, v in rg.items() for a, b, t in v
                   if t == main_tid)
    w0, w1 = spans[0][0], max(b for _, b, _ in spans)
    busy = _union([(max(float(e["ts"]), w0),
                    min(float(e["ts"]) + float(e["dur"]), w1))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                   and float(e["ts"]) < w1
                   and float(e["ts"]) + float(e["dur"]) > w0])
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    idle: Dict[str, float] = {}
    active: list = []
    j = 0
    for a, b in gaps:       # in time order: sweep the spans once
        mid = (a + b) / 2
        while j < len(spans) and spans[j][0] <= mid:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[1] > mid]
        chain = sorted(active, key=lambda s: (s[0], -s[1]))
        label = ">".join(s[2] for s in chain) or "outside spans"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    busy_s = sum(b - a for a, b in busy) / 1e6
    return {
        "ranges": {k: {"ms": sum(b - a for a, b, _ in v) / 1e3,
                       "n": len(v)} for k, v in sorted(rg.items())},
        "window_s": (w1 - w0) / 1e6, "busy_s": busy_s,
        "idle_s": (w1 - w0) / 1e6 - busy_s,
        "idle_by_span": sorted(idle.items(), key=lambda kv: -kv[1]),
    }


def profile_spans(fn: Callable[[], object], cuda: bool,
                  keep: Optional[str] = None):
    """fn() under torch.profiler; (its result, `reduce` of the trace)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        res = fn()
        if cuda:
            torch.cuda.synchronize()
    path = keep
    if path is None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        if keep is None:
            os.unlink(path)
    return res, reduce(events)


def report(stats: dict, red: Optional[dict]) -> dict:
    """stats' spans beside the trace's ranges, and the idle by span."""
    rg = (red or {}).get("ranges", {})
    spans = {k: {"ms": v, "n": stats["span_n"].get(k, 0),
                 "range_ms": rg.get(k, {}).get("ms"),
                 "range_n": rg.get(k, {}).get("n", 0)}
             for k, v in sorted(stats.get("span_ms", {}).items())}
    out = {"spans": spans}
    if red is not None:
        out.update({k: red[k] for k in ("window_s", "busy_s", "idle_s",
                                        "idle_by_span")})
    for k in ("submit_tail_overlap_ms", "n_tail_groups", "n_arena",
              "n_step_replays", "n_step_eager"):
        out[k] = stats.get(k)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m minigraph_tpu_torch.tools.spanprof",
        description="the program's spans on one mapping run, and the "
                    "device's idle time by span")
    ap.add_argument("gfa")
    ap.add_argument("reads", nargs="+")
    ap.add_argument("-x", dest="preset", default="lr")
    ap.add_argument("-t", dest="threads", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), cpu, or none (host only)")
    ap.add_argument("--trace", help="keep the exported trace in this file")
    args = ap.parse_args(argv)
    from ..graph.gfa_io import read_gfa
    from ..mapping.mapper import map_files
    from ..options import (GGOptions, IndexOptions, MapOptions, opt_check,
                           opt_set)
    io_, mo, go = IndexOptions(), MapOptions(), GGOptions()
    if opt_set(args.preset, io_, mo, go) < 0:
        sys.stderr.write(f"spanprof: unknown preset {args.preset!r}\n")
        return 1
    opt_check(io_, mo, go)
    dev = None if args.device == "none" else args.device
    g = read_gfa(args.gfa)
    stats: dict = {}
    with open(os.devnull, "w") as out:
        _, red = profile_spans(
            lambda: map_files(g, args.reads, io_, mo, out, args.threads,
                              device=dev, stats=stats),
            cuda=dev == "cuda", keep=args.trace)
    print(json.dumps(report(stats, red), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
