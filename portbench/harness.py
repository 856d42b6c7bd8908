"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The run makes its inputs from the seed (a bubble rGFA and a pool of
query files, under TMPDIR), sets the port up as `map_files(device=
"cuda")` does (the index, the device front, and what the
configuration's `options` add on top of its preset: options.py), maps
the pool's first file to warm every shape the traffic uses, then maps
the pool's files one after another through `map_reads` for --seconds
(a closed loop: each file starts when the last one ends, and the last
one begun runs to its end).  The frozen reference (portbench/ref) then maps each distinct file
on the host, and every read of every file the window completed is held
to it byte for byte; a sample of the window's queries drawn from the
seed is held to the independent pure-Python engine (portbench/pyref).

--trace 0 reports the cell's end-to-end metrics; --trace 1 runs the
window under torch.profiler and reports the per-layer metrics, read by
the files in portbench/metrics/.  The last line on stdout is the result
as one JSON object; the numbers compared, beside their limits, are the
last lines on stderr and the last key of the result.
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

from . import check, indep, tracing
from .inputs import make_inputs
from .options import map_options, of_config
from .ref.mapper import read_fasta
from .spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "minigraph_tpu")
CHECKOUT = Path(__file__).resolve().parents[1]


class NoDevice(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run may not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fix_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own builds go to build/kernels and build/native)."""
    base = CHECKOUT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(base / sub)


def power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", front_kw: Optional[dict] = None,
             t_start: Optional[float] = None) -> dict:
    """The run's result object (the result line's keys, `checks` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    cuda = device == "cuda"
    if cuda and not (torch.cuda.is_available()
                     and torch.cuda.device_count() >= cell.chips):
        raise NoDevice(f"{cell.name} needs {cell.chips} CUDA device(s); "
                       f"found {torch.cuda.device_count()}")
    from minigraph_tpu_torch import kernels
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.mapping import mapper
    from minigraph_tpu_torch.mapping.device_front import DeviceFront
    from minigraph_tpu_torch import options as port_options
    from minigraph_tpu_torch.utils import native
    cfg = cell.config
    opts = of_config(cfg)
    # the device pools follow the run's device, as cli.py has them follow
    # --device
    pool_dev = "cpu" if device == "cpu" else "cuda"
    seed_device0 = dict(mapper.SEED_DEVICE)
    work = Path(tempfile.mkdtemp(prefix="portbench-"))
    try:
        # ---- inputs (the harness's work, not the set-up's)
        t = time.perf_counter()
        inp = make_inputs(cfg, cell.traffic, seed, work)
        gen_s = time.perf_counter() - t
        log(f"inputs: {len(inp.files)} files, {sum(inp.reads)} queries, "
            f"{sum(inp.bp)} bp, made in {gen_s:.3f} s (not set-up)")

        # ---- set-up, as map_files(device="cuda") does it
        su = {}
        t = time.perf_counter()
        if cuda:
            kernels.build()
        native.build()
        su["build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if cuda:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        su["cuda_init_s"] = time.perf_counter() - t
        io_, mo = map_options(port_options, cfg["preset"], opts.output)
        if opts.seed_device:
            mapper.SEED_DEVICE.update(on=True, device=pool_dev)
        opt = copy.copy(mo)
        t = time.perf_counter()
        g = read_gfa(inp.gfa)
        su["read_gfa_s"] = time.perf_counter() - t
        t = time.perf_counter()
        gi = build_index(g, io_.k, io_.w, opt)
        su["index_s"] = time.perf_counter() - t
        t = time.perf_counter()
        front = DeviceFront(gi, opt, device=device, **(front_kw or {}))
        if cuda:
            torch.cuda.synchronize()
        su["front_s"] = time.perf_counter() - t
        pool = None
        if opts.gwfa_device:
            from minigraph_tpu_torch.align.gwfa_device import \
                DeviceGwfaPool
            t = time.perf_counter()
            pool = DeviceGwfaPool(gi, mapper.resolve_device(pool_dev))
            su["gwfa_pool_s"] = time.perf_counter() - t
        n_threads = int(cfg["threads"])
        stats: dict = {}
        t = time.perf_counter()
        with open(work / "warm.gaf", "w") as out:
            mapper.map_reads(gi, opt, [inp.files[0]], out, n_threads,
                             front, stats, gwfa_pool=pool)
        su["warm_s"] = time.perf_counter() - t
        setup_s = time.perf_counter() - t_start - gen_s
        log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in su.items())
            + f"; setup_s {setup_s:.3f} (generation left out)")

        # ---- the window
        s0 = copy.deepcopy(stats)
        launches0 = dict(kernels.launches)
        jobs0 = pool.n_jobs if pool is not None else 0
        prof = undo = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            undo = tracing.wrap_layers(mapper, front)
        passes, per_file = [], []
        n_pool = len(inp.files)
        with tracing.span("window", trace):
            t_w0 = time.perf_counter()
            while time.perf_counter() - t_w0 < seconds:
                k = (1 + len(passes)) % n_pool
                path = work / f"out{len(passes)}.gaf"
                t_f = time.perf_counter()
                with tracing.span("file", trace), open(path, "w") as out:
                    mapper.map_reads(gi, opt, [inp.files[k]], out,
                                     n_threads, front, stats,
                                     gwfa_pool=pool)
                passes.append((k, path))
                per_file.append((k, round(time.perf_counter() - t_f, 3),
                                 stats.get("n_share_host"),
                                 round(stats.get("tail_ms", 0.0)),
                                 round(stats.get("share") or 0, 3)))
            window_s = time.perf_counter() - t_w0
        red = None
        if trace:
            tracing.unwrap(undo)
            prof.__exit__(None, None, None)
            red = tracing.reduce_profile(prof, str(work / "trace.json"))
        s1 = copy.deepcopy(stats)
        bp = sum(inp.bp[k] for k, _ in passes)
        reads = sum(inp.reads[k] for k, _ in passes)
        mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
        kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        launched = {k: v - launches0.get(k, 0)
                    for k, v in kernels.launches.items()
                    if v - launches0.get(k, 0)}
        delta = {k: s1[k] - s0.get(k, 0) for k in (
            "n_share_dev", "n_share_host", "n_device", "n_fallback",
            "n_chain_unsure", "n_probes", "n_perread", "tail_ms")
            if k in s1}
        stage = {k: round(v - s0.get("stage_ms", {}).get(k, 0.0), 3)
                 for k, v in s1.get("stage_ms", {}).items()}
        log(f"window: {len(passes)} files, {reads} queries, {bp} bp in "
            f"{window_s:.3f} s; kernel launches {launched}; split share "
            f"{s1.get('share')}, collapsed {s1.get('collapsed')}; "
            f"counts {delta}; stage ms {stage}")
        log("files (pool file, s, host-share reads so far, tail ms so far, "
            f"share): {per_file}")
        if pool is not None:
            log(f"gwfa pool: {pool.n_jobs - jobs0} jobs in the window; "
                f"totals since set-up: jobs {pool.n_jobs}, on the device "
                f"{pool.n_device}, flagged {pool.n_flagged}, oversize "
                f"{pool.n_oversize}")
        if cuda:
            log(f"device: {kind}; nvidia-smi: {power_line()}")
        del front, gi, g, pool
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # ---- the comparison with the reference
        t = time.perf_counter()
        from .ref.mapper import Reference
        ref = Reference(inp.gfa, cfg["preset"], n_threads, opts.output)
        want = {k: ref.map_file(inp.files[k]) for k in sorted(
            {k for k, _ in passes})}
        differ = unjudged = lines = 0
        texts = []
        for k, path in passes:
            got = path.read_text(encoding="latin-1")
            d, u = check.compare_file(got, want[k])
            differ += d
            unjudged += u
            lines += got.count("\n")
            texts.append(got)
        log(f"reference: {len(want)} files mapped on the host, "
            f"{len(passes)} files ({lines} GAF lines) compared in "
            f"{time.perf_counter() - t:.3f} s"
            + (f"; {ref.n_finished} reads the native batch gave up "
               "mapped again by the host finish" if opts.cigar else ""))
        del ref, want

        # ---- the independent check: a sample held to pyref
        t = time.perf_counter()
        recs = {k: read_fasta(inp.files[k]) for k, _ in passes}
        sample = indep.draw_sample(seed, [k for k, _ in passes], inp.reads,
                                   int(cell.traffic["check_sample"]))
        s_differ, late, first = indep.check_sample(
            inp.gfa, cfg["preset"], sample, texts,
            [recs[k] for k, _ in passes], n_threads, options=opts.output)
        log(f"pyref: {len(sample) - late} of {len(sample)} sampled queries "
            f"mapped in time and compared in "
            f"{time.perf_counter() - t:.3f} s"
            + (f"; first that differs: {first}" if first else ""))
        vals = {"gaf_reads_differ": differ, "reads_unjudged": unjudged,
                "sample_reads_differ": s_differ}

        if trace:
            ctx = {"stats_before": s0, "stats_after": s1, "bp": bp,
                   "reads": reads, "window_s": window_s, "setup": su,
                   "trace": red}
            metrics = {}
            for m in cell.per_layer:
                v = cell.readers[m["name"]](ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            e2e = {"query_bp_per_s": bp / window_s, "setup_s": setup_s}
            metrics = {m["name"]: {"value": e2e[m["name"]],
                                   "unit": m["unit"]}
                       for m in cell.end_to_end}
        dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
               "count": cell.chips, "memory_peak_bytes": mem_peak}
        res = {"correct": check.correct(vals), "attempted": reads,
               "failed": differ, "metrics": metrics, "device": dev}
        if red is not None:
            dev.update(busy_s=red["busy_s"], window_s=red["window_s"])
            res["breakdown"] = {"device_ops": red["device_ops"],
                                "idle_gaps": red["idle_gaps"]}
        res["checks"] = check.check_lines(vals)
        return res
    finally:
        mapper.SEED_DEVICE.clear()
        mapper.SEED_DEVICE.update(seed_device0)
        shutil.rmtree(work, ignore_errors=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse(argv)
    fix_cache_dirs()
    cell = Spec().cell(args.workload)
    try:
        res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       t_start=t_start)
    except NoDevice as e:
        log(f"portbench: {e}")
        return 3
    indep.stop_tracker()
    bad = forbidden_modules()
    if bad:
        log(f"portbench: the run loaded {bad}; no result")
        return 4
    for name, c in res["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(res), flush=True)
    return 0
