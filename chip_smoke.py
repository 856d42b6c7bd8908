"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels (minigraph_tpu_torch/csrc, nvcc) and the
   native host library (native/*.c, gcc), from the sources in the
   checkout;
3. kernels against their plain PyTorch versions on the card, bitwise:
   the sketch kernel at the three buckets' shapes on synthetic reads
   with N runs, tandem repeats and empty lanes, at lr's (k, w) = (17,
   11) and at asm's (19, 10); the exact chain kernel
   (K2), the chunked-walk chain kernel (K3) and the fused backtrack
   kernel (csrc/backtrack.cu, one launch of ops/backtrack.py
   backtrack_compact, on K2's f and p) on the same anchors from the
   real collect at each bucket's (B, A, W, T), the batch padded with
   empty reads to the bucket's width, K3's sure flags equal to K2's; the
   backtrack once more at the 8 kb shape with a step budget that flags
   lanes; each timed with CUDA events over back-to-back wrapper calls
   and replayed from a CUDA graph (the device time without the
   wrapper's host cost), as are K4 and K7 in phases 5 and 6; the
   backtrack's clock buffer gives each of its four phases' cycles (max
   and mean over blocks);
4. main path at real size: a 5 Mb MHC-class synthetic reference as an
   rGFA bubble graph (its index has well over 1e5 keys, so the hash
   join runs), 1024 reads of 800-1900 bp plus 128 reads of ~15 kb mean
   (capped at 30 kb) off a haplotype walk, through the port's file loop
   (mapping/mapper.py map_reads / map_files: native reader arenas, the
   host/device split) in these runs, each held to the GAF bytes of
   the host-only run of the same file:
   (i) a front on the card with the split pinned at share 0 (every
   eligible read to the device, none to the host), run twice (the first
   pays one-time costs; the second is held and timed): the sketch, K2
   and backtrack kernels launched, one backtrack launch a device batch,
   >= 80% of eligible reads on the device; (ii) the same with
   MGT_CHAIN_CHUNKED=1: the same reads on the device, K3 launched and K2
   not; (iii) (i) with the native batch tail reporting a bail for every
   40th read of a batch, which re-maps those reads on the exact per-read
   path (mapping/mapper.py map_frag), through the native file loop
   (phase 7 (c) repeats it through the Python reader loop); (iv)
   map_files(device="cuda") with the split as it
   starts (share 0.35): (a) over 20 arena batches of ~57 reads, then on
   a file of the same mix with 12.5x the reads (b) at the default -K
   (one arena batch, as the command line runs) and (c) over 17 arena
   batches, with that file's device path (share pinned at 0) and host
   only beside them, printing the share the controller reached, whether
   it collapsed, its probes and the reads sent to each side; (v)
   map_files(device=None), host only.  Each run prints its reads/s and
   stage ms;
5. batched map step (minigraph_tpu_torch/ops/pipeline.py) at bench.py's
   stage shape (B=512 short reads padded to 2048, acap=512, qcap=384,
   window=32, b_chunk=64, occ_cap=16): make_map_step_v3 with (a) the
   hash index and (b) the bucketed index of the 5 Mb graph, and (c) the
   flat join index of a 400 kb graph (below 1e5 keys) plus
   collect_anchors_flat on the same sketch; the ring chain, bucketed
   probe and flat probe kernels against their plain versions at these
   inputs, the card's step against the same step on the CPU on the
   first 64 reads, (a) against (b) on unflagged reads, each kernel's
   launches in that run, and the steps' reads/s;
6. banded dual-affine gap scores (ops/wfa_banded.py banded_score, K7)
   at wa=32 on 4096 pairs of 256-2048 bp cut from the 5 Mb reference
   (the -c gap jobs' lengths) with 2% substitutions and 1% indels, 5% of
   them with a length skew beyond the band; the kernel against its
   plain version, bitwise;
7. the rest of the command line on the card, each run held to the GAF
   bytes of its host-only run and printing reads/s, map_ms and stage ms:
   (a) asm: the phase 4 graph indexed with -x asm (k = 19, w = 10), the
   query a haplotype of its reference (make_haplotype, seed 7) cut into
   ~5 Mb of consecutive contigs (lognormal, mean 12 kb, 2-32 kb, every
   50th 200 kb, which the host maps), through the native file loop with
   the split pinned at share 0 (run twice, the second timed): the
   seed-only front launches the sketch kernel and no chain or backtrack
   kernel, every eligible contig goes to the device; n_device,
   n_fallback and the flat-plane overflows printed; then host only;
   (b) sr: 50,000 FR pairs of 2x150 bp (inserts around 400 bp, 0.3%
   substitutions, 0.02% indels) off the same haplotype, as two files
   through map_files(device="cuda") (the Python reader loop; no pair is
   device-eligible, n_device = 0) and host only, and as one interleaved
   file through the native arena loop (host only, mates grouped in C);
   (c) phase 4's reads through the Python reader loop (the native
   reader refused, as for stdin) with the split pinned at share 0 and a
   bail forced on every 40th read;
8. base-level alignment (-c), each run held to the GAF bytes of its
   host-only run: (a) -cx lr on phase 4's reads through the native file
   loop, the split pinned at share 0 with K2 (the native tail aligns in
   its workers; cg:Z and ds:Z on the lines, >= 80% of eligible reads on
   the device), then a bail forced on every 40th read, with the stage
   and tail ms beside run (i)'s; (b) -cx asm on phase 7 (a)'s contigs on
   the seed-only front; (c) -c --vc through the Python reader loop with
   the front pinned and the native anchor walk declined for every 4th
   chain, so those chains' gaps go to the front's gap pool
   (align/cigar_device.py DeviceWfaPool: csrc/wfa_exact.cu wfa_wave and
   wfa_walk at the buckets (768, 1024, 64) and (2048, 3072, 16)), held
   to the unstubbed host-only run, printing the jobs a bucket, the
   pool's n_device (> 0) and n_host and the kernels' launches; (d)
   wfa_wave and wfa_walk on gap pairs of 256-2048 bp cut from the 5 Mb
   reference: one full chunk a bucket bitwise against the plain
   versions (tb on the rows below each score; the walk on the kernel's
   and the plain tb), timed, with each kernel's clock buffer split (the
   slowest pair's cycles in the wave, extension, end test and barrier;
   the walk's cycles, steps and tb reads), and the CIGARs of 4096 pairs
   against the native host engine's;
9. the device GWFA bridge pool (--gwfa-device): (a) the bridge jobs of
   phase 4's reads harvested through the native hook (mode 1, every job
   then bridged by the inline host engine: GAF bytes equal to the
   host-only run), counted a query bucket (<= 256, <= 1024, longer), and
   the gwfa kernel (csrc/gwfa.cu) bitwise against its plain version
   (ops/gwfa.py gwfa_batch_ref) on one full chunk of 16 jobs a bucket and on run
   (b2)'s launch, timed, with each phase's share of its clock buffer's
   cycles; (b) phase 4's reads mapped with the pool on the card, (1) the
   front pinned at share 0, one pool call a read, and (2) no front, one
   pool call a batch (GwfaBatchSink), each held to the host-only GAF
   bytes and printing the jobs, n_device (> 0), flagged, oversize, the
   kernel's launches, the pool's kernel_ms (the launches alone) inside
   its batch_ms (the wrapper calls) and reads/s, and for (1) kernel_ms
   beside the 16-job chunk's graph time x launches;
10. graph generation on the host: -cxggs -l10k on the phase 4 graph
   with two make_haplotype samples cut into contigs (the segments and
   arcs it adds, > 0), -xasm --call -l10k of a third sample on the new
   graph (its BED lines), then phase 4's reads on the new graph with the
   front pinned, held to the host-only GAF bytes on that graph;
11. --seed-device, the chunk-halo sweep of index/midx_device.py on K1:
   (a) K1 bitwise against its plain version at the sweep's widths for
   asm's (k, w) = (19, 10), (128, 4137) and (16, 32809), on the sweep's
   first batch of each bucket for phase 7 (a)'s contigs, timed, and the
   batches one whole haplotype takes; (b) build_index_device on the
   phase 4 graph at lr's and asm's settings, its tables equal to
   build_index's, one K1 launch a chunk batch, both timed, and the sweep
   against the host sketch on every segment plus a tandem sequence whose
   planes overflow (it alone goes to the host sketch); (c) phase 10's
   -cxggs -l10k with --seed-device (graph generation maps each contig
   with map_one, the per-read path): the rGFA bytes of phase 10, one
   sweep a contig of 16384 bp or more, its K1 launches counted; (d)
   -xasm --write-mz --seed-device on phase 7's whole haplotype as one
   ~5 Mb query (its output shape takes the Python reader loop, so the
   device route): the GAF bytes of --device none without --seed-device,
   K1 launched once a chunk batch;
12. multi-GPU and the fork pool: (a) the v1 map step (ops/pipeline.py
   make_map_step: the exact sketch, the binary-search collect, K4 at
   W = 64) at phase 5's shape with mcap 512 and acap 2048, bitwise
   against the same step on CPU tensors, its reads/s, K4 on its anchors
   against its plain version; (b) the five steps of parallel/shard.py at
   mcap = acap = qcap = 512 on 384 of phase 4's reads and 128 exact
   slices of the reference (some of whose hits in one of two key shards
   pass acap_shard): world size 1 with NCCL on a 1x1 mesh, each equal to
   its unsharded step, then two gloo processes on cuda:0, the (data 2,
   idx 1) mesh equal to the world-size-1 results, the (data 1, idx 2)
   mesh too except on the reads whose shard binds acap_shard, its idx
   steps equal to the same steps with CPU tables, and the sweep with a
   data-2 mesh equal to mesh=None, K1 launched once a chunk batch on
   each rank; (c) python -m minigraph_tpu_torch.parallel.dist with two
   processes on the card, the GAF run and the --cov run at once: rank
   0's bytes equal phase 4's host-only GAF and the single-process --cov
   graph, rank 1 writes nothing; each rank's front launches and
   seconds; (d) phase 10's -cxggs -l10k at -t 8 in a fresh process (it
   forks 8 workers) and in this one (it holds a CUDA context, so it maps
   here and logs why), the rGFA bytes of phase 10 both times; (e)
   tools/devprof.py's stage table at --bucket 2048x256 --n 256 on phase
   4's graph and reads;
13. the offline tools (tools/mgutils*.py, tools/profmap.py): (a) the
   cookbook chain on phase 10's graph: -cxasm --call -l10k of its three
   samples, then again with --seed-device (BEDs equal, K1 launched once
   a chunk batch of every contig of 16384 bp or more), paste, `python -m
   minigraph_tpu_torch.tools.mgutils` merge -s, merge2vcf -r 0,
   addsample, segfreq (on the graph's gfa2bed), getlcr and bed2sql, row
   counts checked (one VCF record a bubble, the samples in order); (b)
   stableGaf of a --vc GAF of phase 4's reads (every mapped record back,
   every path in stable coordinates, columns 1-9 equal phase 4's stable
   GAF but for reverse-strand records on one contig, one base to the
   left, as the JAX tool writes them) and subgaf on it; (c)
   tools/profmap.py in a child process on phase 4's graph and reads with
   -x lr and with -c, its five lines printed, every stage that ran > 0.

After the build it prints ptxas' registers, stack frame and spills of
the sketch, chunked-chain, ring-chain, banded-score, backtrack,
exact-WFA and GWFA kernels.  Prints the kernels' JSON line (K1 twice:
"sketch" with the main path's launches, "sketch_seed_device" at the
sweep's width with run 11 (d)'s; K4 twice: "chain_ring" at phase 5's
W = 32, "chain_ring_v1" at the v1 step's W = 64 with run 12 (a)'s),
then the card's name and power limit,
and last {"ok": true, "device": {...}}.  Exits non-zero without a CUDA
device.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
SCALAR_OPS_PER_S = 67e12    # float32 outside the tensor cores, same sheet
SKETCH_OPS_PER_BASE = 5 * 11 + 60   # window min + ties at w=11, hash+regs
CHAIN_OPS_PER_ROW = 40      # comput_sc with the fast log2, per candidate
# one banded cell: four gap planes (two adds and a min each), H (the
# substitution test and select, one add, four mins)
WFA_OPS_PER_CELL = 4 * 3 + 7
WFA_WA, WFA_PAIRS = 32, 4096
# one exact-WFA wave cell: nine ring reads with edge tests, four maxes
# and two adds for the gap planes, three for H, the tb byte's compares
WFA_EXACT_OPS_PER_CELL = 20
PROBE_OPS_PER_PAIR = 18     # the 9-term distance: 9 multiplies, 9 adds
# one GWFA state a step or hop wave: decode vd, the bound tests, three
# children with their pushes, the boundary and target tests, and its
# share of the candidate sort, the dedup and the forbidden-set search
GWFA_OPS_PER_STATE = 60
GWFA_OPS_PER_COMPARE = 2    # one extension compare: load and test
# bench.py bench_stage's shape of the batched map step
STEP_B, STEP_PAD = 512, 2048
STEP_KW = dict(acap=512, qcap=384, window=32, b_chunk=64, occ_cap=16)


def log(msg):
    print(msg, flush=True)


def cuda_time(fn, reps):
    """Mean ms of fn() over reps launches (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def ptxas_lines(log, names):
    """One line per kernel named in `names`: registers, stack frame and
    spills as nvcc -Xptxas -v reported them in the build log."""
    info, cur = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            cur = next((n for n in names if n in line), None)
        elif cur and ("stack frame" in line or "registers" in line):
            info.setdefault(cur, []).append(line.split(":")[-1].strip()
                                            if "registers" in line
                                            else line.strip())
    missing = [n for n in names if n not in info]
    if missing:
        raise AssertionError(f"no ptxas report for {missing}")
    return [f"ptxas {n}: " + "; ".join(info[n]) for n in names]


def graph_time(fn, reps):
    """Mean ms of fn() captured once in a CUDA graph and replayed: the
    call's device work without the host's Python and launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                 # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    # relaxed: the chain wrappers raise a kernel's shared-memory limit
    # (cudaFuncSetAttribute) on every call, which global capture refuses
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        fn()
    return cuda_time(g.replay, reps)


def bound(nbytes, ops):
    """(ms, term) of the least time the card could take: bytes over the
    memory rate or operations over the float32 rate, the larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def max_abs_err(a, b):
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} vs {tuple(y.shape)}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def synth_codes(B, L, rng):
    """nt4 codes with N runs, tandem repeats, empty and full lanes."""
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0] = 0
    lens[1] = L
    lens[2] = 1
    for b in range(B):
        for _ in range(int(rng.integers(0, 4))):         # runs of N
            st = int(rng.integers(0, L))
            codes[b, st: st + int(rng.integers(1, 60))] = 4
        if b % 3 == 0:                                   # tandem repeat
            unit = rng.integers(0, 4, int(rng.integers(1, 12)))
            st = int(rng.integers(0, L))
            n = min(L - st, int(rng.integers(50, 1500)))
            codes[b, st: st + n] = np.resize(unit, n)
        if b % 7 == 0:                                   # lower case etc.
            codes[b, rng.integers(0, L, 5)] = 4
    return codes, lens


def check_sketch(rng, B, L, w, k, reps):
    return check_sketch_codes(*synth_codes(B, L, rng), w, k, reps)


def check_sketch_codes(codes, lens, w, k, reps):
    """K1 on (B, L) nt4 codes against its plain version on the card,
    bitwise; events, CUDA-graph and plain times and the bound."""
    from minigraph_tpu_torch.ops import sketch as sk
    B, L = codes.shape
    c = torch.from_numpy(codes).cuda()
    n = torch.from_numpy(lens).cuda()
    got = sk.sketch_planes(c, n, w, k)
    ref = sk.sketch_planes_ref(c, n, w, k)
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    if err or not torch.equal(got.overflow, ref.overflow):
        raise AssertionError(f"sketch kernel differs at ({B}, {L}): {err}")
    ms = cuda_time(lambda: sk.sketch_planes(c, n, w, k), reps)
    graph_ms = graph_time(lambda: sk.sketch_planes(c, n, w, k), 5 * reps)
    plain = cuda_time(lambda: sk.sketch_planes_ref(c, n, w, k), 2)
    # the function's own traffic: u8 codes and i32 lens in; six u32
    # planes of L+1 words, the i32 count and the flag out (the port holds
    # the planes in int64 tensors, twice these bytes)
    nbytes = B * L + 4 * B + 6 * 4 * B * (L + 1) + 4 * B + 4 * B
    ops = B * L * SKETCH_OPS_PER_BASE
    bound = max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S) * 1e3
    log(f"sketch ({B}, {L}): bitwise equal ({int(got.overflow.sum())} "
        f"overflow lanes, {int(got.n.sum())} emissions); kernel "
        f"{ms:.4f} ms ({graph_ms:.4f} ms replayed from a CUDA graph), "
        f"plain {plain:.3f} ms, bound {bound:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
            "plain_ms": plain,
            "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
            >= ops / SCALAR_OPS_PER_S else "operations"}


def collect_batch(front, seqs, pad_len):
    """Anchor planes of one bucket batch through the port's own sketch
    and collect (the chain kernel's inputs on the main path)."""
    from minigraph_tpu_torch.ops.anchors import (collect_anchors_exact,
                                                 collect_anchors_exact_hash)
    from minigraph_tpu_torch.ops.sketch import encode_batch, sketch_planes
    qcap, acap, win, tile = front.caps(pad_len)
    codes, lens = encode_batch(seqs, pad_to=pad_len)
    sp = sketch_planes(torch.from_numpy(codes).cuda(),
                       torch.from_numpy(lens).cuda(), front.gi.w,
                       front.gi.k)
    collect = collect_anchors_exact_hash if front.hashed \
        else collect_anchors_exact
    res = collect(front.ji, sp.hh, sp.hl, sp.meta, sp.t_hh, sp.t_hl,
                  sp.t_meta, int(front.opt.occ_max1), front.occ_cap,
                  qcap=qcap, acap=acap)
    return res, win, tile


def chain_inputs(front, seqs, pad_len):
    """The chain kernels' arguments on one bucket batch, as the main
    path gives them."""
    bsz = dict(front.buckets)[pad_len]
    if not 16 <= len(seqs) <= bsz:
        raise AssertionError(f"{len(seqs)} reads for a {pad_len} bucket "
                             f"batch of {bsz}")
    # empty lanes fill the batch, as DeviceFront.submit pads it
    res, W, T = collect_batch(front, seqs + [""] * (bsz - len(seqs)),
                              pad_len)
    opt = front.opt
    args = (res["axh"], res["axl"], res["ayh"], res["ayl"], res["n_a"],
            int(front.mdx_adj), int(front.mdy_adj), int(opt.bw),
            int(opt.max_lc_skip), int(opt.max_lc_iter), front.chn_pen_gap,
            front.chn_pen_skip)
    return args, W, T


def chain_bytes(args):
    """Four anchor planes in, f and p out, n_a and sure."""
    B, A = args[0].shape
    return B * A * (4 * 4 + 2 * 4) + B * 5


def check_chain(args, W, T, reps):
    from minigraph_tpu_torch.ops import chain_exact as ce
    got = ce.lchain_dp_exact_win(*args, window=W, tile=T)
    t0 = time.perf_counter()
    ref = ce.lchain_dp_exact_win_ref(*args, window=W, tile=T)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(got, ref)
    B, A = args[0].shape
    if err:
        raise AssertionError(f"chain kernel differs at {(B, A)} W={W} "
                             f"T={T}: {err}")
    ms = cuda_time(lambda: ce.lchain_dp_exact_win(*args, window=W, tile=T),
                   reps)
    graph_ms = graph_time(
        lambda: ce.lchain_dp_exact_win(*args, window=W, tile=T), 2 * reps)
    n_a = args[4].to(torch.int64).cpu().numpy()
    # candidate rows this data needs: anchor i scans W + (i mod T) rows
    # above the start of its tile, minus those before the read start
    rows = 0
    for n in n_a.tolist():
        i = np.arange(n)
        rows += int(np.minimum(i, W + i % T).sum())
    bms, by = bound(chain_bytes(args), rows * CHAIN_OPS_PER_ROW)
    sure = int(got[2].sum())
    log(f"chain ({B}, {A}, W={W}, T={T}): bitwise equal, {sure}/{B} sure,"
        f" n_a mean {n_a.mean():.1f} max {n_a.max()}; kernel {ms:.4f} ms"
        f" ({graph_ms:.4f} ms replayed from a CUDA graph), plain "
        f"{plain:.1f} ms, bound {bms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by}, got


def check_chunked(args, W, T, reps, k2, k2_sure):
    """K3 against its plain version on K2's inputs; its sure flags
    against K2's; the two kernels' times side by side."""
    from minigraph_tpu_torch.ops import chain_chunked as cc
    got = cc.lchain_dp_chunked(*args, window=W, tile=T)
    walk = {}
    t0 = time.perf_counter()
    ref = cc.lchain_dp_chunked_ref(*args, window=W, tile=T, walk=walk)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(got, ref)
    B, A = args[0].shape
    if err:
        raise AssertionError(f"chunked chain kernel differs at {(B, A)} "
                             f"W={W} T={T}: {err}")
    if not torch.equal(got[2], k2_sure):
        raise AssertionError(f"chunked chain sure flags differ from the "
                             f"exact chain's at {(B, A)}")
    ms = cuda_time(lambda: cc.lchain_dp_chunked(*args, window=W, tile=T),
                   reps)
    graph_ms = graph_time(
        lambda: cc.lchain_dp_chunked(*args, window=W, tile=T), 2 * reps)
    # rows the walk evaluated on this data: the top 128 (capped at i)
    # of every anchor, 64 per block walked
    rows = walk["top"] + 64 * walk["blocks"]
    bms, by = bound(chain_bytes(args), rows * CHAIN_OPS_PER_ROW)
    n_anchor = int(args[4].to(torch.int64).sum())
    log(f"chunked chain ({B}, {A}, W={W}, T={T}): bitwise equal, sure "
        f"flags equal to K2's ({int(got[2].sum())}/{B}); {walk['blocks']} "
        f"blocks walked over {n_anchor} anchors ({rows} rows); kernel "
        f"{ms:.4f} ms against K2's {k2['ms']:.4f} ms (K3/K2 "
        f"{ms / k2['ms']:.3f}); replayed from a CUDA graph {graph_ms:.4f} "
        f"ms against K2's {k2['graph_ms']:.4f} ms (K3/K2 "
        f"{graph_ms / k2['graph_ms']:.3f}); plain {plain:.1f} ms, bound "
        f"{bms:.4f} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "k2_ms": k2["ms"], "k3_over_k2": ms / k2["ms"],
            "k2_graph_ms": k2["graph_ms"],
            "k3_over_k2_graph": graph_ms / k2["graph_ms"]}


BT_PHASES = ("order", "walk", "flags", "compact")


def check_backtrack(front, args, k2_out, reps, max_steps=None):
    """The fused backtrack kernel (csrc/backtrack.cu, one launch of
    backtrack_compact) against its plain version on K2's outputs,
    bitwise on every output; its CUDA-event and CUDA-graph times and
    each phase's clock64() cycles from its clock buffer."""
    from minigraph_tpu_torch.mapping.device_front import UCAP
    from minigraph_tpu_torch.ops import backtrack as bt
    f, p, _ = k2_out
    opt = front.opt
    bargs = (f, p, args[4], *args[:4])
    kw = dict(min_cnt=int(opt.min_lc_cnt), min_sc=int(opt.min_lc_score),
              max_drop=int(opt.bw), ucap=UCAP, max_steps=max_steps)
    got = bt.backtrack_compact(*bargs, **kw)
    t0 = time.perf_counter()
    ref = bt.backtrack_compact_ref(*bargs, **kw)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    keys = ("c_axh", "c_axl", "c_ayh", "c_ayl", "u_sc", "u_cnt", "n_u",
            "n_v", "bt_unsure", "steps")
    err = max_abs_err([got[k] for k in keys], [ref[k] for k in keys])
    B, A = f.shape
    if err:
        bad = [k for k in keys if not torch.equal(got[k], ref[k])]
        raise AssertionError(f"backtrack kernel differs at {(B, A)}: {bad}")
    n_flag = int(got["bt_unsure"].sum())
    steps = got["steps"]
    if max_steps is not None:
        over = steps >= max_steps
        if not over.any() or not got["bt_unsure"][over].all():
            raise AssertionError("the step budget flagged no lane")
    ms = cuda_time(lambda: bt.backtrack_compact(*bargs, **kw), reps)
    graph_ms = graph_time(lambda: bt.backtrack_compact(*bargs, **kw), reps)
    clk = torch.zeros((B, 4), dtype=torch.int64, device=f.device)
    timed = bt.backtrack_compact(*bargs, clock=clk, **kw)
    if max_abs_err([timed[k] for k in keys], [got[k] for k in keys]):
        raise AssertionError("the clock buffer changed the backtrack")
    cyc = clk.to(torch.float64)
    if not bool((cyc > 0).all()):
        raise AssertionError("the backtrack's clock buffer has empty slots")
    cycles = {name: {"max": int(cyc[:, i].max()),
                     "mean": round(float(cyc[:, i].mean()), 1)}
              for i, name in enumerate(BT_PHASES)}
    # f, p and four anchor planes in; four compacted planes, u (score and
    # count) and n_u, n_v, the flag out
    nbytes = B * A * 4 * 6 + B * A * 4 * 4 + B * UCAP * 4 * 2 + B * 12
    bms, by = bound(nbytes, 0)
    log(f"backtrack ({B}, {A}{', max_steps ' + str(max_steps) if max_steps else ''}): "
        f"bitwise equal, {n_flag}/{B} lanes flagged, {int(got['n_u'].sum())}"
        f" chains; steps max {int(steps.max())} mean "
        f"{float(steps.float().mean()):.1f} (budget {max_steps or 8 * A + 16});"
        f" backtrack_compact {ms:.4f} ms ({graph_ms:.4f} ms replayed from a "
        f"CUDA graph); cycles a block, max/mean: "
        + ", ".join(f"{k} {v['max']}/{v['mean']:.0f}"
                    for k, v in cycles.items())
        + f"; plain {plain:.1f} ms, bound {bms:.4f} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "cycles": cycles, "shape": [B, A],
            "max_steps": int(steps.max())}


def check_buckets(front, batches, reps):
    """K2, K3 and the backtrack kernel on the same collected inputs at
    each bucket shape; the backtrack once more with a step budget small
    enough to flag lanes."""
    out = []
    for seqs, pad_len, r in zip(batches, (2048, 8192, 32768), reps):
        args, W, T = chain_inputs(front, seqs, pad_len)
        k2, k2_out = check_chain(args, W, T, r)
        k3 = check_chunked(args, W, T, r, k2, k2_out[2])
        kb = check_backtrack(front, args, k2_out, r)
        if pad_len == 8192:
            check_backtrack(front, args, k2_out, 2,
                            max_steps=max(1, kb["max_steps"] // 2))
        out.append((k2, k3, kb))
    return out


def tables_to(ji, device):
    """A copy of index tables on another device."""
    return dataclasses.replace(ji, **{
        f.name: getattr(ji, f.name).to(device)
        for f in dataclasses.fields(ji)
        if isinstance(getattr(ji, f.name), torch.Tensor)})


def float_err(got, ref):
    return float((got.double() - ref.double()).abs().max()) \
        if got.numel() else 0.0


def check_ring_chain(res, reps, W=STEP_KW["window"], T=256):
    """K4 against its plain version on the step's anchors."""
    from minigraph_tpu_torch.ops.chain import (lchain_dp_planes,
                                               lchain_dp_tiled_ref)
    planes = res[:5]
    got = lchain_dp_planes(*planes, window=W, tile=T)
    t0 = time.perf_counter()
    ref = lchain_dp_tiled_ref(*planes, 5000, 5000, 500, 0.1827, 0.00913,
                              window=W, tile=T)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err = max_abs_err(got, ref)
    if err:
        raise AssertionError(f"ring chain kernel differs: {err}")
    ms = cuda_time(lambda: lchain_dp_planes(*planes, window=W, tile=T), reps)
    graph_ms = graph_time(lambda: lchain_dp_planes(*planes, window=W,
                                                   tile=T), reps)
    B, A = planes[0].shape
    n_a = planes[4].to(torch.int64).cpu().numpy()
    # window rows these anchors visit: anchor i scores min(i, W) rows
    rows = sum(int(np.minimum(np.arange(n), W).sum()) for n in n_a.tolist())
    bms, by = bound(B * A * (4 * 4 + 2 * 4), rows * CHAIN_OPS_PER_ROW)
    log(f"ring chain ({B}, {A}, W={W}, T={T}): bitwise equal, n_a mean "
        f"{n_a.mean():.1f} max {n_a.max()}; kernel {ms:.4f} ms "
        f"({graph_ms:.4f} ms replayed from a CUDA graph), plain "
        f"{plain:.1f} ms, bound {bms:.4f} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def probe_library(sq, km, ke, rows=16384):
    """The two-product formulation in float32 (TF32 off): the yardstick
    of the probe kernels, never called by the port."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 would break the D == 0 test")
    nb, _, KB = km.shape
    _, B, SB = sq.shape
    qb = SB // nb
    q = sq.reshape(9, B, nb, qb).permute(2, 1, 3, 0).reshape(nb, B * qb, 9)
    out = torch.empty((nb, ke.shape[1], B * qb), device=sq.device)
    for v in range(nb):
        for r0 in range(0, B * qb, rows):
            ind = (q[v, r0: r0 + rows] @ km[v] == 0).float()
            out[v, :, r0: r0 + rows] = ke[v] @ ind.T
    return out


def check_probe(sq, km, ke, present, flat, reps):
    """K5 (flat=False) or K6 against its plain version; present slots
    bitwise, empty ones within KB * 2^-24 relative."""
    from minigraph_tpu_torch.ops import probe
    kern = probe.probe_flat if flat else probe.probe_bucketed
    ref_fn = probe.probe_flat_ref if flat else probe.probe_bucketed_ref
    nb, _, KB = km.shape
    got = kern(sq, km, ke)
    t0 = time.perf_counter()
    ref = ref_fn(sq, km, ke)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got[:, present], ref[:, present]):
        raise AssertionError("probe kernel differs on present slots")
    empty_rel = 0.0
    if (~present).any():
        a, b = got[:, ~present].double(), ref[:, ~present].double()
        empty_rel = float(((a - b).abs() / b.abs().clamp(min=1)).max())
        if empty_rel > KB * 2.0 ** -24:
            raise AssertionError(f"probe kernel empty slots off by "
                                 f"{empty_rel:.3g} relative")
    err = float_err(got, ref)
    ms = cuda_time(lambda: kern(sq, km, ke), reps)
    lib = cuda_time(lambda: probe_library(sq, km, ke), 1)
    _, B, SB = sq.shape
    EXT = ke.shape[1]
    n_present = int(present.sum())
    matches = int((got[1][present] > 0).sum())
    nbytes = 4 * (sq.numel() + km.numel() + ke.numel() + EXT * B * SB)
    # present slots against every key of their bucket; an empty slot's
    # distance to every key is zero by construction, so it costs its
    # bucket's column sum, counted once per bucket
    ops = (PROBE_OPS_PER_PAIR * n_present * KB + 2 * EXT * matches
           + (nb * EXT * KB if n_present < B * SB else 0))
    bms, by = bound(nbytes, ops)
    name = "flat" if flat else "bucketed"
    log(f"{name} probe (9, {B}, {SB}) x ({nb}, 9, {KB}): present slots "
        f"bitwise equal ({n_present} present, {matches} matched), empty "
        f"slots max rel err {empty_rel:.3g}; kernel {ms:.4f} ms, plain "
        f"{plain:.1f} ms, two-matmul library {lib:.3f} ms, bound "
        f"{bms:.4f} ms ({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib}


def gap_pairs(ref, rng, n):
    """Gap jobs of the -c buckets (256-2048 bp): the target cut from the
    reference, the query a copy with 2% substitutions and 1% indels of
    1-3 bp; every 20th query loses 80-200 bp at its end, a length skew
    beyond the band."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    seq = np.frombuffer(ref.encode(), np.uint8)
    pairs = []
    for k in range(n):
        L = int(rng.integers(256, 2049))
        st = int(rng.integers(0, len(seq) - L))
        t = seq[st: st + L]
        q = t.copy()
        sub = rng.random(L) < 0.02
        q[sub] = rng.choice(acgt, int(sub.sum()))
        # from the end backwards, so earlier positions stay in place
        for pos in np.sort(rng.choice(L, rng.binomial(L, 0.01),
                                      replace=False))[::-1].tolist():
            ln = int(rng.integers(1, 4))
            q = np.insert(q, pos, rng.choice(acgt, ln)) \
                if rng.random() < 0.5 \
                else np.concatenate([q[:pos], q[pos + ln:]])
        if k % 20 == 19:
            q = q[: len(q) - int(rng.integers(80, 201))]
        pairs.append((t.tobytes(), q.tobytes()))
    return pairs


def wfa_phase(ref, kernels, reps):
    """Phase 6: K7 through banded_score on the gap pairs."""
    from minigraph_tpu_torch.ops.wfa_banded import (banded_score,
                                                    banded_score_planes,
                                                    banded_score_ref,
                                                    encode_pairs)
    pairs = gap_pairs(ref, np.random.default_rng(50), WFA_PAIRS)
    kernels.reset_launches()
    scores = banded_score(pairs, wa=WFA_WA)
    launches = kernels.launches["wfa_banded"]
    if launches <= 0:
        raise AssertionError("wfa_banded kernel not launched by banded_score")
    known = banded_score([(b"ACGTACGT", b"ACGAACGT"), (b"ACGT" * 8,) * 2,
                          (b"ACGT" * 30, b"ACGT")], wa=WFA_WA)
    if known.tolist() != [4, 0, -1]:
        raise AssertionError(f"banded_score on known pairs: {known}")
    planes = encode_pairs(pairs, "cuda")
    got = banded_score_planes(*planes, wa=WFA_WA)
    t0 = time.perf_counter()
    ref_raw = banded_score_ref(*planes, wa=WFA_WA)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    err = max_abs_err([got], [ref_raw])
    if err:
        raise AssertionError(f"banded kernel differs: {err}")
    raw = ref_raw.cpu().numpy()
    if not np.array_equal(scores, np.where(raw >= 1 << 28, -1, raw)):
        raise AssertionError("banded_score differs from the plain version")
    if (scores[19::20] != -1).any():
        raise AssertionError("a pair skewed beyond the band was scored")
    ms = cuda_time(lambda: banded_score_planes(*planes, wa=WFA_WA), reps)
    graph_ms = graph_time(lambda: banded_score_planes(*planes, wa=WFA_WA),
                          reps)
    tseq, _, tl, ql = planes
    B, L = tseq.shape
    # the band's cells up to each pair's end anti-diagonal; the two
    # sequence planes, the lengths and the scores once
    cells = WFA_WA * int((tl.long() + ql.long() + 1).sum())
    bms, by = bound(2 * B * L + 12 * B, cells * WFA_OPS_PER_CELL)
    log(f"banded score ({B} pairs, L={L}, wa={WFA_WA}): bitwise equal; "
        f"{int((scores >= 0).sum())} scored, {int((scores < 0).sum())} "
        f"outside the band, mean score {scores[scores >= 0].mean():.1f}; "
        f"kernel {ms:.4f} ms ({graph_ms:.4f} ms replayed from a CUDA "
        f"graph), plain {plain:.1f} ms, bound {bms:.4f} ms ({by}); "
        f"launches {launches}")
    return launches, {"max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
                      "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                      "library_ms": None}


def forced_bail_run(gi, mo, reads, every, loop="native"):
    """device_run with the native batch tail reporting a bail (status !=
    0) for every `every`-th read of each batch, so those reads take the
    exact per-read path (mapping/mapper.py map_frag)."""
    from minigraph_tpu_torch.mapping import mapper
    real = mapper.map_batch_native

    def bailing(*args, **kw):
        res = real(*args, **kw)
        return {k: None if k % every == 0 else v for k, v in res.items()}
    mapper.map_batch_native = bailing
    try:
        return device_run(gi, mo, reads, loop)
    finally:
        mapper.map_batch_native = real


def device_run(gi, mo, reads, loop="native", n_host=0, pool=None):
    """The port's file loop with a front on the card and the host/device
    split pinned at share 0 (every eligible read to the device), held to
    have sent n_host reads (the ineligible ones) to the host and kept
    the share at 0.  loop="native": the native file loop; loop="python":
    the native reader refused, so the Python reader loop maps the file
    (the loop of a file the native reader cannot open, e.g. stdin).
    `pool`: the front's -c gap pool (else the loop makes one).
    Returns (GAF text, stats)."""
    from minigraph_tpu_torch.mapping import mapper
    from minigraph_tpu_torch.mapping.device_front import DeviceFront
    from minigraph_tpu_torch.mapping.split import ShareSplit
    front = DeviceFront(gi, mo, device="cuda")
    front._split_state = ShareSplit(share=0.0)
    front._wfa_pool = pool
    buf, st = io.StringIO(), {}

    def refuse(fn):
        raise OSError(f"cannot open {fn}")
    real = mapper.NativeSeqReader
    if loop == "python":
        mapper.NativeSeqReader = refuse
    try:
        mapper.map_reads(gi, mo, [reads], buf, 8, front, st)
    finally:
        mapper.NativeSeqReader = real
    if ("n_arena" in st) != (loop == "native"):
        raise AssertionError(f"{loop} loop: arena batches {st}")
    # the pin holds only while the host measures no eligible read's cost
    if st["n_share_host"] != n_host or st["share"] != 0.0:
        raise AssertionError(f"the pinned split sent "
                             f"{st['n_share_host']} reads to the host, "
                             f"{n_host} expected (share {st['share']})")
    return buf.getvalue(), st


def split_run(fa, gfa, io_, mo, max_bp=None):
    """map_files(device="cuda") as the command line runs it, the split as
    it starts (share 0.35), at the default -K or at `max_bp`.  Returns
    (GAF text, stats)."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.mapping.mapper import map_files
    mo_k = dataclasses.replace(mo)
    if max_bp is not None:
        mo_k.mini_batch_size = max_bp
    buf, st = io.StringIO(), {}
    map_files(read_gfa(gfa), [fa], io_, mo_k, out=buf, n_threads=8,
              device="cuda", stats=st)
    st["max_bp"] = mo_k.mini_batch_size
    return buf.getvalue(), st


def split_line(name, st):
    """What the split's controller reached in one run."""
    return (f"{name} (-K {st['max_bp']}): final share {st['share']:.3f}, "
            f"collapsed {st['collapsed']}, {st.get('n_probes', 0)} probes, "
            f"{st['n_share_dev']} reads to the device share, "
            f"{st['n_share_host']} to the host share, {st['n_device']} kept "
            f"on the device, {st['n_batches']} device batches, "
            f"{st['n_arena']} arena batches")


def run_line(name, st, n_reads):
    """reads/s and stage ms of one main-path run."""
    stages = {k: round(v, 3) for k, v in st.get("stage_ms", {}).items()}
    stages["tail_host"] = round(st.get("tail_ms", 0.0), 3)
    return (f"{name}: {n_reads / (st['map_ms'] / 1e3):.1f} reads/s (map "
            f"{st['map_ms']:.1f} ms); device share {st.get('n_share_dev', 0)}"
            f" reads, host share {st.get('n_share_host', 0)}, "
            f"{st.get('n_arena', 0)} arena batches; stage ms (device: CUDA "
            f"events; tail: host clock) {stages}")


def first_diff(a, b):
    """Line number of the first difference of two GAF texts."""
    a, b = a.splitlines(), b.splitlines()
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def step_rate(step, codes, lens):
    """reads/s of a map step as bench.py bench_stage times it: the mean
    of 3 synchronised calls after a warm-up call."""
    step(codes, lens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(codes, lens)
    torch.cuda.synchronize()
    return codes.shape[0] / ((time.perf_counter() - t0) / 3)


def step_phase(gi, hash_tables, reads, flat_gi, flat_reads, kernels):
    """Phase 5: the batched map step at bench.py's stage shape."""
    from minigraph_tpu_torch.ops.anchors import (JoinIndex,
                                                 collect_anchors_flat,
                                                 collect_anchors_hash,
                                                 flat_queries, step_queries)
    from minigraph_tpu_torch.ops.anchors_bucketed import (BucketedJoinIndex,
                                                          spread_queries)
    from minigraph_tpu_torch.ops.pipeline import make_map_step_v3
    from minigraph_tpu_torch.ops.sketch import encode_batch, sketch_planes

    kw = {k: v for k, v in STEP_KW.items() if k != "b_chunk"}
    w, k = gi.w, gi.k
    t0 = time.perf_counter()
    bkt = BucketedJoinIndex.from_host(gi, STEP_KW["occ_cap"], "cuda")
    flat = JoinIndex.from_host(flat_gi, STEP_KW["occ_cap"], "cuda")
    nb, _, KB = bkt.keymat.shape
    log(f"step tables in {time.perf_counter() - t0:.1f} s: bucketed nb={nb}"
        f" qb=24 KB={KB} (keyext {bkt.keyext.numel() * 4 / 2**20:.1f} MiB);"
        f" flat graph {len(flat_gi.keys)} keys, Kpad={flat.km_p.shape[2]}")
    if len(flat_gi.keys) >= 100_000:
        raise AssertionError("the flat graph must stay below 1e5 keys")
    tables = {"a": hash_tables, "b": bkt, "c": flat}
    steps = {n: make_map_step_v3(t, w, k, **STEP_KW)
             for n, t in tables.items()}
    def encode(r):
        return [torch.from_numpy(a).cuda()
                for a in encode_batch(r, pad_to=STEP_PAD)]

    enc_5m = encode(reads)
    batch = {"a": enc_5m, "b": enc_5m, "c": encode(flat_reads)}
    max_occ = 50            # make_map_step_v3's default

    # ---- the phase's path, with the launch counts
    kernels.reset_launches()
    out = {n: steps[n](*batch[n]) for n in steps}
    sp_c = sketch_planes(*batch["c"], w, k)
    flat_res = collect_anchors_flat(flat, *sp_c[:6], max_occ, kw["occ_cap"],
                                    qcap=kw["qcap"], acap=kw["acap"])
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for name in ("sketch", "chain_ring", "probe_bucketed", "probe_flat"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel not launched by the step")
    for n, o in out.items():
        for key, v in o.items():
            if v.shape[0] != STEP_B:
                raise AssertionError(f"step ({n}) {key}: {tuple(v.shape)}")
        if int(o["n_anchors"].sum()) == 0:
            raise AssertionError(f"step ({n}) found no anchors")
    log(f"step launches {launches}; flat collect n_a mean "
        f"{flat_res[4].double().mean():.1f}")

    # ---- the card's step against the CPU's, first 64 reads
    for n, t in tables.items():
        codes, lens = batch[n]
        cpu = make_map_step_v3(tables_to(t, "cpu"), w, k, **STEP_KW)(
            codes[:64].cpu(), lens[:64].cpu())
        for key, v in cpu.items():
            if not torch.equal(v, out[n][key][:64].cpu()):
                raise AssertionError(f"step ({n}) {key}: card != CPU")
    # hashed and bucketed joins are exact over the same index
    ok = ~(out["a"]["overflow"] | out["b"]["overflow"])
    for key in ("n_anchors", "f", "p"):
        if not torch.equal(out["a"][key][ok], out["b"][key][ok]):
            raise AssertionError(f"hash and bucketed steps differ: {key}")
    log(f"step: card == CPU on 64 reads for (a) hash, (b) bucketed, (c) "
        f"flat; (a) == (b) on {int(ok.sum())}/{STEP_B} unflagged reads")

    # ---- kernels against their plain versions at these inputs
    sp = sketch_planes(*enc_5m, w, k)
    res = collect_anchors_hash(hash_tables, *sp[:6], max_occ, kw["occ_cap"],
                               qcap=kw["qcap"], acap=kw["acap"])
    k4 = check_ring_chain(res, reps=20)
    sf, _, _ = spread_queries(*sp[:6], nb, qcap=kw["qcap"])
    k5 = check_probe(sf[:9], bkt.keymat, bkt.keyext, sf[8] > 0, False,
                     reps=10)
    qhh, qhl, _, _, qvalid = step_queries(*sp_c[:6], kw["qcap"])
    sq_c = flat_queries(qhh, qhl, qvalid)
    k6 = check_probe(sq_c, flat.km_p, flat.ke_p, sq_c[8] != 0, True,
                     reps=5)

    rates = {}
    for n in steps:
        rates[n] = step_rate(steps[n], *batch[n])
    log(f"step reads/s (mean of 3 after a warm-up): (a) hash "
        f"{rates['a']:.1f}, (b) bucketed {rates['b']:.1f}, (c) flat "
        f"{rates['c']:.1f}")
    return launches, k4, k5, k6


def host_run(gi, mo, fns):
    """Host-only mapping of `fns` on a built index: (GAF text, stats)."""
    from minigraph_tpu_torch.mapping.mapper import map_reads
    buf, st = io.StringIO(), {}
    map_reads(gi, mo, fns, buf, 8, None, st)
    return buf.getvalue(), st


def cli_phase(ref, gfa, work, kernels, k1_asm):
    """Phase 7 (a) asm and (b) sr on the phase 4 graph."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.mapping.mapper import map_files
    from minigraph_tpu_torch.options import IndexOptions, MapOptions, opt_set
    from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                                 simulate_pairs, write_fasta)
    t0 = time.perf_counter()
    hap7 = make_haplotype(ref, seed=7)
    ctg = cut_contigs(hap7, seed=8)
    asm_fa = str(work / "asm_contigs.fa")
    write_fasta(asm_fa, ctg)
    r1, r2 = simulate_pairs(hap7, 50_000, seed=9)
    sr_fa = [str(work / "sr_1.fa"), str(work / "sr_2.fa")]
    write_fasta(sr_fa[0], r1)
    write_fasta(sr_fa[1], r2)
    sr_int = str(work / "sr_interleaved.fa")
    write_fasta(sr_int, [x for p in zip(r1, r2) for x in p])
    lens = np.array([len(s) for _, s in ctg])
    n_long = int((lens > 32768).sum())
    log(f"phase 7 inputs in {time.perf_counter() - t0:.1f} s: {len(ctg)} "
        f"contigs ({int(lens.sum())} bp, mean {lens.mean():.0f}, median "
        f"{np.median(lens):.0f}, {n_long} over 32 kb), {len(r1)} pairs")
    for (B, L), k in zip(((256, 2048), (128, 8192), (128, 32768)), k1_asm):
        log(f"sketch (19, 10) at ({B}, {L}): {json.dumps(k)}")

    # (a) asm
    io_a, mo_a = IndexOptions(), MapOptions()
    opt_set("asm", io_a, mo_a)
    t0 = time.perf_counter()
    gi_a = build_index(read_gfa(gfa), io_a.k, io_a.w, mo_a)
    log(f"asm index: {len(gi_a.keys)} keys (k={io_a.k}, w={io_a.w}) in "
        f"{time.perf_counter() - t0:.1f} s")
    host_a, st_ha = host_run(gi_a, mo_a, [asm_fa])
    device_run(gi_a, mo_a, asm_fa, n_host=n_long)      # one-time costs
    kernels.reset_launches()
    gaf_a, st_a = device_run(gi_a, mo_a, asm_fa, n_host=n_long)
    launches = dict(kernels.launches)
    if gaf_a != host_a:
        raise AssertionError(f"asm: GAF differs from the host run at line "
                             f"{first_diff(gaf_a, host_a)}")
    if launches["sketch"] <= 0 or launches["sketch"] != st_a["n_batches"]:
        raise AssertionError(f"asm: sketch launches {launches} for "
                             f"{st_a['n_batches']} device batches")
    for name in ("chain_exact", "chain_chunked", "backtrack"):
        if launches[name]:
            raise AssertionError(f"asm: the seed-only front launched "
                                 f"{name}: {launches}")
    if set(st_a["stage_ms"]) != {"sketch", "collect", "pack"}:
        raise AssertionError(f"asm stages {st_a['stage_ms']}")
    if st_a["n_share_dev"] != len(ctg) - n_long or st_a["n_device"] <= 0:
        raise AssertionError(f"asm: {st_a['n_share_dev']} contigs to the "
                             f"device, {st_a['n_device']} kept")
    log(f"phase 7 (a) asm, share pinned at 0: GAF bytes equal to the "
        f"host-only run ({host_a.count(chr(10))} lines, {len(host_a)} "
        f"bytes); n_device {st_a['n_device']}, n_fallback "
        f"{st_a['n_fallback']}, {st_a['n_batches']} device batches, "
        f"{n_long} contigs over 32 kb to the host, per-read path "
        f"{st_a['n_perread']}; launches "
        f"{launches}")
    log(run_line("run (a) asm, seed-only front", st_a, len(ctg)))
    log(run_line("run (a) asm, host only", st_ha, len(ctg))
        + ", 8 host threads")

    # (b) sr: two files through map_files(device="cuda"), host only, and
    # the interleaved file through the native arena loop
    io_s, mo_s = IndexOptions(), MapOptions()
    opt_set("sr", io_s, mo_s)
    t0 = time.perf_counter()
    gi_s = build_index(read_gfa(gfa), io_s.k, io_s.w, mo_s)
    log(f"sr index: {len(gi_s.keys)} keys (k={io_s.k}, w={io_s.w}) in "
        f"{time.perf_counter() - t0:.1f} s")
    host_s, st_hs = host_run(gi_s, mo_s, sr_fa)
    int_s, st_is = host_run(gi_s, mo_s, [sr_int])
    buf, st_ds = io.StringIO(), {}
    kernels.reset_launches()
    map_files(read_gfa(gfa), sr_fa, io_s, mo_s, out=buf, n_threads=8,
              device="cuda", stats=st_ds)
    for name, got, st in (("two files on the card", buf.getvalue(), st_ds),
                          ("interleaved, native arena loop", int_s, st_is)):
        if got != host_s:
            raise AssertionError(f"sr {name}: GAF differs from the host run "
                                 f"at line {first_diff(got, host_s)}")
    if st_ds["n_device"] != 0 or "n_arena" in st_ds \
            or st_is["n_arena"] <= 0:
        raise AssertionError(f"sr: {st_ds}; {st_is}")
    n_pairs = len(r1)
    log(f"phase 7 (b) sr: GAF bytes equal in all three runs "
        f"({host_s.count(chr(10))} lines, {len(host_s)} bytes); n_device "
        f"{st_ds['n_device']} (heap-sort reads are not device-eligible), "
        f"launches {dict(kernels.launches)}")
    for name, st in (("two files, map_files(device='cuda')", st_ds),
                     ("two files, host only", st_hs),
                     ("interleaved, native arena loop", st_is)):
        log(run_line(f"run (b) sr {name}", st, n_pairs) + " (pairs/s)")
    return gi_a, mo_a, asm_fa, n_long, len(ctg), st_a


def forced_python_run(gi, mo, reads_fa, host_gaf, n_reads, kernels):
    """Phase 7 (c): phase 4's reads through the Python reader loop (the
    native reader refused), the split pinned at share 0, a bail forced
    on every 40th read of a batch."""
    kernels.reset_launches()
    gaf, st = forced_bail_run(gi, mo, reads_fa, 40, "python")
    if gaf != host_gaf:
        raise AssertionError(f"Python loop with forced bails: GAF differs "
                             f"at line {first_diff(gaf, host_gaf)}")
    launches = dict(kernels.launches)
    for name in ("sketch", "chain_exact", "backtrack"):
        if launches[name] <= 0:
            raise AssertionError(f"Python loop: {name} not launched")
    if launches["backtrack"] != st["n_batches"] or st["n_perread"] <= 0:
        raise AssertionError(f"Python loop: {launches}, {st}")
    log(f"phase 7 (c) Python reader loop, forced bails: {st['n_perread']} "
        f"reads re-mapped on the per-read path, {st['n_device']} kept on "
        f"the device, GAF bytes equal to the host-only run; launches "
        f"{launches}")
    log(run_line("run (c) forced bails, Python loop", st, n_reads))


def stages_line(name, st):
    """Stage ms (device: CUDA events) and the native tail's host ms."""
    stages = {k: round(v, 3) for k, v in st.get("stage_ms", {}).items()}
    return (f"{name}: map {st['map_ms']:.1f} ms, native tail "
            f"{st.get('tail_ms', 0.0):.1f} ms (host clock), stages {stages}")


def cigar_main_path(gi, mo, reads_fa, st_noc, n_reads, kernels):
    """Phase 8 (a): -cx lr through the native file loop, the split
    pinned at share 0 with K2, against host only; then a bail forced on
    every 40th read."""
    from minigraph_tpu_torch.options import MG_M_CIGAR
    mo_c = dataclasses.replace(mo, flag=mo.flag | MG_M_CIGAR)
    host_c, st_hc = host_run(gi, mo_c, [reads_fa])
    kernels.reset_launches()
    gaf_c, st_c = device_run(gi, mo_c, reads_fa)
    launches = dict(kernels.launches)
    if gaf_c != host_c:
        raise AssertionError(f"-c: GAF differs from the host run at line "
                             f"{first_diff(gaf_c, host_c)}")
    n_lines = host_c.count("\n")
    n_cg, n_ds = host_c.count("\tcg:Z:"), host_c.count("\tds:Z:")
    if n_cg < 0.9 * n_lines or n_ds < 0.9 * n_lines:
        raise AssertionError(f"-c: {n_cg} cg:Z and {n_ds} ds:Z in "
                             f"{n_lines} lines")
    for name in ("sketch", "chain_exact", "backtrack"):
        if launches[name] <= 0:
            raise AssertionError(f"-c: {name} not launched: {launches}")
    if launches["backtrack"] != st_c["n_batches"]:
        raise AssertionError(f"-c: launches {launches}, {st_c}")
    tot = st_c["n_device"] + st_c["n_fallback"] + st_c["n_chain_unsure"]
    if st_c["n_device"] < 0.8 * tot:
        raise AssertionError(f"-c: {st_c['n_device']}/{tot} on the device")
    kernels.reset_launches()
    forced, st_f = forced_bail_run(gi, mo_c, reads_fa, 40)
    if forced != host_c or st_f["n_perread"] <= 0:
        raise AssertionError(f"-c with forced bails: GAF differs at line "
                             f"{first_diff(forced, host_c)}, {st_f}")
    log(f"phase 8 (a) -cx lr, share pinned at 0 with K2: GAF bytes equal "
        f"to the host-only run ({n_lines} lines, {len(host_c)} bytes, "
        f"{n_cg} cg:Z, {n_ds} ds:Z); {st_c['n_device']}/{tot} eligible "
        f"reads on the device; launches {launches}; forced bails: "
        f"{st_f['n_perread']} reads on the per-read path, bytes equal")
    log(stages_line("phase 8 (a) device path with -c", st_c))
    log(stages_line("phase 8 (a) device path without -c (run (i))", st_noc))
    log(run_line("run 8 (a) -c device path", st_c, n_reads))
    log(run_line("run 8 (a) -c host only", st_hc, n_reads)
        + ", 8 host threads")
    log(run_line("run 8 (a) -c forced bails", st_f, n_reads))
    return mo_c


def cigar_asm(gi_a, mo_a, asm_fa, n_long, n_ctg, st_noc, kernels):
    """Phase 8 (b): -cx asm on the seed-only front against host only."""
    from minigraph_tpu_torch.options import MG_M_CIGAR
    mo_c = dataclasses.replace(mo_a, flag=mo_a.flag | MG_M_CIGAR)
    host_c, st_hc = host_run(gi_a, mo_c, [asm_fa])
    kernels.reset_launches()
    gaf_c, st_c = device_run(gi_a, mo_c, asm_fa, n_host=n_long)
    launches = dict(kernels.launches)
    if gaf_c != host_c:
        raise AssertionError(f"-cx asm: GAF differs from the host run at "
                             f"line {first_diff(gaf_c, host_c)}")
    if launches["sketch"] <= 0 or launches["chain_exact"] \
            or launches["backtrack"] or host_c.count("\tcg:Z:") <= 0:
        raise AssertionError(f"-cx asm: launches {launches}")
    log(f"phase 8 (b) -cx asm, seed-only front, share pinned at 0: GAF "
        f"bytes equal to the host-only run ({host_c.count(chr(10))} lines, "
        f"{len(host_c)} bytes, {host_c.count(chr(9) + 'cg:Z:')} cg:Z); "
        f"n_device {st_c['n_device']}, launches {launches}")
    log(stages_line("phase 8 (b) asm device path with -c", st_c))
    log(stages_line("phase 8 (b) asm device path without -c (7 (a))",
                    st_noc))
    log(run_line("run 8 (b) -cx asm, seed-only front", st_c, n_ctg))
    log(run_line("run 8 (b) -cx asm, host only", st_hc, n_ctg)
        + ", 8 host threads")


def cigar_pool_run(gi, mo_c, reads_fa, n_reads, kernels):
    """Phase 8 (c): -c --vc through the Python reader loop with the front
    pinned, the native anchor walk declined for every 4th chain, so
    those chains' gaps go to the front's gap pool on the card; against
    the unstubbed host-only -c --vc run.  Returns the kernels'
    launches."""
    from minigraph_tpu_torch.align import cigar
    from minigraph_tpu_torch.align.cigar_device import (BUCKETS,
                                                        MIN_DEV_LEN,
                                                        DeviceWfaPool)
    from minigraph_tpu_torch.options import MG_M_VERTEX_COOR
    mo_v = dataclasses.replace(mo_c, flag=mo_c.flag | MG_M_VERTEX_COOR)
    host_v, st_hv = host_run(gi, mo_v, [reads_fa])
    pool = DeviceWfaPool(device="cuda")
    seen = []
    pool_run = pool.run

    def run(jobs):
        seen.extend(max(len(t), len(q)) for t, q in jobs)
        return pool_run(jobs)
    pool.run = run
    real = cigar._gchain_cigar_native
    n = [0]

    def decline(*args):
        n[0] += 1
        return False if n[0] % 4 == 0 else real(*args)
    cigar._gchain_cigar_native = decline
    try:
        kernels.reset_launches()
        gaf_v, st_v = device_run(gi, mo_v, reads_fa, loop="python",
                                 pool=pool)
        launches = dict(kernels.launches)
    finally:
        cigar._gchain_cigar_native = real
    if gaf_v != host_v:
        raise AssertionError(f"-c --vc with the gap pool: GAF differs at "
                             f"line {first_diff(gaf_v, host_v)}")
    lens = np.array(seen, dtype=np.int64)
    per_bucket = [int(((lens >= MIN_DEV_LEN) & (lens <= BUCKETS[0][0]))
                      .sum()),
                  int(((lens > BUCKETS[0][0]) & (lens <= BUCKETS[1][0]))
                      .sum())]
    chunks = sum(-(-c // b[2]) for c, b in zip(per_bucket, BUCKETS))
    if pool.n_device <= 0 or launches["wfa_wave"] != chunks \
            or launches["wfa_walk"] != chunks:
        raise AssertionError(f"gap pool: n_device {pool.n_device}, "
                             f"{chunks} chunks, launches {launches}")
    log(f"phase 8 (c) -c --vc, Python reader loop, every 4th chain to the "
        f"gap pool: GAF bytes equal to the unstubbed host-only run "
        f"({host_v.count(chr(10))} lines); {n[0]} chains, {len(lens)} gap "
        f"jobs: {int((lens < MIN_DEV_LEN).sum())} under {MIN_DEV_LEN} bp, "
        f"{per_bucket[0]} in bucket {BUCKETS[0]}, {per_bucket[1]} in "
        f"bucket {BUCKETS[1]}, {int((lens > BUCKETS[1][0]).sum())} over "
        f"{BUCKETS[1][0]} bp (longest {int(lens.max()) if len(lens) else 0}"
        f"); pool n_device {pool.n_device}, n_host {pool.n_host}; "
        f"launches {launches}")
    log(run_line("run 8 (c) -c --vc, gap pool", st_v, n_reads))
    log(run_line("run 8 (c) -c --vc, host only", st_hv, n_reads))
    return launches


def wfa_exact_phase(ref, reps):
    """Phase 8 (d): wfa_wave and wfa_walk at the pool's two buckets on
    gap pairs cut from the reference, bitwise against the plain versions
    on one full chunk a bucket; the CIGARs of 4096 pairs against the
    native host engine."""
    from minigraph_tpu_torch.align.cigar_device import BUCKETS, PENS
    from minigraph_tpu_torch.align.wfa import WfOpt, wfa_exact
    from minigraph_tpu_torch.ops import wfa_exact as wx
    pairs = gap_pairs(ref, np.random.default_rng(52), WFA_PAIRS)
    sizes = [max(len(t), len(q)) for t, q in pairs]
    buckets = [[p for p, n in zip(pairs, sizes) if lo < n <= lmax]
               for lo, (lmax, _, _) in zip((0, BUCKETS[0][0]), BUCKETS)]
    res = []
    for (lmax, s_cap, bsz), bp in zip(BUCKETS, buckets):
        enc = wx.encode_pairs(bp[:bsz], L=lmax, device="cuda")
        t_cap = 2 * lmax + 4
        score, tb, _, end_d, no_ext = wx.wfa_device(
            *enc, PENS, d_cap=lmax, s_cap=s_cap)
        counts = {}
        r_score, r_tb, _, r_end, r_noext = wx.wfa_device_ref(
            *enc, PENS, d_cap=lmax, s_cap=s_cap, counts=counts)
        err = max_abs_err([score, end_d, no_ext], [r_score, r_end, r_noext])
        sc = score.cpu().numpy()
        for b in range(len(sc)):
            n = int(sc[b]) if sc[b] >= 0 else s_cap
            if not torch.equal(tb[:n, b], r_tb[:n, b]):
                raise AssertionError(f"wfa_wave tb of pair {b} differs")
        ops, fi, fk = wx.wfa_tb_walk(*enc, tb, score, end_d, no_ext, PENS,
                                     d_cap=lmax, t_cap=t_cap)
        on_k = wx.wfa_tb_walk_ref(*enc, tb, score, end_d, no_ext, PENS,
                                  d_cap=lmax, t_cap=t_cap)
        on_r = wx.wfa_tb_walk_ref(*enc, r_tb, r_score, r_end, r_noext, PENS,
                                  d_cap=lmax, t_cap=t_cap)
        err = max(err, max_abs_err([ops, fi, fk], on_k),
                  max_abs_err([ops, fi, fk], on_r))
        if err:
            raise AssertionError(f"wfa kernels differ at L={lmax}: {err}")
        # plain times without the counters
        t0 = time.perf_counter()
        wx.wfa_device_ref(*enc, PENS, d_cap=lmax, s_cap=s_cap)
        torch.cuda.synchronize()
        plain_wave = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        wx.wfa_tb_walk_ref(*enc, r_tb, r_score, r_end, r_noext, PENS,
                           d_cap=lmax, t_cap=t_cap)
        torch.cuda.synchronize()
        plain_walk = (time.perf_counter() - t0) * 1e3

        def wave():
            wx.wfa_device(*enc, PENS, d_cap=lmax, s_cap=s_cap, tb=tb)

        def walk():
            wx.wfa_tb_walk(*enc, tb, score, end_d, no_ext, PENS,
                           d_cap=lmax, t_cap=t_cap)
        ms_wave, g_wave = cuda_time(wave, reps), graph_time(wave, reps)
        ms_walk, g_walk = cuda_time(walk, reps), graph_time(walk, reps)
        B, L = enc[0].shape
        # the clock buffers' split (the slowest pair of each kernel)
        cw = torch.zeros((B, len(wx.WAVE_CLK)), dtype=torch.int64,
                         device="cuda")
        ck = torch.zeros((B, len(wx.WALK_CLK)), dtype=torch.int64,
                         device="cuda")
        wx.wfa_device(*enc, PENS, d_cap=lmax, s_cap=s_cap, tb=tb, clock=cw)
        wx.wfa_tb_walk(*enc, tb, score, end_d, no_ext, PENS, d_cap=lmax,
                       t_cap=t_cap, clock=ck)
        for name, clk, cols in (("wfa_wave", cw, wx.WAVE_CLK),
                                ("wfa_walk", ck, wx.WALK_CLK)):
            cyc, n = (clk[:, cols.index(c)].cpu() for c in ("cycles",
                                                             "steps"))
            row = clk[int(cyc.argmax())].tolist()
            log(f"{name} clock at L={lmax}, the slowest pair: "
                + ", ".join(f"{c} {v}" for c, v in zip(cols, row))
                + f"; {int(cyc.sum()) / max(1, int(n.sum())):.1f} cycles "
                f"a step over all pairs")
        D = 2 * lmax + 1
        # wave: the sequences in, tb rows below each score and 9 bytes a
        # pair out; ~20 integer operations a wave cell, 3 a compare
        bw = bound(2 * B * L + int(sc[sc > 0].sum()) * D + 9 * B,
                   WFA_EXACT_OPS_PER_CELL * counts["cells"]
                   + 3 * counts["ext"])
        # walk: the sequences, one tb byte a step and the ops out; ~12
        # operations a step
        steps = int((ops.cpu() > 0).sum())
        bk = bound(2 * B * L + steps + t_cap * B + 8 * B, 12 * steps)
        log(f"wfa_wave ({B} pairs, L={L}, D={D}, s_cap={s_cap}): bitwise "
            f"equal (tb on rows below each score), scores {sc.min()}-"
            f"{sc.max()}, {counts['cells']} cells, {counts['ext']} "
            f"compares; kernel {ms_wave:.4f} ms ({g_wave:.4f} ms replayed "
            f"from a CUDA graph), plain {plain_wave:.1f} ms, bound "
            f"{bw[0]:.4f} ms ({bw[1]})")
        log(f"wfa_walk ({B} pairs, t_cap={t_cap}): bitwise equal, {steps} "
            f"steps; kernel {ms_walk:.4f} ms ({g_walk:.4f} ms replayed from "
            f"a CUDA graph), plain {plain_walk:.1f} ms, bound {bk[0]:.4f} "
            f"ms ({bk[1]})")
        res.append(({"max_abs_err": err, "ms": ms_wave, "graph_ms": g_wave,
                     "plain_ms": plain_wave, "bound_ms": bw[0],
                     "bound_by": bw[1], "library_ms": None},
                    {"max_abs_err": err, "ms": ms_walk, "graph_ms": g_walk,
                     "plain_ms": plain_walk, "bound_ms": bk[0],
                     "bound_by": bk[1], "library_ms": None}))
    # every pair through the kernels at full batches, against the host
    n_ok = n_over = 0
    t_dev = 0.0
    for (lmax, s_cap, bsz), bp in zip(BUCKETS, buckets):
        t0 = time.perf_counter()
        for c0 in range(0, len(bp), bsz):
            chunk = bp[c0: c0 + bsz]
            enc = wx.encode_pairs(chunk + [(b"A", b"A")] * (bsz - len(chunk)),
                                  L=lmax, device="cuda")
            score, tb, _, end_d, no_ext = wx.wfa_device(
                *enc, PENS, d_cap=lmax, s_cap=s_cap)
            ops, fi, fk = wx.wfa_tb_walk(*enc, tb, score, end_d, no_ext,
                                         PENS, d_cap=lmax,
                                         t_cap=2 * lmax + 4)
            score, ops, fi, fk = (x.cpu().numpy()
                                  for x in (score, ops, fi, fk))
            t_dev += time.perf_counter() - t0
            for k, (t, q) in enumerate(chunk):
                host = wfa_exact(WfOpt(cigar=True), t, q)
                if score[k] < 0:
                    if host.s < s_cap:
                        raise AssertionError(f"pair over budget on the "
                                             f"card, score {host.s}")
                    n_over += 1
                    continue
                cig = wx.decode_walk(ops[:, k], int(fi[k]), int(fk[k]))
                if host.s != score[k] or cig != host.cigar:
                    raise AssertionError(f"kernel CIGAR differs from the "
                                         f"host engine at L={lmax}")
                n_ok += 1
            t0 = time.perf_counter()
    n_long = len(pairs) - len(buckets[0]) - len(buckets[1])
    log(f"wfa kernels on {len(pairs)} gap pairs ({len(buckets[0])} in "
        f"bucket {BUCKETS[0]}, {len(buckets[1])} in {BUCKETS[1]}, {n_long} "
        f"over {BUCKETS[1][0]} bp, the pool's host jobs): {n_ok} CIGARs "
        f"equal to the native host engine's, {n_over} over the score "
        f"budget; {t_dev * 1e3:.1f} ms on the card path (encode, kernels, "
        f"copy back; host clock)")
    return res


class HarvestPool:
    """A GWFA pool that records the jobs the native hook harvests (mode
    1) and returns -2 for each, so the inline host engine bridges them
    all (mode 2).  It names the card as its device, as the card's pool
    does, so that the file loop keeps its route in this process (no fork
    pool) even before the first CUDA call."""

    device = torch.device("cuda")

    def __init__(self):
        self.jobs = []

    def run_multi(self, rows, qbufs):
        from minigraph_tpu_torch.align.gwfa_device import WCAP
        for r, qb in zip(rows, qbufs):
            self.jobs.append((qb[r[0]: r[1]].tobytes(),
                              *(int(x) for x in r[2:7])))
        n = len(rows)
        return (np.full(n, -2, dtype=np.int64),
                np.full((n, WCAP), -1, dtype=np.int32),
                np.zeros(n, dtype=np.int64))


def gwfa_kernel_check(gd, jobs, qcap, reps, J=None):
    """The gwfa kernel on J jobs (default one chunk of 16) against the
    plain version on the card, bitwise; events, CUDA-graph and plain
    times, each phase's share of the clock buffer's cycles, the bound
    from the plain run's counted work."""
    from minigraph_tpu_torch.align.gwfa_device import J_BUCKET, WCAP
    from minigraph_tpu_torch.ops import gwfa as gw
    J = J_BUCKET if J is None else J
    args = gw.pack_jobs(jobs[:J], qcap, J, "cuda")
    counts = {}
    t0 = time.perf_counter()
    ref = gw.gwfa_batch_ref(gd, *args, counts=counts)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    keys = ("s", "flags", "walk", "n_walk")
    # bytes: the query and the job fields in, the compared graph bases
    # (int32, as the JAX layout keeps them), the outputs
    nbytes = 4 * (J * qcap + 6 * J + counts["ext"] + J * (3 + WCAP))
    ops = GWFA_OPS_PER_STATE * counts["states"] \
        + GWFA_OPS_PER_COMPARE * counts["ext"]
    b_ms, b_by = bound(nbytes, ops)
    n = min(len(jobs), J)
    flags = ref["flags"].cpu().tolist()[:n]
    log(f"gwfa ({J}, {qcap}): {n} jobs ({sum(f == 0 for f in flags)} "
        f"unflagged, {int((ref['s'][:n] >= 0).sum())} found, flags "
        f"{flags}); plain {plain:.1f} ms, bound {b_ms:.5f} ms ({b_by}: "
        f"{counts['states']} states, {counts['ext']} compares)")
    got = gw.gwfa_batch(gd, *args)
    err = max_abs_err([got[k] for k in keys], [ref[k] for k in keys])
    if err:
        raise AssertionError(f"gwfa kernel differs at qcap {qcap}: {err}")
    ms = cuda_time(lambda: gw.gwfa_batch(gd, *args), reps)
    graph_ms = graph_time(lambda: gw.gwfa_batch(gd, *args), reps)
    clk = torch.zeros((J, gw.CLK_N), dtype=torch.int64, device="cuda")
    timed = gw.gwfa_batch(gd, *args, clock=clk)
    if max_abs_err([timed[k] for k in keys], [ref[k] for k in keys]):
        raise AssertionError("the clock buffer changed the gwfa outputs")
    cyc = clk.to(torch.float64)
    tot = float(cyc[:, :len(gw.CLK_PHASES)].sum())
    if not tot > 0:
        raise AssertionError("the gwfa clock buffer is empty")
    share = {p: round(float(cyc[:, i].sum()) / tot, 4)
             for i, p in enumerate(gw.CLK_PHASES)}
    col = {c: float(cyc[:, i].sum()) for i, c in enumerate(gw.CLK_COLUMNS)}
    log(f"  bitwise equal; kernel {ms:.4f} ms ({graph_ms:.4f} ms replayed "
        f"from a CUDA graph); cycles {int(tot)} over the jobs, shares "
        + ", ".join(f"{p} {v:.3f}" for p, v in share.items())
        + f"; {col['syncs'] / col['waves']:.1f} synchronisations a wave")
    return {"max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
            "cycle_share": share, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by}


def gwfa_map_run(gi, mo, reads_fa, front):
    """Phase 4's reads mapped with a DeviceGwfaPool on the card, with the
    front pinned at share 0 (one pool call a read) or without a front
    (one call a batch).  Returns (GAF, stats, pool, launches)."""
    from minigraph_tpu_torch import kernels
    from minigraph_tpu_torch.align.gwfa_device import DeviceGwfaPool
    from minigraph_tpu_torch.mapping.device_front import DeviceFront
    from minigraph_tpu_torch.mapping.mapper import map_reads
    from minigraph_tpu_torch.mapping.split import ShareSplit
    fr = None
    if front:
        fr = DeviceFront(gi, mo, device="cuda")
        fr._split_state = ShareSplit(share=0.0)
    pool = DeviceGwfaPool(gi, device="cuda")
    pool.graph()
    buf, st = io.StringIO(), {}
    kernels.reset_launches()
    map_reads(gi, mo, [reads_fa], buf, 8, fr, st, gwfa_pool=pool)
    torch.cuda.synchronize()
    return buf.getvalue(), st, pool, dict(kernels.launches)


def gwfa_harvest(gi, mo, reads_fa, host_gaf):
    """Phase 9 (a)'s harvest: the bridge jobs of the reads, recorded
    through the native hook (mode 1) while the inline host engine
    bridges them all; the GAF bytes held to the host-only run.  Returns
    (every job, the jobs of each query bucket, seconds)."""
    from minigraph_tpu_torch.align.gwfa_device import QCAP_BUCKETS
    from minigraph_tpu_torch.mapping.mapper import map_reads
    t0 = time.perf_counter()
    harvest = HarvestPool()
    buf = io.StringIO()
    map_reads(gi, mo, [reads_fa], buf, 8, None, {}, gwfa_pool=harvest)
    if buf.getvalue() != host_gaf:
        raise AssertionError("GAF of the harvest run differs at line "
                             f"{first_diff(buf.getvalue(), host_gaf)}")
    per = [[j for j in harvest.jobs if lo < len(j[0]) <= hi]
           for lo, hi in zip((0,) + QCAP_BUCKETS[:-1], QCAP_BUCKETS)]
    return harvest.jobs, per, time.perf_counter() - t0


def gwfa_chunks(gi, per):
    """One full chunk of 16 jobs a query bucket, (jobs, qcap, number
    harvested): the bucket's harvested jobs, topped up with bridge-shaped
    jobs on the same graph (tools/synth.py, seed 53)."""
    from minigraph_tpu_torch.align.gwfa_device import J_BUCKET, QCAP_BUCKETS
    from minigraph_tpu_torch.tools.synth import bridge_jobs
    rng = np.random.default_rng(53)
    out = []
    for jobs, lo, qcap in zip(per, (0,) + QCAP_BUCKETS[:-1], QCAP_BUCKETS):
        n_h = min(len(jobs), J_BUCKET)
        jobs = jobs[:J_BUCKET]
        while len(jobs) < J_BUCKET:
            jobs += [j for j in bridge_jobs(gi.g, gi.es, rng, 64, 8, qcap)
                     if len(j[0]) > lo][: J_BUCKET - len(jobs)]
        out.append((jobs, qcap, n_h))
    return out


def gwfa_phase(gi, mo, reads_fa, host_gaf, n_reads):
    """Phase 9: (a) the harvest and the kernel checks, (b) the two pool
    routes.  Returns (the kernel's numbers at the 256 bucket's chunk,
    the others beside them; the launches of run (b1))."""
    from minigraph_tpu_torch.align.gwfa_device import (J_BUCKET,
                                                       DeviceGwfaPool,
                                                       QCAP_BUCKETS)
    jobs, per, sec = gwfa_harvest(gi, mo, reads_fa, host_gaf)
    lens = np.array([len(j[0]) for j in jobs])
    log(f"phase 9 (a) harvest (hook mode 1, host engine bridges): GAF "
        f"bytes equal to the host-only run, {len(lens)} bridge jobs in "
        f"{sec:.1f} s: {len(per[0])} of <= 256 bp, "
        f"{len(per[1])} of 257-1024 bp, {int((lens > 1024).sum())} "
        f"longer, {int((lens == 0).sum())} empty (longest "
        f"{int(lens.max()) if len(lens) else 0})")
    res = []
    gd = DeviceGwfaPool(gi, device="cuda").graph()
    for jobs, qcap, n_h in gwfa_chunks(gi, per):
        log(f"gwfa chunk of bucket {qcap}: {n_h} harvested jobs, "
            f"{J_BUCKET - n_h} synthetic")
        res.append(gwfa_kernel_check(gd, jobs, qcap, reps=5))
    # the launch shape of run (b2): every harvested job of the 256 bucket
    # in one batch, padded to a multiple of 16
    if len(per[0]) > J_BUCKET:
        res.append(gwfa_kernel_check(
            gd, per[0], QCAP_BUCKETS[0], reps=3,
            J=J_BUCKET * -(-len(per[0]) // J_BUCKET)))

    launches = None
    for name, front in (("(b1) front pinned, one pool call a read", True),
                        ("(b2) no front, one pool call a batch", False)):
        gaf, st, pool, lc = gwfa_map_run(gi, mo, reads_fa, front)
        if gaf != host_gaf:
            raise AssertionError(f"phase 9 {name}: GAF differs at line "
                                 f"{first_diff(gaf, host_gaf)}")
        if pool.n_device <= 0 or lc["gwfa"] <= 0 \
                or lc["gwfa"] != pool.n_batches:
            raise AssertionError(f"phase 9 {name}: n_device "
                                 f"{pool.n_device}, {pool.n_batches} pool "
                                 f"batches, launches {lc}")
        if front and min(lc["sketch"], lc["chain_exact"],
                         lc["backtrack"]) <= 0:
            raise AssertionError(f"phase 9 {name}: front launches {lc}")
        log(f"phase 9 {name}: GAF bytes equal to the host-only run; "
            f"{pool.n_jobs} jobs, n_device {pool.n_device}, "
            f"{pool.n_flagged} flagged to the host, {pool.n_oversize} "
            f"oversize; {pool.n_batches} pool batches: kernel_ms "
            f"{pool.kernel_ms:.4f} (the launches alone), batch_ms "
            f"{pool.batch_ms:.4f} (the wrapper calls around them; CUDA "
            f"events on the pool's stream), {pool.kernel_ms / max(1, pool.n_batches):.4f} "
            f"and {pool.batch_ms / max(1, pool.n_batches):.4f} ms a batch, "
            f"kernel_ms {100 * pool.kernel_ms / st['map_ms']:.2f}% of "
            f"map_ms; launches {lc}")
        if not 0 < pool.kernel_ms <= pool.batch_ms:
            raise AssertionError(f"phase 9 {name}: kernel_ms "
                                 f"{pool.kernel_ms} outside batch_ms "
                                 f"{pool.batch_ms}")
        if front:
            # the window of each launch's events holds the bare ctypes
            # call alone (kernels.bind); its device time is the chunk's
            g = res[0]["graph_ms"]
            log(f"phase 9 {name}: kernel_ms {pool.kernel_ms:.4f} against "
                f"the 16-job chunk's graph time x launches "
                f"{g * lc['gwfa']:.4f} ms ({g:.4f} x {lc['gwfa']})")
        log(run_line(f"run 9 {name}", st, n_reads))
        if launches is None:
            launches = lc
    return {**res[0], "wider": res[1:]}, launches


def ggen_phase(ref, gfa, work, reads_fa, n_reads):
    """Phase 10: -cxggs -l10k with two samples on the phase 4 graph,
    -xasm --call -l10k of a third on the new graph, then phase 4's reads
    on the new graph, front pinned, against host only."""
    from minigraph_tpu_torch import cli
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.options import IndexOptions, MapOptions
    from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                                 write_fasta)
    samples, n_bp = [], []
    for i, seed in enumerate((60, 62, 64)):
        fa = str(work / f"sample{i}.fa")
        ctg = cut_contigs(make_haplotype(ref, seed=seed), seed=seed + 1)
        write_fasta(fa, ctg)
        samples.append(fa)
        n_bp.append(sum(len(x) for _, x in ctg))
    out_gfa, bed = str(work / "ggs.gfa"), str(work / "call.bed")
    t0 = time.perf_counter()
    rc = cli.main(["-cxggs", "-l10k", "-t8", "-o", out_gfa, gfa,
                   samples[0], samples[1]])
    t_ggs = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc2 = cli.main(["-xasm", "--call", "-l10k", "-t8", "-o", bed, out_gfa,
                    samples[2]])
    t_call = time.perf_counter() - t0
    if rc or rc2:
        raise AssertionError(f"phase 10: -cxggs exit {rc}, --call {rc2}")

    def count(path, tag):
        return sum(1 for ln in open(path) if ln.startswith(tag))
    d_seg = count(out_gfa, "S\t") - count(gfa, "S\t")
    d_arc = count(out_gfa, "L\t") - count(gfa, "L\t")
    n_bed = sum(1 for _ in open(bed))
    if d_seg <= 0 or d_arc <= 0:
        raise AssertionError(f"-cxggs added {d_seg} segments, {d_arc} arcs")
    log(f"phase 10 -cxggs -l10k, two samples of {n_bp[0]} and {n_bp[1]} "
        f"bp in contigs: {t_ggs:.1f} s, "
        f"{d_seg} segments and {d_arc} arcs added; -xasm --call -l10k of a "
        f"third sample: {t_call:.1f} s, {n_bed} BED lines")
    io_, mo = IndexOptions(), MapOptions()
    g2 = read_gfa(out_gfa)
    gi2 = build_index(g2, io_.k, io_.w, mo)
    host2, st_h = host_run(gi2, mo, [reads_fa])
    gaf2, st_d = device_run(gi2, mo, reads_fa)
    if gaf2 != host2:
        raise AssertionError(f"phase 10: GAF on the new graph differs at "
                             f"line {first_diff(gaf2, host2)}")
    log(f"phase 10 phase 4's reads on the new graph, front pinned: GAF "
        f"bytes equal to the host-only run on it ({host2.count(chr(10))} "
        f"lines)")
    log(run_line("run 10 device path, new graph", st_d, n_reads))
    log(run_line("run 10 host only, new graph", st_h, n_reads))
    return samples, out_gfa, t_ggs


def sweep_launches(seqs, w, k):
    """K1 launches of one sketch_segments_device call on `seqs`: one a
    chunk batch of each bucket (index/midx_device.py)."""
    from minigraph_tpu_torch.index.midx_device import DEV_BUCKETS, chunk_jobs
    jobs = chunk_jobs(seqs, w, k, DEV_BUCKETS[-1][0])
    (p0, b0), (_, b1) = DEV_BUCKETS
    small = sum(len(j[2]) <= p0 + w + k + 1 for j in jobs)
    return -(-small // b0) + -(-(len(jobs) - small) // b1), len(jobs)


def seed_device_phase(ref, gfa, work, kernels, ggen_out):
    """Phase 11: --seed-device at full width.  (a) K1 on real chunk
    batches at asm's widths, (b) the device index and the sweep against
    the host, (c) -cxggs with the seed stage on the card, (d) -xasm
    --write-mz --seed-device on one ~5 Mb query.  Returns the K1 numbers
    at (16, 32809) and the launches of run (d)."""
    from minigraph_tpu_torch import cli
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index import midx_device
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.index.sketch import sketch
    from minigraph_tpu_torch.mapping import mapper
    from minigraph_tpu_torch.ops.sketch import encode_batch
    from minigraph_tpu_torch.options import (GGOptions, IndexOptions,
                                             MapOptions, opt_set)
    from minigraph_tpu_torch.seqio.bseq import read_all
    from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                                 write_fasta)
    DB = midx_device.DEV_BUCKETS
    hap7 = make_haplotype(ref, seed=7)

    # (a) K1 at the sweep's widths on its first batch of each bucket for
    # phase 7 (a)'s contigs (the jobs, padding and widths of
    # sketch_segments_device), then the batches of one whole haplotype
    w, k = 10, 19
    halo = w + k + 1
    jobs = midx_device.chunk_jobs([s_ for _, s_ in cut_contigs(hap7, seed=8)],
                                  w, k, DB[-1][0])
    k1 = {}
    for (pay, bsz) in DB:
        texts = [j[2] for j in jobs
                 if (len(j[2]) <= DB[0][0] + halo) == (pay == DB[0][0])]
        texts = texts[:bsz]
        n_real = len(texts)
        codes, lens = encode_batch(texts + [""] * (bsz - n_real),
                                   pad_to=pay + halo + w + 1)
        k1[pay] = check_sketch_codes(codes, lens, w, k,
                                     reps=5 if pay > DB[0][0] else 20)
        log(f"phase 11 (a) sketch (19, 10) at {codes.shape}, a sweep batch "
            f"of {n_real} chunk jobs: {json.dumps(k1[pay])}")
    n_b, n_j = sweep_launches([hap7], w, k)
    log(f"phase 11 (a) one {len(hap7)} bp contig: {n_j} chunk jobs, "
        f"{n_b} K1 batches of the sweep")

    # (b) the device index at lr's and asm's settings against the host
    # build; the sweep against the host sketch on every segment plus a
    # tandem sequence whose planes overflow
    for preset in ("lr", "asm"):
        io_, mo_h, mo_d = IndexOptions(), MapOptions(), MapOptions()
        opt_set(preset, io_, mo_h, GGOptions())
        opt_set(preset, io_, mo_d, GGOptions())
        g = read_gfa(gfa)
        t0 = time.perf_counter()
        gi_h = build_index(g, io_.k, io_.w, mo_h)
        t_h = time.perf_counter() - t0
        segs = [s.seq for s in g.seg if s.seq and s.len > 0]
        g = read_gfa(gfa)
        kernels.reset_launches()
        t0 = time.perf_counter()
        gi_d = midx_device.build_index_device(g, io_.k, io_.w, mo_d,
                                              device="cuda")
        torch.cuda.synchronize()
        t_d = time.perf_counter() - t0
        lc = kernels.launches["sketch"]
        for f in ("keys", "key_start", "key_cnt", "pos"):
            if not np.array_equal(getattr(gi_h, f), getattr(gi_d, f)):
                raise AssertionError(f"phase 11 (b) {preset}: device index "
                                     f"{f} differs")
        if (mo_h.occ_max1, mo_h.lc_max_occ) != (mo_d.occ_max1,
                                                mo_d.lc_max_occ):
            raise AssertionError(f"phase 11 (b) {preset}: occurrence "
                                 f"thresholds differ")
        want_lc, n_jobs = sweep_launches(segs, io_.w, io_.k)
        if lc != want_lc:
            raise AssertionError(f"phase 11 (b) {preset}: {lc} K1 launches,"
                                 f" {want_lc} chunk batches")
        log(f"phase 11 (b) build_index_device, {preset} (k={io_.k}, "
            f"w={io_.w}): tables equal to build_index's ({len(gi_d.keys)} "
            f"keys, {len(gi_d.pos)} positions); {len(segs)} segments, "
            f"{n_jobs} chunk jobs, {lc} K1 launches; {t_d:.2f} s against "
            f"{t_h:.2f} s for build_index (the native sketch_many)")
        fell = []
        real_host = midx_device.host_sketch
        midx_device.host_sketch = lambda s_, w_, k_, rid: \
            fell.append(len(s_)) or real_host(s_, w_, k_, rid)
        try:
            tandem = "ACGT" * 1500
            got = midx_device.sketch_segments_device(
                segs + [tandem], io_.w, io_.k, device="cuda")
        finally:
            midx_device.host_sketch = real_host
        for i, (s_, (x, y)) in enumerate(zip(segs + [tandem], got)):
            hx, hy = sketch(s_, io_.w, io_.k, rid=0)
            if not (np.array_equal(x, hx) and np.array_equal(y, hy)):
                raise AssertionError(f"phase 11 (b) {preset}: sweep "
                                     f"differs from the host on seq {i}")
        if fell != [len(tandem)]:
            raise AssertionError(f"phase 11 (b) {preset}: host fallback "
                                 f"for lengths {fell}")
        log(f"phase 11 (b) sketch_segments_device, {preset}: every segment "
            f"equal to the host sketch; the tandem sequence overflowed and "
            f"went whole to the host sketch")

    # (c) graph generation with the seed stage on the card: phase 10's
    # run with --seed-device, the same rGFA bytes; each contig of 16384
    # bp or more maps once (map_one) and sweeps once
    samples, ggs_gfa, t_ggs = ggen_out
    out_c = str(work / "ggs_seed_device.gfa")
    n_long, want_lc = 0, 0
    for fa in samples[:2]:
        for r in read_all(fa):
            if len(r.seq) >= mapper.SEED_DEVICE["min_len"]:
                n_long += 1
                want_lc += sweep_launches([r.seq.upper()], 10, 19)[0]
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["-cxggs", "-l10k", "-t8", "--seed-device", "-o",
                       out_c, gfa, samples[0], samples[1]])
    finally:
        mapper.SEED_DEVICE["on"] = False
    t_c = time.perf_counter() - t0
    lc = kernels.launches["sketch"]
    if rc or open(out_c).read() != open(ggs_gfa).read():
        raise AssertionError(f"phase 11 (c): exit {rc}, rGFA differs from "
                             f"phase 10's")
    if lc != want_lc:
        raise AssertionError(f"phase 11 (c): {lc} K1 launches for "
                             f"{want_lc} chunk batches")
    log(f"phase 11 (c) -cxggs -l10k --seed-device (graph generation: "
        f"map_one, the per-read path): rGFA bytes equal to phase 10's; "
        f"{t_c:.1f} s against {t_ggs:.1f} s; {n_long} contigs of 16384 bp "
        f"or more on the device route, {lc} K1 launches")

    # (d) one whole haplotype as one query, -xasm --write-mz: its output
    # shape takes the Python reader loop, the query the device route
    q_fa = str(work / "hap7.fa")
    write_fasta(q_fa, [("hap7", hap7)])
    outs, times = [], []
    for extra in (["--device", "none"], ["--seed-device"]):
        path = str(work / f"hap7{len(outs)}.gaf")
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            rc = cli.main(["-xasm", "--write-mz", "-t8", "-o", path]
                          + extra + [gfa, q_fa])
        finally:
            mapper.SEED_DEVICE["on"] = False
        times.append(time.perf_counter() - t0)
        lc_d = dict(kernels.launches)
        if rc:
            raise AssertionError(f"phase 11 (d): exit {rc}")
        outs.append(open(path).read())
    if outs[0] != outs[1]:
        raise AssertionError(f"phase 11 (d): GAF differs at line "
                             f"{first_diff(outs[1], outs[0])}")
    want_lc = sweep_launches([hap7], 10, 19)[0]
    if lc_d["sketch"] != want_lc:
        raise AssertionError(f"phase 11 (d): {lc_d} launches for "
                             f"{want_lc} chunk batches")
    n_mz = sum(ln.startswith("*\t") for ln in outs[0].splitlines())
    log(f"phase 11 (d) -xasm --write-mz --seed-device on one {len(hap7)} "
        f"bp query (the Python reader loop, the device route): GAF bytes "
        f"equal to --device none without --seed-device "
        f"({outs[0].count(chr(10))} lines, {n_mz} chain lines); "
        f"{times[1]:.1f} s against {times[0]:.1f} s; launches {lc_d}")
    return k1[DB[-1][0]], lc_d


# phase 12's shapes: (a) phase 5's batch, (b) caps at which a key shard
# of two binds acap_shard = max(acap // 2, 256)
V1_CAPS = dict(mcap=512, acap=2048, window=64)
SHARD_CAPS = dict(mcap=512, acap=512, qcap=512)
SHARD_STEPS = ("v1", "v2", "v2_idx", "hash_idx", "v1_idx")


def v1_phase(gi, reads, kernels):
    """Phase 12 (a): the v1 map step (ops/pipeline.py make_map_step) at
    phase 5's shape, on the card against the same step on CPU tensors;
    K4 at W = 64 on its anchors against its plain version."""
    from minigraph_tpu_torch.ops import u32, u64
    from minigraph_tpu_torch.ops.pipeline import (DeviceIndex,
                                                  collect_anchors_device,
                                                  make_map_step)
    from minigraph_tpu_torch.ops.sketch import encode_batch
    from minigraph_tpu_torch.ops.sketch_v2 import sketch_device_v2
    c = V1_CAPS
    codes_h, lens_h = encode_batch(reads, pad_to=STEP_PAD)
    codes, lens = torch.from_numpy(codes_h).cuda(), \
        torch.from_numpy(lens_h).cuda()
    dix = DeviceIndex.from_host(gi, "cuda")
    step = make_map_step(dix, c["mcap"], c["acap"], window=c["window"])
    step(codes, lens)                    # first call: allocations
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = step(codes, lens)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    if launches["chain_ring"] != 1:
        raise AssertionError(f"phase 12 (a): launches {launches}")
    rate = step_rate(step, codes, lens)
    t0 = time.perf_counter()
    ref = make_map_step(DeviceIndex.from_host(gi, "cpu"), c["mcap"],
                        c["acap"], window=c["window"])(codes_h, lens_h)
    plain_s = time.perf_counter() - t0
    for key, v in ref.items():
        if not torch.equal(v, out[key].cpu()):
            raise AssertionError(f"phase 12 (a): {key} card != CPU")
    n_a = out["n_anchors"].double()
    log(f"phase 12 (a) v1 step (B={len(reads)}, pad {STEP_PAD}, mcap "
        f"{c['mcap']}, acap {c['acap']}, W={c['window']}): card == CPU "
        f"bitwise on f, p, best, best_anchor, n_anchors; n_a mean "
        f"{n_a.mean():.1f} max {int(n_a.max())}; {rate:.1f} reads/s on "
        f"the card (host clock, synchronised, mean of 3), the plain step "
        f"on the CPU {plain_s:.2f} s; launches {launches}")
    mx, my, n_mv = sketch_device_v2(codes, lens, gi.w, gi.k, c["mcap"])
    ax, ay, n_a = collect_anchors_device(
        dix.keys, dix.key_start, dix.key_cnt, dix.pos, dix.seg_len, mx, my,
        n_mv, 50, 16, c["acap"])
    planes = (u64.srl(ax, 32), ax & u32.U32MAX, u64.srl(ay, 32),
              ay & u32.U32MAX, n_a)
    k4 = check_ring_chain(planes, reps=20, W=c["window"])
    return launches, k4


def shard_inputs(ref, reads, work):
    """Phase 12 (b)'s batch: 384 of phase 4's short reads and 128 exact
    slices of the reference, some of whose hits in one of two key shards
    pass acap_shard (the CPU test's cap-binding shape)."""
    from minigraph_tpu_torch.ops.sketch import encode_batch
    rng = np.random.default_rng(120)
    pos = rng.integers(0, len(ref) - 1900, 128)
    codes, lens = encode_batch(list(reads[:384])
                               + [ref[p:p + 1900] for p in pos],
                               pad_to=STEP_PAD)
    np.savez(work / "shard_batch.npz", codes=codes, lens=lens)
    return codes, lens


def shard_tables(gi, device):
    from minigraph_tpu_torch.ops.anchors import JoinIndex
    from minigraph_tpu_torch.ops.pipeline import DeviceIndex
    return (DeviceIndex.from_host(gi, device),
            JoinIndex.from_host(gi, 16, device))


def sharded_steps(mesh, gi, dix, ji, device, names=SHARD_STEPS):
    from minigraph_tpu_torch.parallel import shard
    c = SHARD_CAPS
    make = {
        "v1": lambda: shard.make_sharded_map_step(mesh, dix, c["mcap"],
                                                  c["acap"]),
        "v2": lambda: shard.make_sharded_map_step_v2(
            mesh, ji, gi.w, gi.k, acap=c["acap"], qcap=c["qcap"],
            window=16),
        "v2_idx": lambda: shard.make_index_sharded_map_step_v2(
            mesh, ji, gi.w, gi.k, acap=c["acap"], qcap=c["qcap"]),
        "hash_idx": lambda: shard.make_hash_sharded_map_step(
            mesh, gi, acap=c["acap"], qcap=c["qcap"], device=device),
        "v1_idx": lambda: shard.make_index_sharded_map_step(
            mesh, dix, c["mcap"], c["acap"])}
    return {n: make[n]() for n in names}


def run_steps(steps, codes, lens):
    """{step/key: numpy array} of each step's global outputs."""
    out = {}
    for name, step in steps.items():
        res = step(codes, lens)
        if not isinstance(res, dict):
            res = {"best": res[0], "n_anchors": res[1]}
        for key, v in res.items():
            out[f"{name}/{key}"] = v.cpu().numpy()
    return out


def flat_records(res):
    return np.concatenate([np.array([len(x)], np.uint64) for x, _ in res]
                          + [a for xy in res for a in xy])


def shard_worker(rank, port, work):
    """Phase 12 (b) on one of two gloo ranks that share cuda:0: the five
    steps on (data 2, idx 1) and (data 1, idx 2) meshes, the idx steps
    of the second also with CPU tables (the plain versions), and the
    sweep (index/midx_device.py) with a data-2 mesh."""
    import torch.distributed as dist

    from minigraph_tpu_torch import kernels
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.index.midx_device import sketch_segments_device
    from minigraph_tpu_torch.options import IndexOptions, MapOptions
    from minigraph_tpu_torch.parallel.shard import make_mesh
    work = Path(work)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        t0 = time.perf_counter()
        io_, mo = IndexOptions(), MapOptions()
        g = read_gfa(str(work / "mhc5m.gfa"))
        gi = build_index(g, io_.k, io_.w, mo)
        z = np.load(work / "shard_batch.npz")
        codes, lens = z["codes"], z["lens"]
        dix, ji = shard_tables(gi, "cuda")
        dix_h, ji_h = shard_tables(gi, "cpu")
        out = {}
        for d, i in ((2, 1), (1, 2)):
            mesh = make_mesh(2, idx_shards=i, device="cuda")
            res = run_steps(sharded_steps(mesh, gi, dix, ji, "cuda"),
                            codes, lens)
            out.update({f"{d}x{i}/{k}": v for k, v in res.items()})
            if i == 2:
                res = run_steps(sharded_steps(
                    mesh, gi, dix_h, ji_h, "cpu",
                    ("v2_idx", "hash_idx", "v1_idx")), codes, lens)
                out.update({f"cpu/{k}": v for k, v in res.items()})
            else:
                kernels.reset_launches()
                recs = sketch_segments_device(
                    [s.seq for s in g.seg if s.seq], gi.w, gi.k,
                    device="cuda", mesh=mesh)
                torch.cuda.synchronize()
                out["sweep"] = flat_records(recs)
                out["sweep_launches"] = np.array(kernels.launches["sketch"])
        out["seconds"] = np.array(time.perf_counter() - t0)
        np.savez(work / f"shard_r{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_phase(ref, gi, hash_tables, reads, work, kernels):
    """Phase 12 (b): the sharded steps (parallel/shard.py) on the card:
    world size 1 with NCCL on a 1x1 mesh against the unsharded steps,
    then two gloo processes on cuda:0."""
    import torch.distributed as dist
    import torch.multiprocessing as tmp

    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx_device import sketch_segments_device
    from minigraph_tpu_torch.ops import u64
    from minigraph_tpu_torch.ops.pipeline import (collect_anchors_device,
                                                  make_map_step,
                                                  make_map_step_v2)
    from minigraph_tpu_torch.ops.sketch_v2 import sketch_device_v2
    from minigraph_tpu_torch.parallel.shard import (make_mesh,
                                                    shard_index_by_key)
    c = SHARD_CAPS
    codes_h, lens_h = shard_inputs(ref, reads, work)
    codes, lens = torch.from_numpy(codes_h), torch.from_numpy(lens_h)
    dix, ji = shard_tables(gi, "cuda")
    t0 = time.perf_counter()
    # the unsharded steps
    hash16 = dataclasses.replace(hash_tables, occ_cap=16)
    v2 = make_map_step_v2(ji, gi.w, gi.k, acap=c["acap"], qcap=c["qcap"],
                          window=16)(codes, lens)
    want = {f"v1/{k}": v for k, v in make_map_step(
        dix, c["mcap"], c["acap"])(codes, lens).items()}
    want.update({f"v2/{k}": v for k, v in v2.items()})
    want.update({"v2_idx/best": v2["best"],
                 "v2_idx/n_anchors": v2["n_anchors"]})
    hs = make_map_step_v2(hash16, gi.w, gi.k, acap=c["acap"],
                          qcap=c["qcap"], window=16)(codes, lens)
    want.update({"hash_idx/best": hs["best"],
                 "hash_idx/n_anchors": hs["n_anchors"]})
    v1w = make_map_step(dix, c["mcap"], c["acap"], window=32)(codes, lens)
    want.update({"v1_idx/best": v1w["best"],
                 "v1_idx/n_anchors": v1w["n_anchors"]})
    want = {k: v.cpu().numpy() for k, v in want.items()}
    # world size 1, NCCL, 1x1 mesh
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        kernels.reset_launches()
        one = run_steps(sharded_steps(make_mesh(1, device="cuda"), gi, dix,
                                      ji, "cuda"), codes, lens)
        torch.cuda.synchronize()
        lc1 = dict(kernels.launches)
    finally:
        dist.destroy_process_group()
    if set(one) != set(want):
        raise AssertionError(f"phase 12 (b): outputs {sorted(one)}")
    for key, v in want.items():
        if not np.array_equal(v, one[key]):
            raise AssertionError(f"phase 12 (b) NCCL 1x1: {key} differs "
                                 f"from the unsharded step")
    t1 = time.perf_counter()
    log(f"phase 12 (b) world size 1, NCCL, 1x1 mesh: the five sharded "
        f"steps equal their unsharded steps ({len(want)} arrays, "
        f"{t1 - t0:.1f} s with the unsharded runs); launches {lc1}")
    # which reads pass acap_shard in a shard of two (v1's collect)
    sh = shard_index_by_key(u64.to_numpy(dix.keys),
                            dix.key_start.cpu().numpy(),
                            dix.key_cnt.cpu().numpy(),
                            u64.to_numpy(dix.pos), 2)
    mx, my, n_mv = sketch_device_v2(codes.cuda(), lens.cuda(), gi.w, gi.k,
                                    c["mcap"])
    n_tot = [collect_anchors_device(
        u64.from_numpy(sh[0][s], "cuda"),
        torch.from_numpy(sh[1][s]).cuda(), torch.from_numpy(sh[2][s]).cuda(),
        u64.from_numpy(sh[3][s], "cuda"), dix.seg_len, mx, my, n_mv, 50, 16,
        1 << 14)[2].cpu().numpy() for s in range(2)]
    binds = np.maximum(*n_tot) > max(c["acap"] // 2, 256)
    if not binds.any():
        raise AssertionError("phase 12 (b): no read binds acap_shard")
    # world size 2, gloo, both ranks on cuda:0
    seqs = [s.seq for s in read_gfa(str(work / "mhc5m.gfa")).seg if s.seq]
    single = flat_records(sketch_segments_device(seqs, gi.w, gi.k,
                                                 device="cuda"))
    n_batches = sweep_launches(seqs, gi.w, gi.k)[0]
    t2 = time.perf_counter()
    tmp.start_processes(shard_worker, args=(free_port(), str(work)),
                        nprocs=2, join=True, start_method="spawn")
    t3 = time.perf_counter()
    ranks = [dict(np.load(work / f"shard_r{r}.npz")) for r in range(2)]
    for r, res in enumerate(ranks):
        for name in SHARD_STEPS:
            for key in (k for k in want if k.startswith(name + "/")):
                got21, got12 = res[f"2x1/{key}"], res[f"1x2/{key}"]
                if not np.array_equal(got21, one[key]):
                    raise AssertionError(f"phase 12 (b) rank {r} 2x1: "
                                         f"{key} differs")
                if name.endswith("_idx"):
                    if not np.array_equal(got12, res[f"cpu/{key}"]):
                        raise AssertionError(f"phase 12 (b) rank {r} 1x2: "
                                             f"{key} card != CPU")
                    same = got12[~binds] == one[key][~binds]
                else:
                    same = got12 == one[key]
                if not np.all(same):
                    raise AssertionError(f"phase 12 (b) rank {r} 1x2: "
                                         f"{key} differs")
        if not np.array_equal(res["sweep"], single):
            raise AssertionError(f"phase 12 (b) rank {r}: the data-2 sweep "
                                 f"differs from mesh=None")
        if int(res["sweep_launches"]) != n_batches:
            raise AssertionError(f"phase 12 (b) rank {r}: "
                                 f"{res['sweep_launches']} K1 launches for "
                                 f"{n_batches} sweep batches")
    n_diff = int(sum((ranks[0][f"1x2/{n}/n_anchors"]
                      != one[f"{n}/n_anchors"]).sum()
                     for n in ("v2_idx", "hash_idx", "v1_idx")))
    log(f"phase 12 (b) world size 2, gloo, two processes on cuda:0 "
        f"({t3 - t2:.1f} s, rank 0 {float(ranks[0]['seconds']):.1f} s of "
        f"it): the (data 2, idx 1) mesh equals the world-size-1 results, "
        f"the (data 1, idx 2) mesh too except where a key shard binds "
        f"acap_shard ({int(binds.sum())} of {len(binds)} reads; {n_diff} "
        f"idx-step counts differ there), and its idx steps equal the same "
        f"steps on CPU tables; the sweep with a data-2 mesh gives the "
        f"records of mesh=None on all {len(seqs)} segments, "
        f"{n_batches} chunk batches, K1 launched {n_batches} times on each "
        f"rank on half the rows")


def dist_phase(gfa, reads_fa, host_gaf, work):
    """Phase 12 (c): parallel/dist.py with two processes on the card, the
    GAF and the --cov runs at once, against the single-process bytes."""
    from minigraph_tpu_torch import cli

    def start(extra):
        port = free_port()
        return [subprocess.Popen(
            [sys.executable, "-m", "minigraph_tpu_torch.parallel.dist",
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(r), "--device", "cuda"] + extra
            + [gfa, reads_fa], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]

    t0 = time.perf_counter()
    runs = {"gaf": start([]), "cov": start(["--cov"])}
    res = {}
    try:
        for name, procs in runs.items():
            res[name] = [p.communicate(timeout=600) for p in procs]
            for r, p in enumerate(procs):
                if p.returncode:
                    raise AssertionError(f"phase 12 (c) {name} rank {r}: "
                                         f"exit {p.returncode}\n"
                                         f"{res[name][r][1][-3000:]}")
    finally:
        for procs in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
    wall = time.perf_counter() - t0
    buf = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", "none", "--cov", gfa, reads_fa])
    if rc:
        raise AssertionError(f"phase 12 (c): single-process --cov exit {rc}")
    for name, want in (("gaf", host_gaf), ("cov", buf.getvalue())):
        (out0, _), (out1, _) = res[name]
        if out0 != want:
            raise AssertionError(f"phase 12 (c) {name}: rank 0 differs at "
                                 f"line {first_diff(out0, want)}")
        if out1:
            raise AssertionError(f"phase 12 (c) {name}: rank 1 wrote "
                                 f"{len(out1)} bytes")
    lines = [ln.split("] ", 1)[-1] for name in res for _, err in res[name]
             for ln in err.splitlines()
             if "map_files_distributed" in ln]
    log(f"phase 12 (c) parallel.dist, 2 processes on one card, --device "
        f"cuda, the GAF and the --cov runs at once ({wall:.1f} s wall): "
        f"rank 0's GAF equals phase 4's host-only bytes "
        f"({host_gaf.count(chr(10))} lines) and its --cov graph the "
        f"single-process bytes ({len(buf.getvalue())} bytes); rank 1 wrote "
        f"nothing")
    for ln in lines:
        log(f"phase 12 (c)   {ln}")


def fork_phase(gfa, samples, ggen_out, t_ggs):
    """Phase 12 (d): phase 10's -cxggs -l10k at -t 8 in a process with no
    CUDA context (it forks), then in this one (it does not)."""
    import contextlib

    from minigraph_tpu_torch import cli
    want = open(ggen_out).read()
    out = str(Path(ggen_out).with_suffix(".fork.gfa"))
    argv = ["-cxggs", "-l10k", "-t8", "-o", out, gfa, samples[0], samples[1]]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "minigraph_tpu_torch"] + argv,
                       capture_output=True, text=True, timeout=600)
    t_fork = time.perf_counter() - t0
    if r.returncode or open(out).read() != want:
        raise AssertionError(f"phase 12 (d): forked run exit {r.returncode}"
                             f", rGFA equal: {open(out).read() == want}\n"
                             f"{r.stderr[-2000:]}")
    if "no fork pool" in r.stderr:
        raise AssertionError("phase 12 (d): the fresh process did not fork")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    t_here = time.perf_counter() - t0
    lines = [ln for ln in err.getvalue().splitlines() if "no fork pool" in ln]
    if rc or open(out).read() != want or not lines:
        raise AssertionError(f"phase 12 (d): in-process exit {rc}, "
                             f"{len(lines)} log lines")
    log(f"phase 12 (d) -cxggs -l10k -t8: forked (a fresh process, 8 "
        f"workers) {t_fork:.1f} s with the interpreter's start, rGFA bytes "
        f"equal to phase 10's ({t_ggs:.1f} s in this process); in this "
        f"process, which holds a CUDA context, {t_here:.1f} s, the same "
        f"bytes; log: {lines[0].split('] ', 1)[-1]}")


def devprof_phase(gfa, reads_fa):
    """Phase 12 (e): tools/devprof.py on phase 4's graph and reads."""
    from minigraph_tpu_torch.tools import devprof
    args = ["--bucket", "2048x256", "--n", "256", "--gfa", gfa, "--reads",
            reads_fa]
    r = devprof.profile(devprof.parse_args(args))
    log(f"phase 12 (e) devprof {' '.join(args)}:")
    for ln in devprof.report(r).splitlines():
        log("  " + ln)
    return r


ROOT = Path(__file__).resolve().parent


def mgutils_run(args, out_path, stdin=None):
    """python -m minigraph_tpu_torch.tools.mgutils <args> > out_path;
    returns (seconds, stderr).  Fails unless it exits 0."""
    t0 = time.perf_counter()
    with open(out_path, "w") as out, \
            open(stdin or os.devnull) as inp:
        r = subprocess.run(
            [sys.executable, "-m", "minigraph_tpu_torch.tools.mgutils"]
            + args, stdin=inp, stdout=out, stderr=subprocess.PIPE,
            text=True, cwd=ROOT, timeout=300)
    dt = time.perf_counter() - t0
    if r.returncode:
        raise AssertionError(f"phase 13: mgutils {args[0]} exit "
                             f"{r.returncode}\n{r.stderr[-2000:]}")
    return dt, r.stderr


def body_lines(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("#")]


def cookbook_phase(work, ggen_out, kernels):
    """Phase 13 (a): the cookbook chain on phase 10's graph: -cxasm --call
    -l10k of its three samples (the host route, then --seed-device),
    paste, mgutils merge -s, merge2vcf -r 0, addsample, segfreq, getlcr
    and bed2sql."""
    from minigraph_tpu_torch import cli
    from minigraph_tpu_torch.mapping import mapper
    from minigraph_tpu_torch.seqio.bseq import read_all
    samples, ggs_gfa, _ = ggen_out
    names = [f"sample{i}" for i in range(len(samples))]
    beds, t_call = [], []
    for fa in samples:
        bed = str(work / f"cb_{Path(fa).stem}.bed")
        t0 = time.perf_counter()
        rc = cli.main(["-cxasm", "--call", "-l10k", "-t8", "-o", bed,
                       ggs_gfa, fa])
        t_call.append(time.perf_counter() - t0)
        if rc:
            raise AssertionError(f"phase 13 (a): --call {fa} exit {rc}")
        beds.append(open(bed).read())
    # the same calls with the seed stage on the card: K1 sweeps every
    # contig of 16384 bp or more once (map_one, the per-read path)
    want_lc = sum(sweep_launches([r.seq.upper()], 10, 19)[0]
                  for fa in samples for r in read_all(fa)
                  if len(r.seq) >= mapper.SEED_DEVICE["min_len"])
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        for fa, want in zip(samples, beds):
            bed = str(work / f"cb_{Path(fa).stem}_sd.bed")
            rc = cli.main(["-cxasm", "--call", "-l10k", "-t8",
                           "--seed-device", "-o", bed, ggs_gfa, fa])
            if rc or open(bed).read() != want:
                raise AssertionError(f"phase 13 (a): --call --seed-device "
                                     f"{fa}: exit {rc}, BED equal to the "
                                     f"host run: {open(bed).read() == want}")
    finally:
        mapper.SEED_DEVICE["on"] = False
    t_sd = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if launches["sketch"] <= 0 or launches["sketch"] != want_lc:
        raise AssertionError(f"phase 13 (a): {launches['sketch']} K1 "
                             f"launches for {want_lc} chunk batches")
    rows = [b.splitlines() for b in beds]
    n_bub = len(rows[0])
    if n_bub == 0 or any(len(r) != n_bub for r in rows):
        raise AssertionError(f"phase 13 (a): BED rows "
                             f"{[len(r) for r in rows]}")
    t_each = " / ".join(f"{t:.1f}" for t in t_call)
    log(f"phase 13 (a) -cxasm --call -l10k of the three samples on phase "
        f"10's graph: {n_bub} bubbles, {t_each} s; with --seed-device "
        f"{t_sd:.1f} s for the three, BEDs equal, "
        f"{launches['sketch']} K1 launches (launches {launches})")

    pasted, smp = str(work / "cb_pasted.bed"), str(work / "cb_samples.txt")
    with open(pasted, "w") as f:
        f.write("\n".join("\t".join(p) for p in zip(*rows)) + "\n")
    with open(smp, "w") as f:
        f.write("\n".join(names) + "\n")
    # gfatools gfa2bed of the graph (segfreq): SN, SO, SO + LN, name, SR
    g2b = str(work / "cb_gfa2bed.bed")
    with open(ggs_gfa) as f, open(g2b, "w") as out:
        for ln in f:
            if ln.startswith("S\t"):
                t = ln.rstrip("\n").split("\t")
                tag = dict(x.split(":", 2)[::2] for x in t[3:])
                so = int(tag["SO"])
                out.write(f"{tag['SN']}\t{so}\t{so + int(tag['LN'])}\t{t[1]}"
                          f"\t{tag['SR']}\n")
    merged, vcf = str(work / "cb_merged.bed"), str(work / "cb.vcf")
    secs = {}
    secs["merge"], _ = mgutils_run(["merge", "-s", smp, "-"], merged,
                                   stdin=pasted)
    secs["merge2vcf"], _ = mgutils_run(["merge2vcf", "-r", "0", merged], vcf)
    added = str(work / "cb_added.bed")
    secs["addsample"], _ = mgutils_run(["addsample", merged, smp], added)
    freq = str(work / "cb_segfreq.txt")
    secs["segfreq"], freq_err = mgutils_run(["segfreq", g2b, merged], freq)
    lcr = str(work / "cb_lcr.bed")
    secs["getlcr"], _ = mgutils_run(["getlcr", "-r", "1", "-a", "1", merged],
                                    lcr)
    sql = str(work / "cb.sql")
    secs["bed2sql"], _ = mgutils_run(["bed2sql", smp, pasted], sql)

    head = [ln for ln in open(vcf) if ln.startswith("#CHROM")]
    n_seg = sum(1 for ln in open(ggs_gfa) if ln.startswith("S\t"))
    n_call = sum(ln.startswith("INSERT INTO call ") for ln in open(sql))
    n_called = sum(c != "." for r in zip(*rows) for c in
                   (x.split("\t")[5] for x in r))
    checks = {"merged rows": (len(body_lines(merged)), n_bub),
              "VCF body lines": (len(body_lines(vcf)), n_bub),
              "addsample rows": (len(body_lines(added)), n_bub),
              "segfreq rows": (len(body_lines(freq)), n_seg),
              "bed2sql calls": (n_call, n_called),
              "#CHROM samples": (head[0].rstrip("\n").split("\t")[9:]
                                 if head else None, names)}
    for what, (got, want) in checks.items():
        if got != want:
            raise AssertionError(f"phase 13 (a): {what} {got}, want {want}")
    log(f"phase 13 (a) paste -> mgutils merge -s -> merge2vcf -r 0 "
        f"({n_bub} VCF records, samples {names}), addsample, segfreq "
        f"({n_seg} segments, {freq_err.count(chr(10))} repeat-class lines on "
        f"stderr), getlcr ({len(body_lines(lcr))} regions), bed2sql "
        f"({n_call} calls); seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))


def gaf_tools_phase(gfa, reads_fa, host_gaf, work):
    """Phase 13 (b): stableGaf and subgaf on a --vc GAF of phase 4's
    reads, held to phase 4's stable-coordinate GAF."""
    from minigraph_tpu_torch import cli
    vc = str(work / "tools_vc.gaf")
    t0 = time.perf_counter()
    rc = cli.main(["--vc", "-t8", "--device", "none", "-o", vc, gfa,
                   reads_fa])
    t_vc = time.perf_counter() - t0
    if rc:
        raise AssertionError(f"phase 13 (b): --vc exit {rc}")
    stable = str(work / "tools_stable.gaf")
    t_st, _ = mgutils_run(["stableGaf", gfa, vc], stable)
    mapped = [ln.split("\t") for ln in open(vc).read().splitlines()
              if ln.split("\t")[5] != "*"]
    got = [ln.split("\t") for ln in open(stable).read().splitlines()]
    walk = re.compile(r"^([><][^\s:><]+:\d+-\d+)+$")
    contigs = {ln.split("\tSN:Z:")[1].split("\t")[0] for ln in open(gfa)
               if ln.startswith("S\t")}
    if len(got) != len(mapped) or [t[0] for t in got] != \
            [t[0] for t in mapped]:
        raise AssertionError(f"phase 13 (b): stableGaf wrote {len(got)} "
                             f"records for {len(mapped)} mapped")
    bad = [t[5] for t in got if t[5] not in contigs and not walk.match(t[5])]
    if bad:
        raise AssertionError(f"phase 13 (b): paths not in stable "
                             f"coordinates: {bad[:3]}")
    # columns 1-9 equal phase 4's stable GAF, but for a reverse-strand
    # record on one contig, which the tool puts one base to the left
    # (`path_len - 1 - qe`, as the JAX tool does)
    want = [ln.split("\t")[:9] for ln in host_gaf.splitlines()
            if ln.split("\t")[5] != "*"]
    n_rev = 0
    for g, w in zip(got, want):
        g = g[:9]
        if w[4] == "-" and w[5] in contigs:
            n_rev += 1
            g = g[:7] + [str(int(g[7]) + 1), str(int(g[8]) + 1)]
        if g != w:
            raise AssertionError(f"phase 13 (b): stableGaf {g} against "
                                 f"the stable GAF's {w}")
    # subgaf: the reference contig whole, then a window of it
    ref_len = max(int(t[6]) for t in got if t[5] == "chr1")
    touching = sum(t[5] == "chr1" or bool(re.search(r"[><]chr1:", t[5]))
                   for t in got)
    sub = str(work / "tools_sub.gaf")
    t_sub, _ = mgutils_run(["subgaf", stable, f"chr1:0-{ref_len}"], sub)
    n_sub = sum(1 for _ in open(sub))
    win, reg = str(work / "tools_win.gaf"), \
        f"chr1:{ref_len // 5}-{2 * ref_len // 5}"
    t_win, _ = mgutils_run(["subgaf", stable, reg], win)
    n_win = sum(1 for _ in open(win))
    if n_sub != touching or not 0 < n_win < n_sub:
        raise AssertionError(f"phase 13 (b): subgaf {n_sub} records of "
                             f"{touching} on chr1, {n_win} in the window")
    log(f"phase 13 (b) --vc GAF of phase 4's reads ({t_vc:.1f} s, "
        f"{len(mapped)} mapped records) -> stableGaf ({t_st:.2f} s): every "
        f"record back in stable coordinates, columns 1-9 equal phase 4's "
        f"stable GAF ({n_rev} reverse-strand records one base to the "
        f"left); subgaf chr1 whole {n_sub} records ({t_sub:.2f} s), "
        f"{reg} {n_win} ({t_win:.2f} s)")


def profmap_phase(gfa, reads_fa, smi):
    """Phase 13 (c): tools/profmap.py in a child process (the native
    library reads MGT_PROF once) on phase 4's graph and reads, -x lr and
    -c: the native stages' us/read and counters on this machine."""
    env = {k: v for k, v in os.environ.items() if k != "MGT_PROF"}
    for opts in (["-x", "lr"], ["-c"]):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "minigraph_tpu_torch.tools.profmap", gfa,
             reads_fa] + opts, capture_output=True, text=True, cwd=ROOT,
            env=env, timeout=600)
        dt = time.perf_counter() - t0
        if r.returncode:
            raise AssertionError(f"phase 13 (c) profmap {opts}: exit "
                                 f"{r.returncode}\n{r.stderr[-2000:]}")
        lines = r.stdout.splitlines()
        if len(lines) != 5 or not lines[0].startswith("== "):
            raise AssertionError(f"phase 13 (c) profmap {opts}: {lines}")
        val = {ln.split()[0]: {m.group(1).strip(): float(m.group(2))
                               for m in re.finditer(
                                   r"([a-z_ -]+?) (-?\d+(?:\.\d+)?)",
                                   ln.split(":", 1)[1])}
               for ln in lines[1:]}
        b, t, gc, gw = (val[k] for k in ("batch", "tail", "gchain", "gwfa"))
        # the counters of every stage that ran, and the wall times of
        # the stages every read passes (a rarer stage's us/read can
        # print as 0.0 at one decimal)
        ran = [b["collect"], b["map_tail"], b["format"], t["lchain"],
               t["gchain_full"], gc["dp"], t["first-pass anchors"]]
        if t["rescue calls"]:
            ran += [t["rescue"], t["anchors"], t["iters"]]
        if gc["gwfa calls"]:
            ran += [gw["steps"], gw["peak"]]
        if "-c" in opts:
            ran.append(b["cigar"])
        if min(ran) <= 0:
            raise AssertionError(f"phase 13 (c) profmap {opts}: a stage "
                                 f"that ran reads 0: {lines}")
        log(f"phase 13 (c) profmap {' '.join(opts)} on phase 4's graph and "
            f"reads, one host thread ({dt:.1f} s with the interpreter's "
            f"start and the index; {smi}):")
        for ln in lines:
            log("  " + ln)


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 1
    # imported after the device check so that a copy of this script
    # alone fails on the import when it does run on a card
    from minigraph_tpu_torch import kernels
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.mapping.device_front import DeviceFront
    from minigraph_tpu_torch.mapping.mapper import map_files
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.options import IndexOptions, MapOptions
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa,
                                                 write_fasta)
    from minigraph_tpu_torch.utils import native

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    kernels.build()
    t1 = time.perf_counter()
    native.build()
    t2 = time.perf_counter()
    log(f"build: kernels {t1 - t0:.1f} s, native {t2 - t1:.1f} s")
    for line in kernels.build_log.splitlines():
        if ("registers" in line or "spill" in line
                or "entry function" in line):
            log("  " + line.strip())
    if kernels.build_log:
        for line in ptxas_lines(kernels.build_log,
                                ("sketch_kernel", "chunked_kernel",
                                 "chain_ring_kernel", "banded_kernel",
                                 "backtrack_kernel", "wfa_wave_kernel",
                                 "wfa_walk_kernel", "gwfa_kernel")):
            log(line)
    else:
        log("ptxas: the kernel library was up to date, no build this run")

    # ---- graph and reads (shared by phases 3 and 4)
    work = Path(__file__).resolve().parent / "build" / "smoke"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ref = make_reference(5_000_000, seed=42)
    hap = write_bubble_rgfa(ref, 43, str(work / "mhc5m.gfa"))
    short = simulate_reads([hap], 1024, seed=44, mean_len=1300,
                           min_len=800, max_len=1900)
    long_ = simulate_reads([hap], 128, seed=45, mean_len=15000,
                           min_len=2100, max_len=30000)
    write_fasta(str(work / "reads.fa"), short + long_)
    # the split's runs at realistic batch sizes: the same mix, 12.5x the
    # reads, so that 17 arena batches each hand the device ~2 full 2 kb
    # bucket batches at the starting share
    big = (simulate_reads([hap], 12800, seed=50, mean_len=1300,
                          min_len=800, max_len=1900)
           + simulate_reads([hap], 1600, seed=51, mean_len=15000,
                            min_len=2100, max_len=30000))
    write_fasta(str(work / "reads_big.fa"), big)
    log(f"inputs: 5 Mb graph + {len(short) + len(long_)} reads, + "
        f"{len(big)} reads ({sum(len(s) for _, s in big)} bp) for the "
        f"split in {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels against their plain versions
    rng = np.random.default_rng(7)
    io_, mo = IndexOptions(), MapOptions()
    k1 = check_sketch(rng, 256, 2048, io_.w, io_.k, reps=20)
    k1_mid = check_sketch(rng, 128, 8192, io_.w, io_.k, reps=10)
    k1_long = check_sketch(rng, 128, 32768, io_.w, io_.k, reps=5)
    # asm's (k, w) = (19, 10) at the same three shapes
    k1_asm = [check_sketch(rng, B, L, 10, 19, reps=r)
              for B, L, r in ((256, 2048, 20), (128, 8192, 10),
                              (128, 32768, 5))]
    g = read_gfa(str(work / "mhc5m.gfa"))
    gi = build_index(g, io_.k, io_.w, mo)
    front = DeviceFront(gi, mo, device="cuda")
    log(f"index: {len(gi.keys)} keys, hash join: {front.hashed}")
    if not front.hashed:
        raise AssertionError("the 5 Mb index should take the hash join")
    # the main path's 8 kb batch holds only a few reads: a full batch of
    # 2.1-8 kb reads off the same walk checks the kernels at that width
    mid = simulate_reads([hap], 128, seed=46, mean_len=5000, min_len=2100,
                         max_len=8000)
    (k2, k3, kb), (k2_mid, k3_mid, kb_mid), (k2_long, k3_long, kb_long) = \
        check_buckets(
        front, [[s for _, s in short[:256]],
                [s for _, s in mid if 2048 < len(s) <= 8192],
                [s for _, s in long_ if 8192 < len(s) <= 32768]],
        reps=(5, 5, 2))
    hash_tables = front.ji      # the cuckoo tables, reused by phase 5
    del front, g

    # ---- 4. main path: (i) every eligible read on the device with K2,
    # (ii) the same with K3, (iii) bails forced on every 40th read, (iv)
    # the split as map_files starts it, over >= 16 arena batches, (v)
    # host only: the reference bytes
    reads_fa = str(work / "reads.fa")
    n_reads = len(short) + len(long_)
    buf, st_host = io.StringIO(), {}
    map_files(read_gfa(str(work / "mhc5m.gfa")), [reads_fa], io_, mo,
              out=buf, n_threads=8, device=None, stats=st_host)
    host_gaf = buf.getvalue()
    n_lines = host_gaf.count("\n")

    # the first run of the file loop on the card pays one-time costs
    # (allocations, first calls); the second is the one held and timed
    first_gaf, st_first = device_run(gi, mo, reads_fa)
    kernels.reset_launches()
    dev_gaf, st = device_run(gi, mo, reads_fa)
    launches = dict(kernels.launches)
    if first_gaf != host_gaf:
        raise AssertionError(f"GAF of the first device run differs from "
                             f"the host run at line "
                             f"{first_diff(first_gaf, host_gaf)}")
    if dev_gaf != host_gaf:
        raise AssertionError(f"GAF differs from the host run at line "
                             f"{first_diff(dev_gaf, host_gaf)}")
    log(f"main path (i), K2, share pinned at 0: GAF bytes equal to the "
        f"host-only run ({n_lines} lines, {len(dev_gaf)} bytes)")
    for name in ("sketch", "chain_exact", "backtrack"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} kernel not launched on the main path")
    if launches["backtrack"] != st["n_batches"]:
        raise AssertionError(f"{launches['backtrack']} backtrack launches "
                             f"for {st['n_batches']} device batches")
    tot = st["n_device"] + st["n_fallback"] + st["n_chain_unsure"]
    share = st["n_device"] / max(1, tot)
    log(f"front: {st['n_device']}/{tot} eligible reads on the device "
        f"({st['n_fallback']} flagged, {st['n_chain_unsure']} chain "
        f"unsure, {st['n_batches']} device batches); launches "
        f"{launches}")
    if share < 0.8:
        raise AssertionError(f"only {share:.1%} of eligible reads on device")
    log(f"per-read path (native tail bailed): {st['n_perread']} reads of "
        f"the device run, {st_host['n_perread']} of the host-only run")
    log(run_line("run (i) device path, K2, first run", st_first, n_reads))
    log(run_line("run (i) device path, K2", st, n_reads))
    log(f"backtrack stage {st['stage_ms']['backtrack']:.3f} ms (one fused "
        f"kernel launch a batch; {st['n_batches']} batches)")
    for name, a, b, c, d in (("8 kb", k1_mid, k2_mid, k3_mid, kb_mid),
                             ("32 kb", k1_long, k2_long, k3_long, kb_long)):
        log(f"{name} bucket: sketch {json.dumps(a)}; chain {json.dumps(b)};"
            f" chunked chain {json.dumps(c)}; backtrack {json.dumps(d)}")

    # (ii) the chunked-walk chain (K3), read by DeviceFront.__init__
    os.environ["MGT_CHAIN_CHUNKED"] = "1"
    try:
        kernels.reset_launches()
        gaf_c, st_c = device_run(gi, mo, reads_fa)
        launches_c = dict(kernels.launches)
    finally:
        del os.environ["MGT_CHAIN_CHUNKED"]
    if gaf_c != host_gaf:
        raise AssertionError(f"chunked-chain GAF differs from the host run "
                             f"at line {first_diff(gaf_c, host_gaf)}")
    if launches_c["chain_chunked"] <= 0 or launches_c["chain_exact"]:
        raise AssertionError(f"chunked main path launches: {launches_c}")
    if launches_c["backtrack"] != st_c["n_batches"]:
        raise AssertionError("chunked main path: backtrack launches "
                             f"{launches_c['backtrack']} for "
                             f"{st_c['n_batches']} batches")
    if st_c["n_device"] != st["n_device"]:
        raise AssertionError(f"chunked main path kept {st_c['n_device']} "
                             f"reads on the device, K2's {st['n_device']}")
    log(f"main path (ii), MGT_CHAIN_CHUNKED=1: GAF bytes equal to the "
        f"host-only run, {st_c['n_device']}/{tot} reads on the device; "
        f"chain stage {st_c['stage_ms']['chain']:.3f} ms against K2's "
        f"{st['stage_ms']['chain']:.3f} ms; launches {launches_c}")
    log(run_line("run (ii) device path, K3", st_c, n_reads))

    # (iii) bails forced for every 40th read of a batch, through the
    # native file loop (phase 7 (c): the Python reader loop)
    kernels.reset_launches()
    forced_gaf, st_f = forced_bail_run(gi, mo, reads_fa, 40)
    if forced_gaf != host_gaf:
        raise AssertionError(f"GAF with forced per-read fallbacks differs "
                             f"at line {first_diff(forced_gaf, host_gaf)}")
    if st_f["n_perread"] <= 0:
        raise AssertionError("the forced run took no read off the batch")
    if kernels.launches["backtrack"] != st_f["n_batches"]:
        raise AssertionError(f"forced run: launches "
                             f"{dict(kernels.launches)}")
    log(f"main path (iii) with forced bails, native loop: "
        f"{st_f['n_perread']} reads re-mapped on the per-read path, "
        f"{st_f['n_device']} kept on the device, GAF bytes equal to the "
        f"host-only run")
    log(run_line("run (iii) forced bails, native loop", st_f, n_reads))

    # (iv) map_files(device="cuda"), the split as it starts (share 0.35):
    # (a) arena batches of ~1/20 of the small file's bases (~57 reads, far
    # below the buckets' widths); on the large file (b) the default -K
    # (one arena batch, the command line's run) and (c) a -K of 1/16 of
    # its bases (~900 reads a batch); the large file's host-only run and
    # its device path (share pinned at 0) beside them
    gfa = str(work / "mhc5m.gfa")
    kernels.reset_launches()
    gaf_s, st_s = split_run(reads_fa, gfa, io_, mo,
                            sum(len(s) for _, s in short + long_) // 20)
    if gaf_s != host_gaf:
        raise AssertionError(f"split GAF differs from the host run at line "
                             f"{first_diff(gaf_s, host_gaf)}")
    if st_s["n_arena"] < 16:
        raise AssertionError(f"only {st_s['n_arena']} arena batches")
    log("main path (iv a), GAF bytes equal to the host-only run: "
        + split_line("split, small file", st_s)
        + f"; launches {dict(kernels.launches)}")
    log(run_line("run (iv a) split, small batches", st_s, n_reads))
    log(run_line("run (v) host only", st_host, n_reads) + ", 8 host threads")

    big_fa, n_big = str(work / "reads_big.fa"), len(big)
    buf, st_hb = io.StringIO(), {}
    map_files(read_gfa(gfa), [big_fa], io_, mo, out=buf, n_threads=8,
              device=None, stats=st_hb)
    big_gaf = buf.getvalue()
    gaf_pb, st_pb = device_run(gi, mo, big_fa)
    big_runs = [("(iv b) split, default -K", split_run(big_fa, gfa, io_, mo)),
                ("(iv c) split, -K 1/17", split_run(
                    big_fa, gfa, io_, mo,
                    sum(len(s) for _, s in big) // 17))]
    for name, (gaf_b, st_b) in [("(iv p) device path, large file",
                                 (gaf_pb, st_pb))] + big_runs:
        if gaf_b != big_gaf:
            raise AssertionError(f"{name}: GAF differs from the host run "
                                 f"at line {first_diff(gaf_b, big_gaf)}")
    if big_runs[1][1][1]["n_arena"] < 16:
        raise AssertionError(f"only {big_runs[1][1][1]['n_arena']} arena "
                             f"batches at -K 1/17")
    log(f"large file: GAF bytes equal to its host-only run in every run "
        f"({big_gaf.count(chr(10))} lines, {len(big_gaf)} bytes)")
    log(run_line("run (iv p) device path, share pinned at 0, large file",
                 st_pb, n_big))
    for name, (_, st_b) in big_runs:
        log(split_line(f"main path {name}", st_b))
        log(run_line(f"run {name}", st_b, n_big))
    log(run_line("run (v) host only, large file", st_hb, n_big)
        + ", 8 host threads")

    # ---- 5. batched map step
    flat_ref = make_reference(400_000, seed=47)
    flat_hap = write_bubble_rgfa(flat_ref, 48, str(work / "flat400k.gfa"))
    flat_gi = build_index(read_gfa(str(work / "flat400k.gfa")), io_.k,
                          io_.w, mo)
    flat_reads = simulate_reads([flat_hap], STEP_B, seed=49, mean_len=1300,
                                min_len=800, max_len=1900)
    step_launches, k4, k5, k6 = step_phase(
        gi, hash_tables, [s for _, s in short[:STEP_B]], flat_gi,
        [s for _, s in flat_reads], kernels)

    # ---- 6. banded gap scores
    wfa_launches, k7 = wfa_phase(ref, kernels, reps=5)

    # ---- 7. the rest of the command line: asm, sr, the Python loop
    asm = cli_phase(ref, gfa, work, kernels, k1_asm)
    forced_python_run(gi, mo, reads_fa, host_gaf, n_reads, kernels)

    # ---- 8. base-level alignment (-c)
    mo_c = cigar_main_path(gi, mo, reads_fa, st, n_reads, kernels)
    cigar_asm(*asm, kernels)
    pool_launches = cigar_pool_run(gi, mo_c, reads_fa, n_reads, kernels)
    (k_wave, k_walk), (k_wave2, k_walk2) = wfa_exact_phase(ref, reps=5)
    log(f"2048 bucket: wfa_wave {json.dumps(k_wave2)}; wfa_walk "
        f"{json.dumps(k_walk2)}")

    # ---- 9. the device GWFA bridge pool
    k_gwfa, gwfa_launches = gwfa_phase(gi, mo, reads_fa, host_gaf, n_reads)

    # ---- 10. graph generation, bubble calls, mapping on the new graph
    ggen_out = ggen_phase(ref, gfa, work, reads_fa, n_reads)

    # ---- 11. --seed-device: the sweep, the device index, graph
    # generation and one whole haplotype with the seed stage on the card
    k1_sd, sd_launches = seed_device_phase(ref, gfa, work, kernels, ggen_out)

    # ---- 12. multi-GPU and the fork pool: (a) the v1 step, (b) the
    # sharded steps on NCCL and gloo, (c) distributed mapping, (d) the
    # fork pool, (e) devprof
    short_seqs = [s_ for _, s_ in short]
    v1_launches, k4_v1 = v1_phase(gi, short_seqs[:STEP_B], kernels)
    shard_phase(ref, gi, hash_tables, short_seqs, work, kernels)
    dist_phase(gfa, reads_fa, host_gaf, work)
    fork_phase(gfa, *ggen_out)
    devprof_phase(gfa, reads_fa)

    # ---- 13. the offline tools: (a) the cookbook chain on phase 10's
    # graph (--call, again with --seed-device on K1, then mgutils), (b)
    # the GAF tools, (c) profmap in a child process
    cookbook_phase(work, ggen_out, kernels)
    gaf_tools_phase(gfa, reads_fa, host_gaf, work)
    profmap_phase(gfa, reads_fa, smi)

    entries = [
        dict(name="sketch", route="cuda",
             source="minigraph_tpu_torch/csrc/sketch.cu",
             replaces="minigraph_tpu/ops/sketch_pallas.py:44",
             launches=launches["sketch"], library_ms=None, **k1),
        dict(name="chain_exact", route="cuda",
             source="minigraph_tpu_torch/csrc/chain_exact.cu",
             replaces="minigraph_tpu/ops/chain_exact_pallas.py:45",
             launches=launches["chain_exact"], library_ms=None, **k2),
        dict(name="chain_chunked", route="cuda",
             source="minigraph_tpu_torch/csrc/chain_chunked.cu",
             replaces="minigraph_tpu/ops/chain_chunked_pallas.py:58",
             launches=launches_c["chain_chunked"], library_ms=None, **k3),
        dict(name="chain_ring", route="cuda",
             source="minigraph_tpu_torch/csrc/chain_ring.cu",
             replaces="minigraph_tpu/ops/chain_pallas.py:41",
             launches=step_launches["chain_ring"], **k4),
        dict(name="probe_bucketed", route="cuda",
             source="minigraph_tpu_torch/csrc/probe.cu",
             replaces="minigraph_tpu/ops/probe_pallas.py:34",
             launches=step_launches["probe_bucketed"], **k5),
        dict(name="probe_flat", route="cuda",
             source="minigraph_tpu_torch/csrc/probe.cu",
             replaces="minigraph_tpu/ops/probe_pallas.py:110",
             launches=step_launches["probe_flat"], **k6),
        dict(name="wfa_banded", route="cuda",
             source="minigraph_tpu_torch/csrc/wfa_banded.cu",
             replaces="minigraph_tpu/ops/wfa_pallas.py:52",
             launches=wfa_launches, **k7),
        dict(name="backtrack", route="cuda",
             source="minigraph_tpu_torch/csrc/backtrack.cu",
             replaces="minigraph_tpu/ops/backtrack_jax.py:65",
             launches=launches["backtrack"],
             **{k: v for k, v in kb.items() if k != "max_steps"},
             wider=[{k: v for k, v in d.items() if k != "max_steps"}
                    for d in (kb_mid, kb_long)]),
        dict(name="wfa_wave", route="cuda",
             source="minigraph_tpu_torch/csrc/wfa_exact.cu",
             replaces="minigraph_tpu/ops/wfa_jax.py:27",
             launches=pool_launches["wfa_wave"], **k_wave),
        dict(name="wfa_walk", route="cuda",
             source="minigraph_tpu_torch/csrc/wfa_exact.cu",
             replaces="minigraph_tpu/ops/wfa_jax.py:221",
             launches=pool_launches["wfa_walk"], **k_walk),
        dict(name="gwfa", route="cuda",
             source="minigraph_tpu_torch/csrc/gwfa.cu",
             replaces="minigraph_tpu/ops/gwfa_jax.py:189",
             launches=gwfa_launches["gwfa"], library_ms=None, **k_gwfa),
        # K1 again, on this slice's path: the chunk-halo sweep of
        # --seed-device at its (16, 32809) width, launches of run 11 (d)
        dict(name="sketch_seed_device", route="cuda",
             source="minigraph_tpu_torch/csrc/sketch.cu",
             replaces="minigraph_tpu/ops/sketch_pallas.py:44",
             launches=sd_launches["sketch"], library_ms=None, **k1_sd),
        # K4 again, as the v1 step runs it: W = 64 on its (512, 2048)
        # anchors, launches of run 12 (a)
        dict(name="chain_ring_v1", route="cuda",
             source="minigraph_tpu_torch/csrc/chain_ring.cu",
             replaces="minigraph_tpu/ops/chain_pallas.py:41",
             launches=v1_launches["chain_ring"], **k4_v1),
    ]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
