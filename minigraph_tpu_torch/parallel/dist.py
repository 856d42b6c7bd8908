"""Multi-process distributed mapping on torch.distributed.

Port of the JAX package's parallel/dist.py.  The reference has no
distributed backend (its parallelism is one node's pthreads,
kthread.c); here, as in the JAX package:

  * fragments are data-parallel across processes: fragment ordinal mod
    world size picks the rank, a deterministic split, so the output does
    not depend on the number of processes;
  * every rank builds the minimizer index (a deterministic function of
    the graph) and, with --device cuda, a DeviceFront on card
    rank % device_count (ranks share cards when there are more ranks);
  * each rank maps its fragments on the per-read path (the front's
    eligible reads through map_frag_tail), rank 0 gathers every rank's
    GAF records with their ordinals and writes them in input order,
    byte-identical to a single-process run; the other ranks write
    nothing;
  * with --cov, the coverage vectors are gathered and summed on rank 0
    in rank order (numpy, as the JAX version sums them), which then
    writes the dc:f tags.

The text and the coverage vectors travel over a gloo group on host
objects, never NCCL.  Graph generation (-cxggs) stays single-process.

Run one process a rank, each with the CLI's arguments after its own:

    python -m minigraph_tpu_torch.parallel.dist --coordinator host0:29500 \\
        --num-processes 2 --process-id 0 [minigraph args...]

Where the JAX package patches the CLI's map_files, `main` hands
cli.main its mapping function.  Rank 0 writes to standard output; -o
is refused, since every rank would open the file.  Like the JAX
version, this one maps without the GWFA pool (--gwfa-device has no
effect).
"""
from __future__ import annotations

import copy
import getopt
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator: str, num_processes: int,
               process_id: int) -> None:
    """Join the gloo process group at tcp://coordinator as rank
    process_id of num_processes (the collectives here carry host
    objects only)."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _host_group():
    """The group host objects travel over: the default one when it is
    gloo, else (a caller that initialised NCCL itself) a gloo group of
    every rank."""
    if dist.get_backend() == "gloo":
        return None
    return dist.new_group(backend="gloo")


def map_files_distributed(g, fns: List[str], ipt, opt0, out=sys.stdout,
                          n_threads: int = 1, device="cuda",
                          gwfa_device=None) -> int:
    """mg_map_files over the ranks of the process group (the signature of
    mapping/mapper.py map_files; n_threads and gwfa_device are not
    used).  Every rank reads the same files, maps the fragments whose
    ordinal is congruent to its rank, and rank 0 writes the merged GAF
    in input order (or, with --cov, updates g's dc:f tags)."""
    from ..index.midx import build_index
    from ..mapping.mapper import (_check_options, _read_batch_frag,
                                  flip_pair, frag_records, map_frag,
                                  map_frag_tail, resolve_device)
    from ..options import MG_M_CAL_COV, MG_M_FRAG_MODE, MG_M_INDEPEND_SEG
    from ..seqio.bseq import BSeqFile, qname_same, toupper
    from ..utils.syslog import mlog

    t0 = time.perf_counter()
    rank, n_proc = dist.get_rank(), dist.get_world_size()
    group = _host_group()
    opt = copy.copy(opt0)
    _check_options(opt)
    gi = build_index(g, ipt.k, ipt.w, opt)
    if gi is None:
        return -1
    dev = resolve_device(device)
    front = None
    if dev is not None:
        from .. import kernels
        from ..mapping.device_front import DeviceFront
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        front = DeviceFront(gi, opt, device=dev)
        kernels.reset_launches()
    cov = None
    if opt.flag & MG_M_CAL_COV:
        cov = (np.zeros(g.n_seg, dtype=np.float64),
               np.zeros(g.n_arc, dtype=np.float64))

    frag_mode = bool(opt.flag & MG_M_FRAG_MODE)
    groups = [fns] if frag_mode and len(fns) > 1 else [[fn] for fn in fns]
    records = []          # (ordinal, GAF text) of this rank's fragments
    ordinal = 0
    for fgroup in groups:
        fps = [BSeqFile(fn) for fn in fgroup]
        try:
            while True:
                batch = _read_batch_frag(fps, opt.mini_batch_size) \
                    if len(fps) > 1 else \
                    fps[0].read_batch(opt.mini_batch_size, frag_mode)
                if not batch:
                    break
                for r in batch:
                    r.seq = toupper(r.seq)
                frags = []
                j = 0
                for i in range(1, len(batch) + 1):
                    if i == len(batch) or not frag_mode or \
                            not qname_same(batch[i - 1].name,
                                           batch[i].name):
                        frags.append((j, i - j))
                        j = i
                mine = [(fi, off, n_seg)
                        for fi, (off, n_seg) in enumerate(frags)
                        if (ordinal + fi) % n_proc == rank]
                front_res = {}
                if front is not None:
                    fidx = [fi for fi, off, n_seg in mine
                            if front.eligible(opt, n_seg, batch[off].l_seq)]
                    if fidx:
                        handle = front.submit(
                            [batch[frags[fi][0]].seq for fi in fidx])
                        front_res = dict(zip(fidx, front.gather(handle)))
                for fi, off, n_seg in mine:
                    if n_seg == 2:
                        flip_pair(batch, off, opt.pe_ori)
                    seqs = [batch[off + k].seq for k in range(n_seg)]
                    qlens = [len(s) for s in seqs]
                    fr = front_res.get(fi)
                    if fr is not None:
                        gcs_list = [map_frag_tail(
                            gi, qlens, seqs, opt, batch[off].name, fr.ax,
                            fr.ay, fr.rep_len, fr.mini_pos, fr.n_mv,
                            chains_u=fr.u, fast_emit=True)]
                    elif opt.flag & MG_M_INDEPEND_SEG:
                        gcs_list = [map_frag(gi, [qlens[k]], [seqs[k]], opt,
                                             batch[off + k].name,
                                             fast_emit=True)
                                    for k in range(n_seg)]
                    else:
                        gcs_list = [map_frag(gi, qlens, seqs, opt,
                                             batch[off].name, fast_emit=True)]
                    txt = frag_records(gi, opt, batch, off, n_seg, qlens,
                                       gcs_list, cov)
                    if cov is None:
                        records.append((ordinal + fi, txt))
                ordinal += len(frags)
        finally:
            for fp in fps:
                fp.close()

    if front is not None:
        front.log_stats()
        mlog("map_files_distributed",
             f"rank {rank}: front launches {dict(kernels.launches)}")
    mlog("map_files_distributed",
         f"rank {rank} of {n_proc}: mapped in "
         f"{time.perf_counter() - t0:.3f} s")
    gathered = [None] * n_proc
    if cov is not None:
        dist.all_gather_object(gathered, cov, group=group)
        if rank == 0:
            from ..ggen.cov import aux_update_cv
            aux_update_cv(g, "dc", np.stack([c[0] for c in gathered]).sum(0),
                          np.stack([c[1] for c in gathered]).sum(0))
        return 0
    # interleave the ranks' records back into input order on rank 0
    dist.all_gather_object(gathered, records, group=group)
    if rank == 0:
        for _, txt in sorted((r for part in gathered for r in part),
                             key=lambda r: r[0]):
            out.write(txt)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    from .. import cli

    argv = list(sys.argv[1:] if argv is None else argv)
    coord = nproc = pid = None
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "--coordinator":
            coord = argv[i + 1]
            i += 2
        elif argv[i] == "--num-processes":
            nproc = int(argv[i + 1])
            i += 2
        elif argv[i] == "--process-id":
            pid = int(argv[i + 1])
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    if None in (coord, nproc, pid):
        sys.stderr.write("usage: dist --coordinator H:P --num-processes N "
                         "--process-id I [minigraph args...]\n")
        return 1
    try:
        opts, _ = getopt.gnu_getopt(cli._split_optional(rest), cli._SHORT,
                                    cli._LONG)
    except getopt.GetoptError as e:
        sys.stderr.write(f"[ERROR] {e}\n")
        return 1
    if any(k == "-o" and v != "-" for k, v in opts):
        sys.stderr.write("[ERROR] dist: rank 0 writes to standard output; "
                         "-o is not supported\n")
        return 1
    initialize(coord, nproc, pid)
    stdout = sys.stdout
    if pid != 0:
        # only rank 0 writes (the GAF merge, the cov-annotated graph)
        import io
        sys.stdout = io.StringIO()
    try:
        return cli.main(rest, map_fn=map_files_distributed)
    finally:
        sys.stdout = stdout
        dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
