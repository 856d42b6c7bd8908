"""Device pool for the GWFA bridge jobs of graph-chain materialization
(--gwfa-device).

Port of the JAX package's align/gwfa_device.py.  The native materializer
harvests its bridge sites through the thread-local hook in
native/mgt_gchain.c (mode 1), this pool solves them as one batch with
ops/gwfa.py `gwfa_batch` (the `gwfa` kernel on the card, the plain
version on the CPU), and a second pass injects the results (mode 2).
Jobs the kernel flags, and jobs longer than the largest query bucket,
come back as -2, and the inject pass runs the inline host engine for
them: the output stays byte-identical to an all-host run.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..ops.gwfa import (build_device_graph, gwfa_batch, gwfa_launch,
                        out_views, pack_jobs)
from ..utils.syslog import mlog

WCAP = 64
DEGCAP = 6
QCAP_BUCKETS = (256, 1024)
J_BUCKET = 16


class DeviceGwfaPool:
    """Solves bridge jobs on `device` ("cuda" launches the kernel, "cpu"
    runs the plain version); counts jobs, jobs solved on the device,
    jobs flagged to the host, jobs over the largest bucket and batches
    (kernel calls), and adds up two times a batch: kernel_ms, the launch
    alone (`gwfa_batch`'s `timing`), and batch_ms, the whole wrapper call
    with its host work (on the CPU the job packing too).  On the
    card both are CUDA events on the pool's own stream, so that kernels
    the front launches from other threads fall outside them; on the CPU
    both are the host clock.  The Python loop's reader threads share one
    pool: a lock keeps its calls and counts whole."""

    def __init__(self, gi, device="cuda"):
        self.gi = gi
        self.device = torch.device(device)
        self._gd = None
        self.n_jobs = 0
        self.n_device = 0
        self.n_flagged = 0
        self.n_oversize = 0
        self.n_batches = 0
        self.kernel_ms = 0.0
        self.batch_ms = 0.0
        self._stream = None
        self._lock = threading.Lock()

    def graph(self):
        if self._gd is None:
            gd, _ = build_device_graph(self.gi.g, self.gi.es, DEGCAP)
            self._gd = gd.to(self.device)
            if self.device.type == "cuda":
                # the copies ran on the current stream; the batches run
                # on the pool's own
                torch.cuda.synchronize(self.device)
                self._stream = torch.cuda.Stream(self.device)
        return self._gd

    def _solve(self, rows, qcap, J):
        """One gwfa_batch call, timed into kernel_ms and batch_ms;
        returns its outputs as numpy arrays.  On the card the jobs go
        over in one copy (pack_jobs) and the four outputs come back in
        one (the kernel's one buffer)."""
        gd = self.graph()
        launch = []
        if self._stream is None:
            t0 = time.perf_counter()
            res = gwfa_batch(gd, *pack_jobs(rows, qcap, J, self.device),
                             degcap=DEGCAP, wcap=WCAP, timing=launch)
            self.batch_ms += (time.perf_counter() - t0) * 1e3
            self.kernel_ms += sum(launch)
            return {key: v.numpy() for key, v in res.items()}
        with torch.cuda.stream(self._stream):
            args = pack_jobs(rows, qcap, J, self.device)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = gwfa_launch(gd, *args, degcap=DEGCAP, wcap=WCAP,
                              timing=launch)
            e1.record()
            res = {key: v.numpy()
                   for key, v in out_views(out.cpu(), J, WCAP).items()}
        self.batch_ms += e0.elapsed_time(e1)
        self.kernel_ms += sum(k0.elapsed_time(k1) for k0, k1 in launch)
        return res

    def run(self, jobs: np.ndarray, qseq: str):
        """jobs: (n, 8) int64 harvest rows [qs, qe, v0, end0, v1, end1,
        max_ed, 0].  Returns (res_s, res_walk, res_wn) in site order;
        res_s[k] == -2 asks the inline host engine to bridge site k."""
        qb = np.frombuffer(qseq.encode("latin-1"), dtype=np.uint8)
        return self.run_multi(jobs, [qb] * len(jobs))

    def run_multi(self, jobs: np.ndarray, qbufs):
        """run() for jobs pooled across reads: qbufs[k] is job k's own
        query byte array."""
        with self._lock:
            return self._run_multi(jobs, qbufs)

    def _run_multi(self, jobs, qbufs):
        n = len(jobs)
        self.n_jobs += n
        res_s = np.full(n, -2, dtype=np.int64)
        res_walk = np.full((n, WCAP), -1, dtype=np.int32)
        res_wn = np.zeros(n, dtype=np.int64)
        if n == 0:
            return res_s, res_walk, res_wn
        lens = jobs[:, 1] - jobs[:, 0]
        lo = 0
        for qcap in QCAP_BUCKETS:
            sel = np.nonzero((lens <= qcap) & (lens > lo))[0]
            lo = qcap
            if len(sel) == 0:
                continue
            J = J_BUCKET * ((len(sel) + J_BUCKET - 1) // J_BUCKET)
            rows = [(qbufs[k][jobs[k, 0]: jobs[k, 1]].tobytes(),
                     *(int(x) for x in jobs[k, 2:7])) for k in sel]
            res = self._solve(rows, qcap, J)
            self.n_batches += 1
            for bi, k in enumerate(sel):
                if res["flags"][bi]:
                    self.n_flagged += 1
                    continue
                self.n_device += 1
                res_s[k] = res["s"][bi]
                wn = int(res["n_walk"][bi])
                res_wn[k] = wn
                res_walk[k, :wn] = res["walk"][bi][:wn]
        self.n_oversize += int(np.sum(lens > QCAP_BUCKETS[-1]))
        return res_s, res_walk, res_wn

    def log_stats(self):
        if self.n_jobs:
            mlog("gwfa_device",
                 f"device GWFA bridges: {self.n_device}/{self.n_jobs} "
                 f"on device, {self.n_flagged} flagged to host, "
                 f"{self.n_oversize} oversize")


class GwfaPending:
    """What a deferred read's tail returns: its bridge jobs are in the
    batch sink, and the loop maps it again after solve()."""
    __slots__ = ("ticket",)

    def __init__(self, ticket: int):
        self.ticket = ticket


class GwfaBatchSink:
    """Cross-read pooling: phase 1 collects every read's bridge jobs
    (reads with sites return GwfaPending), solve() runs one pool call for
    the whole batch, phase 2 maps the pending reads again with their
    slices injected (hook mode 2).  A missing injection only costs
    device work: the native tail then bridges with the inline host
    engine, so the output never depends on the bookkeeping."""

    def __init__(self, pool: DeviceGwfaPool):
        self.pool = pool
        self.phase = 1
        self.rows = []
        self.qbufs = []
        self._slices = []
        self._queue = []

    def add(self, jobs: np.ndarray, qseq: str) -> int:
        self.rows.append(np.array(jobs))
        self.qbufs.append(
            np.frombuffer(qseq.encode("latin-1"), dtype=np.uint8))
        return len(self.rows) - 1

    def solve(self):
        self.phase = 2
        if not self.rows:
            return
        qjob = [qb for rows, qb in zip(self.rows, self.qbufs)
                for _ in range(len(rows))]
        res_s, res_walk, res_wn = self.pool.run_multi(
            np.concatenate(self.rows, axis=0), qjob)
        off = 0
        for rows in self.rows:
            n = len(rows)
            self._slices.append(
                (np.ascontiguousarray(res_s[off: off + n]),
                 np.ascontiguousarray(res_walk[off: off + n]),
                 np.ascontiguousarray(res_wn[off: off + n])))
            off += n

    def queue_inject(self, tickets):
        """Arm the phase-2 injections of one fragment's reads, in the
        order its tail calls consume them."""
        self._queue = [self._slices[t] for t in tickets]

    def pop_inject(self):
        return self._queue.pop(0) if self._queue else None
