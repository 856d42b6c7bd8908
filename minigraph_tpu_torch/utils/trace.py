"""The port's spans, and the front's per-stage device timer.

A span (`with span("front.submit"):`) adds its host time
(`perf_counter_ns`) and one call to a process-wide registry under its
name.  `snapshot()` copies the registry out: `map_reads` puts it into
its `stats` (`span_ms`, `span_n`).  Spans are per arena batch, per
bucket batch or once per set-up, never per read.  `tools/spanprof.py`
reads every span: its totals, and the device's idle time by the span
the host was in.

While a torch profiler records, a span also opens the range
`torch.profiler.record_function("mg:" + name)`, so the program's spans
land in the same trace as the kernels and copies, on one clock.  With
no profiler recording, the span never enters `record_function` (which
costs microseconds even then): it reads the profiler's own flag, and
only where torch is already imported.  The profiler records the thread
that started it, so a span of another thread (the reader's prefetch,
the native file loop's tail worker, the Python reader loop's host-share
worker) counts in the registry but has no range.

Each name is entered by one thread at a time; the reader's prefetch
thread has names of its own (`read.arena`), and the `tail.*` names are
the tail worker's while the split is open, the loop thread's once it
has collapsed.  The registry's adds take a lock all the same, so that
no update is lost.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Dict

PREFIX = "mg:"

_lock = threading.Lock()
_ns: Dict[str, int] = {}
_n: Dict[str, int] = {}


def _profiling() -> bool:
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class span:
    """Context manager: the block's host time under `name`; `ns` and
    `ms` hold it once the block has left, `t0` its start
    (`perf_counter_ns`)."""
    __slots__ = ("name", "ns", "t0", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.ns = 0
        self._rf = None

    def __enter__(self) -> "span":
        if _profiling():
            import torch
            self._rf = torch.profiler.record_function(PREFIX + self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.ns = time.perf_counter_ns() - self.t0
        with _lock:
            _ns[self.name] = _ns.get(self.name, 0) + self.ns
            _n[self.name] = _n.get(self.name, 0) + 1
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False

    @property
    def ms(self) -> float:
        return self.ns / 1e6


def snapshot() -> dict:
    """The registry's totals since the process started: {"span_ms":
    {name: ms}, "span_n": {name: calls}}."""
    with _lock:
        return {"span_ms": {k: v / 1e6 for k, v in _ns.items()},
                "span_n": dict(_n)}


class StageTimer:
    """Per-stage device time of the device front: CUDA events on the
    card (read back by `settle` once the batch's fetch has waited for
    them), a host clock on the CPU.  `ms` is what `map_reads` reports
    as `stage_ms`."""

    def __init__(self, device, stages):
        self.cuda = device.type == "cuda"
        self.ms = {s: 0.0 for s in stages}
        self._pending = []

    def mark(self):
        """A CUDA event recorded on the current stream, or the host
        clock on the CPU."""
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, stage, t0, t1):
        if self.cuda:
            self._pending.append((stage, t0, t1))
        else:
            self.ms[stage] += (t1 - t0) * 1e3

    def settle(self):
        """Adds the stages whose events have completed: a batch's fetch
        waits for its own stages only, and the stream runs them in the
        order they were added."""
        done = 0
        for stage, e0, e1 in self._pending:
            if not e1.query():
                break
            self.ms[stage] += e0.elapsed_time(e1)
            done += 1
        del self._pending[:done]
