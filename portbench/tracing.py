"""The traced run: spans around the layers' calls, and the reduction of
the profiler's trace to busy time, idle gaps and kernel times.

Spans are `torch.profiler.record_function` ranges named "pb:<layer>",
recorded from the harness: around the window and each file it maps, and
around the calls into the layers below the file loop, which the harness
wraps for the traced run only (the host share's and the device share's
native tail, the front's submit and gather).  The device's intervals are
the trace's kernels, copies and memsets.
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "pb:"


@contextmanager
def span(name: str, on: bool):
    if not on:
        yield
        return
    import torch
    with torch.profiler.record_function(PREFIX + name):
        yield


def _wrap(obj, attr: str, name: str, undo: list) -> None:
    real = getattr(obj, attr)

    def traced(*args, **kw):
        with span(name, True):
            return real(*args, **kw)
    setattr(obj, attr, traced)
    undo.append((obj, attr, real))


def wrap_layers(mapper, front) -> list:
    """Spans around the file loop's calls into the layers below it (for
    the traced run only).  Returns what `unwrap` puts back."""
    undo: list = []
    _wrap(mapper, "_map_host_share", "host_share", undo)
    _wrap(mapper, "_open_split_finish", "device_share", undo)
    _wrap(mapper, "map_batch_native", "native_tail", undo)
    _wrap(front, "submit", "front.submit", undo)
    _wrap(front, "gather_flat", "front.gather", undo)
    return undo


def unwrap(undo: list) -> None:
    for obj, attr, real in reversed(undo):
        setattr(obj, attr, real)


def union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_events(events: List[dict], top: int = 10) -> Optional[dict]:
    """Busy and idle time of the device inside the span "pb:window", in
    seconds: busy_s (the union of kernel, copy and memset intervals),
    window_s, kernel_s (the kernels' summed time), device_ops (the
    operations that took most time, by name) and idle_gaps (idle time
    by the chain of spans the host was in at each gap's middle).  None
    when the trace has no window span."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == PREFIX + "window"]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, spans = [], []
    by_name: Dict[str, float] = {}
    kernel_us = 0.0
    for e in xs:
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
            if e["cat"] == "kernel":
                kernel_us += b - a
        elif str(e.get("name", "")).startswith(PREFIX) \
                and e.get("cat") != "gpu_user_annotation":
            spans.append((a, b, e["name"][len(PREFIX):]))
    busy = union(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps = []
    t = w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    idle: Dict[str, float] = {}
    spans.sort()
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
        idle[label] = idle.get(label, 0.0) + (b - a)
    return {
        "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
        "kernel_s": kernel_us / 1e6,
        "device_ops": [[n, v / 1e6] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, v / 1e6] for n, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def reduce_profile(prof, path: str) -> Optional[dict]:
    """Export the profiler's trace to `path`, reduce it, delete it."""
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    return reduce_events(events)
