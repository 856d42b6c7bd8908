"""The reduction of a profiler trace to busy time, idle gaps and
kernel time, on a trace written by hand."""
from __future__ import annotations

import pytest

from portbench.tracing import reduce_events, union


def X(name, ts, dur, cat="cpu_op", tid=1):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "tid": tid}


def test_union():
    assert union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]


def test_reduce_events():
    ev = [
        X("pb:window", 100, 1000, "user_annotation"),
        X("pb:file", 101, 998, "user_annotation"),
        X("pb:native_tail", 600, 500, "user_annotation"),
        X("k1", 50, 100, "kernel"),             # starts before the window
        X("k2", 300, 100, "kernel"),
        X("Memcpy DtoH", 350, 150, "gpu_memcpy"),
        X("k1", 1050, 100, "kernel"),           # ends after it
        X("pb:native_tail", 600, 500, "gpu_user_annotation"),
        {"ph": "M", "name": "process_name"},
    ]
    r = reduce_events(ev)
    assert r["window_s"] == pytest.approx(1000e-6)
    # busy: [100,150) + [300,500) + [1050,1100) = 300 us
    assert r["busy_s"] == pytest.approx(300e-6)
    assert r["kernel_s"] == pytest.approx((50 + 100 + 50) * 1e-6)
    ops = dict(r["device_ops"])
    assert ops["Memcpy DtoH"] == pytest.approx(150e-6)
    assert ops["k1"] == pytest.approx(100e-6)
    idle = dict(r["idle_gaps"])
    # gaps [150,300) and [500,1050): the second's middle is in the tail
    assert idle["window>file"] == pytest.approx(150e-6)
    assert idle["window>file>native_tail"] == pytest.approx(550e-6)


def test_no_window_no_reading():
    assert reduce_events([X("k", 0, 1, "kernel")]) is None
