"""Progress/tracing logging (sys.c equivalents): wall/CPU timestamps on
pipeline milestones, `[M::func::<wall>*<cpu%>]` stderr lines."""
from __future__ import annotations

import os
import resource
import sys
import time

VERBOSE = int(os.environ.get("MGT_VERBOSE", "3"))
_t0 = time.time()


def realtime() -> float:
    return time.time() - _t0


def cputime() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def peakrss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


def mlog(func: str, msg: str, level: int = 3) -> None:
    """[M::func::wall*cpu%] message (sys.c:92-117 format)."""
    if VERBOSE >= level:
        rt = realtime()
        cpu = cputime() / rt if rt > 0 else 0.0
        sys.stderr.write(f"[M::{func}::{rt:.3f}*{cpu:.2f}] {msg}\n")


def final_log(version: str, argv) -> None:
    if VERBOSE >= 3:
        sys.stderr.write(f"[M::main] Version: {version}\n")
        sys.stderr.write("[M::main] CMD: " + " ".join(argv) + "\n")
        sys.stderr.write(
            f"[M::main] Real time: {realtime():.3f} sec; "
            f"CPU: {cputime():.3f} sec; "
            f"Peak RSS: {peakrss() / 1024.0 / 1024.0:.3f} GB\n")
