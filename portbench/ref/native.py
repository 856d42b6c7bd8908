"""Build and load the reference's native library.

csrc/ holds a frozen copy of the port's native/*.c.  It is compiled
with the flags the port uses for its own copy into
<checkout>/build/portbench/ref/libmgtref.so at first use (and again
when a source is newer), under a file lock, written under a temporary
name and renamed into place.  -Wl,-Bsymbolic binds the library's calls
to its own functions, so the port's libmgt.so, loaded in the same
process, is never called from here.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "portbench" / "ref"
SO_PATH = BUILD_DIR / "libmgtref.so"

_lib = None


def _needs_build() -> bool:
    if not SO_PATH.exists():
        return True
    t = SO_PATH.stat().st_mtime
    return any(p.stat().st_mtime > t for p in CSRC.glob("*.c"))


def build() -> float:
    """Compile the library if it is missing or stale; the seconds spent."""
    import time
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _needs_build():
            return 0.0
        tmp = BUILD_DIR / f"libmgtref.so.tmp{os.getpid()}"
        cmd = ["gcc", "-O3", "-march=native", "-funroll-loops",
               "-ffp-contract=off", "-shared", "-fPIC", "-Wl,-Bsymbolic",
               "-o", str(tmp), *map(str, sorted(CSRC.glob("*.c"))),
               "-lm", "-lpthread", "-lz"]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"reference build failed:\n{r.stderr}")
        os.replace(tmp, SO_PATH)
    return time.perf_counter() - t0


def get_lib():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(SO_PATH))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.mgt_radix_argsort_u64.restype = None
        lib.mgt_radix_argsort_u64.argtypes = [u64p, u64p, ctypes.c_int64]
        _lib = lib
    return _lib
