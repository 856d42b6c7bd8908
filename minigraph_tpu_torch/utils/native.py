"""Build and load the native host runtime (native/*.c) for the port.

The C sources in <repo>/native/ are shared with the JAX package; the
port compiles them, with its own host C (minigraph_tpu_torch/csrc/*.c),
into <repo>/build/native/libmgt.so at first use (and again whenever a
source is newer than the library) and never writes into native/.  A
file lock serialises concurrent builds, and the library is written
under a temporary name and renamed into place, so parallel test
workers never load a half-written file.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO_ROOT / "native"
PORT_CSRC = REPO_ROOT / "minigraph_tpu_torch" / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "native"
SO_PATH = BUILD_DIR / "libmgt.so"

_lib = None


def _sources():
    # *_selftest.c is the standalone ASan harness, not library code
    return sorted(p for p in NATIVE_DIR.glob("*.c")
                  if not p.name.endswith("_selftest.c")) \
        + sorted(PORT_CSRC.glob("*.c"))


def _needs_build() -> bool:
    if not SO_PATH.exists():
        return True
    so_mtime = SO_PATH.stat().st_mtime
    return any(p.stat().st_mtime > so_mtime
               for p in [*NATIVE_DIR.glob("*.c"), *NATIVE_DIR.glob("*.h"),
                         *PORT_CSRC.glob("*.c")])


def build() -> Path:
    """Compile libmgt.so if it is missing or stale; return its path.

    -ffp-contract=off keeps every float multiply and add separately
    rounded, as the reference C build does (chain penalties, log2)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _needs_build():
            tmp = BUILD_DIR / f"libmgt.so.tmp{os.getpid()}"
            cmd = ["gcc", "-O3", "-march=native", "-funroll-loops",
                   "-ffp-contract=off", "-shared", "-fPIC", "-o", str(tmp),
                   *map(str, _sources()), "-lm", "-lpthread", "-lz"]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"native build failed:\n{r.stderr}")
            os.replace(tmp, SO_PATH)
    return SO_PATH


def get_lib():
    """The loaded native library (built on first use).  Raises when the
    build fails: the port has no pure-Python mapping tail."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.mgt_radix_argsort_u64.restype = None
        lib.mgt_radix_argsort_u64.argtypes = [u64p, u64p, ctypes.c_int64]
        lib.mgt_cuckoo_walk.restype = ctypes.c_int64
        lib.mgt_cuckoo_walk.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
        _lib = lib
    return _lib
