"""Build, load and launch the port's hand-written CUDA kernels.

Each source in csrc/ has plain C entry points (one per registered
kernel) that launch their kernels on a given stream and return
cudaGetLastError().  The sources are compiled on the machine with the
card -- one nvcc per source, all started together -- and linked into
build/kernels/libmgt_cuda.so, which is loaded with ctypes at first use
(nothing is built or loaded when this module is imported).

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
         -std=c++17 -Xcompiler -fPIC -c csrc/<name>.cu
    nvcc -shared -o build/kernels/libmgt_cuda.so *.o

--fmad=false keeps every float multiply and add separately rounded:
the chain penalty and the fast log2 must round as the reference does.
A kernel that fuses where fusing is exact spells it out (__fmaf_rn in
probe.cu, whose products and partial sums are integers below 2^24).

`launches` counts kernel launches per kernel; `launch` adds one each
time it starts a kernel, and the device front adds, each time it
replays a captured step (mapping/device_front.py), the launches that
step's capture made, so a run can show that its main path went through
the kernels.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
SO_PATH = BUILD_DIR / "libmgt_cuda.so"
ARCH = "arch=compute_90a,code=sm_90a"
NVCC_FLAGS = ["-gencode", ARCH, "-O3", "--fmad=false", "-std=c++17",
              "-Xcompiler", "-fPIC"]

# name -> (source, C entry point, argument kinds); p = tensor pointer,
# i = int, f = float.  Every entry takes the stream as its last argument.
KERNELS = {
    "sketch": ("sketch.cu", "mgt_cuda_sketch_planes", "ppiiiipppppppp"),
    "chain_exact": ("chain_exact.cu", "mgt_cuda_chain_exact",
                    "pppppiiiiiiiiiffppp"),
    "chain_chunked": ("chain_chunked.cu", "mgt_cuda_chain_chunked",
                      "pppppiiiiiiiiffppp"),
    "chain_ring": ("chain_ring.cu", "mgt_cuda_chain_ring",
                   "pppppiiiiiiffpp"),
    "probe_bucketed": ("probe.cu", "mgt_cuda_probe_bucketed", "pppiiiiippp"),
    "probe_flat": ("probe.cu", "mgt_cuda_probe_flat", "pppiiiippp"),
    "wfa_banded": ("wfa_banded.cu", "mgt_cuda_wfa_banded", "ppppiiiiiiiip"),
    "backtrack": ("backtrack.cu", "mgt_cuda_backtrack_compact",
                  "p" * 7 + "i" * 7 + "p" * 11),
    "wfa_wave": ("wfa_exact.cu", "mgt_cuda_wfa_wave",
                 "pppp" + "i" * 12 + "ppppp"),
    "wfa_walk": ("wfa_exact.cu", "mgt_cuda_wfa_walk",
                 "p" * 8 + "i" * 10 + "pppp"),
    "gwfa": ("gwfa.cu", "mgt_cuda_gwfa", "p" * 13 + "i" * 12 + "pp"),
}

launches = {name: 0 for name in KERNELS}

_lib = None
# what the last build printed (nvcc -Xptxas -v: registers, spills)
build_log = ""


def loaded() -> bool:
    """Whether the kernel library is built and loaded in this process."""
    return _lib is not None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _stale() -> bool:
    if not SO_PATH.exists():
        return True
    t = SO_PATH.stat().st_mtime
    return any(p.stat().st_mtime > t for p in CSRC.glob("*.cu*"))


def build() -> float:
    """Compile and link libmgt_cuda.so if missing or stale.  Returns the
    seconds spent (0 when the library was up to date)."""
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return 0.0
        nvcc = _nvcc()
        procs = []
        for src in sorted({src for src, _, _ in KERNELS.values()}):
            obj = BUILD_DIR / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                   str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, objs = [], []
        for src, obj, pr in procs:
            out, _ = pr.communicate()
            logs.append(f"== {src}\n{out}")
            if pr.returncode != 0:
                for _, _, other in procs:
                    if other.poll() is None:
                        other.kill()
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
            objs.append(str(obj))
        tmp = BUILD_DIR / f"libmgt_cuda.so.tmp{os.getpid()}"
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp), *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{r.stderr}")
        os.replace(tmp, SO_PATH)
        build_log = "\n".join(logs)
    return time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(SO_PATH))
        kind = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                "f": ctypes.c_float}
        for _, entry, sig in KERNELS.values():
            fn = getattr(lib, entry)
            fn.restype = ctypes.c_int
            fn.argtypes = [kind[c] for c in sig] + [ctypes.c_void_p]
        _lib = lib
    return _lib


def bind(name: str, *args):
    """Kernel `name`'s launch with its arguments converted: a function of
    no arguments that starts the kernel on the stream that was current
    here, counts it and raises if the launch fails.  Tensor arguments
    must already be on the card, contiguous and of the kernel's type
    (the ops wrappers check that); None passes a null pointer.  A caller
    that times the launch alone records its first event after binding,
    so that the conversion (Python, which waits for the GIL under other
    threads) stays outside the window."""
    _, entry, sig = KERNELS[name]
    if len(args) != len(sig):
        raise TypeError(f"{name}: expected {len(sig)} arguments")
    conv = []
    for a, kind in zip(args, sig):
        if kind == "p" and a is None:
            conv.append(None)
        elif kind == "p":
            if not (a.is_cuda and a.is_contiguous()):
                raise ValueError(f"{name}: tensors must be contiguous on "
                                 "the card")
            conv.append(a.data_ptr())
        else:
            conv.append(a)
    conv.append(torch.cuda.current_stream().cuda_stream)
    fn = getattr(_load(), entry)

    def call() -> None:
        err = fn(*conv)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        launches[name] += 1
    return call


def launch(name: str, *args) -> None:
    """Launch kernel `name` on the current stream (`bind`, then call)."""
    bind(name, *args)()
