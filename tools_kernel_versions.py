"""Time other versions of the ring chain kernel (K4) and the banded
gap-score kernel (K7) against the port's own, in turns, on one NVIDIA
GPU, at the shapes chip_smoke.py drives them: K4 on the batched map
step's anchors (512 reads of 800-1900 bp off the 5 Mb bubble graph,
acap=512, window=32), K7 on 4096 gap pairs of 256-2048 bp at wa=32.

    python3 tools_kernel_versions.py --ring old_ring.cu --wfa old_wfa.cu

Each source must define the C entry point of its kernel with the
port's signature (mgt_cuda_chain_ring, mgt_cuda_wfa_banded), as any
revision of minigraph_tpu_torch/csrc/chain_ring.cu or wfa_banded.cu
does (for example `git show <rev>:minigraph_tpu_torch/csrc/chain_ring.cu
> old_ring.cu`); it is built with the port's nvcc flags and
minigraph_tpu_torch/csrc on the include path into build/versions/.
Every version must agree bitwise with the port's kernel on these
inputs, or the script fails.  Each is timed with CUDA events over
back-to-back launches and replayed from a CUDA graph, in the order
given and then in reverse (the first run of a pair warms nothing the
second uses).  Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from minigraph_tpu_torch import kernels  # noqa: E402
from minigraph_tpu_torch.ops import u32  # noqa: E402

OUT = REPO / "build" / "versions"
ENTRIES = {"ring": ("mgt_cuda_chain_ring", "pppppiiiiiiffpp"),
           "wfa": ("mgt_cuda_wfa_banded", "ppppiiiiiiiip")}
KIND = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
I32 = torch.int32


def bind(lib, which):
    entry, sig = ENTRIES[which]
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [KIND[c] for c in sig] + [ctypes.c_void_p]
    return fn


def build(src: Path):
    """Build one source into its own library; print ptxas' lines."""
    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / (src.stem + ".so")
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(kernels.CSRC), "-o", str(so), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "stack frame" in line or "registers" in line:
            print(f"  {src.name}: {line.strip()}")
    return ctypes.CDLL(str(so))


def launcher(fn, args):
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]

    def run():
        err = fn(*conv, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def ring_inputs():
    """Phase 5's anchors of chip_smoke.py: the hash join over the 5 Mb
    graph's index, 512 short reads padded to 2048."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.mapping.device_front import DeviceFront
    from minigraph_tpu_torch.ops.anchors import collect_anchors_hash
    from minigraph_tpu_torch.ops.sketch import encode_batch, sketch_planes
    from minigraph_tpu_torch.options import MapOptions
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa)
    OUT.mkdir(parents=True, exist_ok=True)
    ref = make_reference(5_000_000, seed=42)
    hap = write_bubble_rgfa(ref, 43, str(OUT / "mhc5m.gfa"))
    short = simulate_reads([hap], cs.STEP_B, seed=44, mean_len=1300,
                           min_len=800, max_len=1900)
    mo = MapOptions()
    gi = build_index(read_gfa(str(OUT / "mhc5m.gfa")), 17, 11, mo)
    front = DeviceFront(gi, mo, device="cuda")
    codes, lens = [torch.from_numpy(a).cuda() for a in encode_batch(
        [s for _, s in short], pad_to=cs.STEP_PAD)]
    sp = sketch_planes(codes, lens, gi.w, gi.k)
    kw = cs.STEP_KW
    axh, axl, ayh, ayl, n_a = collect_anchors_hash(
        front.ji, *sp[:6], 50, kw["occ_cap"], qcap=kw["qcap"],
        acap=kw["acap"])[:5]
    B, A = axh.shape
    planes = [u32.as_i32(axh).contiguous(), u32.as_i32(axl).contiguous(),
              u32.as_i32(ayl).contiguous(),
              (ayh & 0xFF).to(I32).contiguous(), n_a.to(I32).contiguous()]
    print(f"ring inputs ({B}, {A}): n_a mean {n_a.double().mean():.1f} "
          f"max {int(n_a.max())}")
    return ref, planes + [B, A, kw["window"], 5000, 5000, 500, 0.1827,
                          0.00913]


def compare(which, libs, args, outs, reps):
    """Check every version against the port's and time them in turns."""
    runs = {}
    for name, lib in libs.items():
        res = [torch.empty_like(o) for o in outs]
        runs[name] = launcher(bind(lib, which), args + res)
        runs[name]()
        torch.cuda.synchronize()
        if name == "port":
            ref = res
        elif not all(torch.equal(a, b) for a, b in zip(res, ref)):
            raise AssertionError(f"{which} {name} differs from the port's")
    print(f"{which}: {len(libs)} versions bitwise equal")
    names = list(libs)
    for name in names + names[::-1]:
        print(f"  {which} {name}: events {cs.cuda_time(runs[name], reps):.4f}"
              f" ms, graph {cs.graph_time(runs[name], reps):.4f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ring", nargs="*", default=[], type=Path)
    ap.add_argument("--wfa", nargs="*", default=[], type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("tools_kernel_versions: no CUDA device\n")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    kernels.build()
    port = ctypes.CDLL(str(kernels.SO_PATH))
    ref, ring_args = ring_inputs()
    B, A = ring_args[5], ring_args[6]
    libs = {"port": port, **{p.stem: build(p) for p in a.ring}}
    outs = [torch.empty((B, A), dtype=I32, device="cuda") for _ in range(2)]
    compare("ring", libs, ring_args, outs, 50)

    from minigraph_tpu_torch.ops.wfa_banded import encode_pairs
    pairs = cs.gap_pairs(ref, np.random.default_rng(50), cs.WFA_PAIRS)
    tseq, qseq, tl, ql = encode_pairs(pairs, "cuda")
    Bw, L = tseq.shape
    libs = {"port": port, **{p.stem: build(p) for p in a.wfa}}
    outs = [torch.empty((Bw,), dtype=I32, device="cuda")]
    for wa in (32, 64, 96, 128):
        print(f"wfa pairs ({Bw}, L={L}), wa={wa}")
        compare("wfa", libs, [tseq, qseq, tl, ql, Bw, L, wa, 4, 4, 2, 15,
                              1], outs, 20 if wa == 32 else 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
