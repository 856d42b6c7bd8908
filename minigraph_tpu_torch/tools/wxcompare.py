"""Time the exact-WFA kernels (wfa_wave, wfa_walk) of several source
trees on one card, in turns, on the same inputs.

    python -m minigraph_tpu_torch.tools.wxcompare [--out DIR] [--reps N]
        TREE [TREE ...]

Each TREE is the root of a checkout of this repository (for example a
`git archive` of another commit unpacked into a directory).  This
process first writes the inputs into DIR with this checkout's package
and chip_smoke.py: the gap pairs of chip_smoke.py's phase 8 (d)
(`gap_pairs` on the 5 Mb reference, seed 52) and, for each of the -c
gap pool's two buckets, its first full chunk, encoded as the pool
encodes it, with the plain versions' outputs on the card (score,
end_d, no_ext; a digest of each pair's tb rows below its score; the
walk's ops, fin_i and fin_k).  Then each TREE, in the order given (e.g.
parent, change, change, parent), runs in a child process with TREE
first on sys.path: it builds that tree's kernels, runs its `wfa_device`
and `wfa_tb_walk` on the saved chunks, times each (CUDA events over
back-to-back calls, and replayed from a CUDA graph) and, where the tree
has a clock buffer, reads its columns.  This process then checks that
every run's outputs equal the plain versions' (tb below each score),
and prints one JSON line a run and the card's name and power limit
(tools/_treecompare.py runs the trees).  Needs one CUDA card; exits
non-zero without one.
"""
from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import torch

try:
    from . import _treecompare as tc
except ImportError:         # run as a script, as each tree's worker is
    import _treecompare as tc

ROOT = tc.ROOT
SEED = 52
OUT_KEYS = ("score", "end_d", "no_ext", "tb_digest", "ops", "fin_i",
            "fin_k")


def tb_digest(tb, score, s_cap):
    """One sha256 a pair over its tb rows below its score (all s_cap
    rows where the budget ran out), as a (B, 32) uint8 tensor."""
    sc = score.cpu()
    out = []
    for b in range(len(sc)):
        n = int(sc[b]) if sc[b] >= 0 else s_cap
        rows = tb[:n, b].cpu().numpy().tobytes()
        out.append(list(hashlib.sha256(rows).digest()))
    return torch.tensor(out, dtype=torch.uint8)


def make_inputs(work: Path) -> None:
    """chip_smoke.py's phase 8 (d) chunks and the plain versions'
    outputs on them."""
    sys.path.insert(0, str(ROOT))
    import numpy as np

    import chip_smoke as cs
    from minigraph_tpu_torch.align.cigar_device import BUCKETS, PENS
    from minigraph_tpu_torch.ops import wfa_exact as wx
    from minigraph_tpu_torch.tools.synth import make_reference
    ref = make_reference(5_000_000, seed=42)
    pairs = cs.gap_pairs(ref, np.random.default_rng(SEED), cs.WFA_PAIRS)
    sizes = [max(len(t), len(q)) for t, q in pairs]
    chunks = []
    for lo, (lmax, s_cap, bsz) in zip((0, BUCKETS[0][0]), BUCKETS):
        bp = [p for p, n in zip(pairs, sizes) if lo < n <= lmax][:bsz]
        enc = wx.encode_pairs(bp, L=lmax)
        cenc = [x.cuda() for x in enc]
        score, tb, _, end_d, no_ext = wx.wfa_device_ref(
            *cenc, PENS, d_cap=lmax, s_cap=s_cap)
        ops, fi, fk = wx.wfa_tb_walk_ref(*cenc, tb, score, end_d, no_ext,
                                         PENS, d_cap=lmax,
                                         t_cap=2 * lmax + 4)
        want = {"score": score, "end_d": end_d, "no_ext": no_ext,
                "tb_digest": tb_digest(tb, score, s_cap), "ops": ops,
                "fin_i": fi, "fin_k": fk}
        chunks.append({"enc": enc, "lmax": lmax, "s_cap": s_cap,
                       "want": {k: v.cpu() for k, v in want.items()}})
        del tb
    torch.save({"chunks": chunks, "pens": PENS}, work / "inputs.pt")


def clock_summary(clk, cols):
    """Each column's max and mean over the pairs, and the row of the
    pair with the most cycles (the launch waits for it)."""
    c = clk.cpu().to(torch.float64)
    top = int(c[:, cols.index("cycles")].argmax())
    return {"max": {n: int(c[:, i].max()) for i, n in enumerate(cols)},
            "mean": {n: round(float(c[:, i].mean()), 1)
                     for i, n in enumerate(cols)},
            "slowest": {n: int(c[top, i]) for i, n in enumerate(cols)}}


def worker(tree: Path, work: Path, tag: str, reps: int) -> dict:
    """One tree's run: its kernels on the saved chunks, timed, with its
    clock buffer's columns where it has one."""
    import inspect
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from minigraph_tpu_torch import kernels
    from minigraph_tpu_torch.ops import wfa_exact as wx
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{kernels.__file__} is not from {tree}")
    kernels.build()
    data = torch.load(work / "inputs.pt")
    pens = data["pens"]
    has_clock = "clock" in inspect.signature(wx.wfa_device).parameters
    rows, outs = [], []
    for ch in data["chunks"]:
        enc = [x.cuda() for x in ch["enc"]]
        lmax, s_cap = ch["lmax"], ch["s_cap"]
        t_cap = 2 * lmax + 4
        score, tb, _, end_d, no_ext = wx.wfa_device(*enc, pens, d_cap=lmax,
                                                    s_cap=s_cap)
        ops, fi, fk = wx.wfa_tb_walk(*enc, tb, score, end_d, no_ext, pens,
                                     d_cap=lmax, t_cap=t_cap)
        outs.append({"score": score.cpu(), "end_d": end_d.cpu(),
                     "no_ext": no_ext.cpu(),
                     "tb_digest": tb_digest(tb, score, s_cap),
                     "ops": ops.cpu(), "fin_i": fi.cpu(), "fin_k": fk.cpu()})

        def wave():
            wx.wfa_device(*enc, pens, d_cap=lmax, s_cap=s_cap, tb=tb)

        def walk():
            wx.wfa_tb_walk(*enc, tb, score, end_d, no_ext, pens,
                           d_cap=lmax, t_cap=t_cap)
        row = {"B": int(enc[0].shape[0]), "L": int(enc[0].shape[1]),
               "D": 2 * lmax + 1, "s_cap": s_cap,
               "max_score": int(score.max()),
               "wave_ms": cs.cuda_time(wave, reps),
               "wave_graph_ms": cs.graph_time(wave, reps),
               "walk_ms": cs.cuda_time(walk, reps),
               "walk_graph_ms": cs.graph_time(walk, reps)}
        if has_clock:
            B = row["B"]
            cw = torch.zeros((B, len(wx.WAVE_CLK)), dtype=torch.int64,
                             device="cuda")
            ck = torch.zeros((B, len(wx.WALK_CLK)), dtype=torch.int64,
                             device="cuda")
            wx.wfa_device(*enc, pens, d_cap=lmax, s_cap=s_cap, tb=tb,
                          clock=cw)
            wx.wfa_tb_walk(*enc, tb, score, end_d, no_ext, pens,
                           d_cap=lmax, t_cap=t_cap, clock=ck)
            row["wave_clock"] = clock_summary(cw, wx.WAVE_CLK)
            row["walk_clock"] = clock_summary(ck, wx.WALK_CLK)
            ckf = ck.to(torch.float64)
            row["walk_cycles_a_tb_read"] = round(
                float(ckf[:, 0].sum() / ckf[:, 2].sum().clamp(min=1)), 1)
            cyc = ck[:, 0].cpu()
            row["walk_cycles_a_step"] = round(
                float(cyc.sum() / ck[:, 1].cpu().sum().clamp(min=1)), 1)
        rows.append(row)
    torch.save(outs, work / f"out_{tag}.pt")
    return {"tree": str(tree), "run": tag, "clock": has_clock,
            "chunks": rows}


def check(results, work: Path) -> str:
    """Every run's outputs against the plain versions'."""
    data = torch.load(work / "inputs.pt")
    for i in range(len(results)):
        outs = torch.load(work / f"out_{i}.pt")
        for ch, got in zip(data["chunks"], outs):
            bad = [k for k in OUT_KEYS
                   if not torch.equal(got[k], ch["want"][k])]
            if bad:
                raise AssertionError(f"run {i} at L={ch['lmax']} differs "
                                     f"from the plain version: {bad}")
    return ("outputs equal to the plain versions' (score, end_d, no_ext, "
            "tb below each score, ops, fin_i, fin_k)")


def main(argv=None) -> int:
    return tc.main(argv, __file__, __doc__, make_inputs, worker, check)


if __name__ == "__main__":
    sys.exit(main())
