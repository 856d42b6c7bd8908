"""Banded dual-affine gap alignment scores (the score of mg_wfa_cmp's
gap alignments, galign.c:39-145, inside a band).

Port of the JAX package's ops/wfa_pallas.py: min-plus global alignment
with miniwfa's penalty model (mismatch x, a gap of length l costs
min(o1 + l*e1, o2 + l*e2)) of B (target, query) pairs, cells restricted
to the `wa` anti-diagonal band slots around the main diagonal.  It
equals the exact WFA score whenever the optimal path stays in the band;
otherwise it is the banded optimum, or -1 when the end cell lies
outside the band (|len(t) - len(q)| > wa - 2).

Both sequences carry a common sentinel at index 0 (t'[0] = q'[0] =
SENT, t'[i] = t[i-1]) and distinct pads past their ends; the virtual
cell (-1, -1) holds 0, so H(0, 0) = 0 and H(len t, len q) is the score.
Anti-diagonal k = i + j = 2m + P keeps band slot a at
i = m + P - wa/2 + a, j = m + wa/2 - a: the diagonal step stays in slot
a two planes back, the E step (i, j-1) comes from slot a + P and the F
step (i-1, j) from slot a + P - 1 of the previous plane, a slot shifted
in from beyond the band's edge being INF.

`banded_score_ref` is the plain PyTorch anti-diagonal loop over a
(B, wa) band; `banded_score_planes` launches the CUDA kernel
(csrc/wfa_banded.cu) for tensors on the card; `banded_score` is the
JAX package's entry point over a list of pairs.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

I32 = torch.int32
INF = 0x3F000000
SENT = 200          # common sentinel prefixed to both sequences
T_PAD, Q_PAD = 254, 255
KERNEL_WA = (32, 64, 96, 128)   # band widths of the kernel: wa/32 slots a lane


def encode_pairs(pairs: Sequence[Tuple[bytes, bytes]], device="cpu"):
    """(tseq, qseq, tl, ql): uint8 (B, L) sentinel-prefixed sequences
    (t'[0] = SENT, t'[1..tl] = t, T_PAD after; q' likewise with Q_PAD)
    with L = longest sequence + 1, and int32 (B,) lengths."""
    B = len(pairs)
    L = max((max(len(t), len(q)) for t, q in pairs), default=0) + 1
    ts = np.full((B, L), T_PAD, np.uint8)
    qs = np.full((B, L), Q_PAD, np.uint8)
    ts[:, 0] = qs[:, 0] = SENT
    tl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for b, (t, q) in enumerate(pairs):
        tl[b], ql[b] = len(t), len(q)
        ts[b, 1: 1 + len(t)] = np.frombuffer(t, np.uint8)
        qs[b, 1: 1 + len(q)] = np.frombuffer(q, np.uint8)
    return tuple(torch.from_numpy(a).to(device) for a in (ts, qs, tl, ql))


def _shift(x: torch.Tensor, sh: int) -> torch.Tensor:
    """new[:, a] = x[:, a + sh] (sh in {-1, 0, 1}); the slot shifted in
    from beyond the band's edge is INF."""
    if sh == 0:
        return x
    pad = torch.full_like(x[:, :1], INF)
    if sh == 1:
        return torch.cat([x[:, 1:], pad], 1)
    return torch.cat([pad, x[:, :-1]], 1)


def banded_score_ref(tseq, qseq, tl, ql, pens=(4, 4, 2, 15, 1),
                     wa: int = 32) -> torch.Tensor:
    """Plain PyTorch banded scores -> (B,) int32: H at the end cell,
    >= 1 << 28 when the end cell is outside the band or unreachable in
    it (INF-based)."""
    x, o1, e1, o2, e2 = (int(v) for v in pens)
    B, L = tseq.shape
    dev = tseq.device
    h = wa // 2
    a = torch.arange(wa, dtype=I32, device=dev)
    tl = tl.to(I32)[:, None]
    ql = ql.to(I32)[:, None]
    inf = torch.full((B, wa), INF, dtype=I32, device=dev)
    h1, e1s, f1s, e2s, f2s = inf, inf, inf, inf, inf
    h2 = torch.where(a == h, 0, inf)          # the virtual (-1, -1) = 0
    sc = inf
    tq = tseq.to(I32)
    qq = qseq.to(I32)
    n_k = int((tl + ql).max()) + 1 if B else 0
    for k in range(n_k):
        m, P = divmod(k, 2)
        iv = (m + P - h) + a
        jv = (m + h) - a
        tw = tq[:, iv.clamp(0, L - 1).long()]
        qw = qq[:, jv.clamp(0, L - 1).long()]
        sub = (tw != qw).to(I32) * x
        he, hf = _shift(h1, P), _shift(h1, P - 1)
        e1n = torch.minimum(_shift(e1s, P) + e1, he + (o1 + e1))
        e2n = torch.minimum(_shift(e2s, P) + e2, he + (o2 + e2))
        f1n = torch.minimum(_shift(f1s, P - 1) + e1, hf + (o1 + e1))
        f2n = torch.minimum(_shift(f2s, P - 1) + e2, hf + (o2 + e2))
        hn = torch.minimum(torch.minimum(torch.minimum(e1n, f1n),
                                         torch.minimum(e2n, f2n)),
                           h2 + sub)
        valid = (iv >= 0) & (jv >= 0) & (iv <= tl) & (jv <= ql)
        hn, e1n, f1n, e2n, f2n = (torch.where(valid, v, INF)
                                  for v in (hn, e1n, f1n, e2n, f2n))
        a_end = (tl - ql + (wa - P)) >> 1
        endm = ((tl + ql) == k) & (a == a_end)
        sc = torch.minimum(sc, torch.where(endm, hn, INF))
        h2, h1 = h1, hn
        e1s, f1s, e2s, f2s = e1n, f1n, e2n, f2n
    return sc.min(1).values


def banded_score_planes(tseq, qseq, tl, ql, pens=(4, 4, 2, 15, 1),
                        wa: int = 32) -> torch.Tensor:
    """Banded scores of encoded pairs: the plain version for CPU
    tensors, the CUDA kernel (csrc/wfa_banded.cu) for tensors on the
    card."""
    if tseq.device.type == "cpu":
        return banded_score_ref(tseq, qseq, tl, ql, pens, wa)
    if wa not in KERNEL_WA:
        raise ValueError(f"banded kernel band width must be one of "
                         f"{KERNEL_WA}, not {wa}")
    B, L = tseq.shape
    if qseq.shape != (B, L) or tseq.dtype != torch.uint8 \
            or qseq.dtype != torch.uint8 or tl.shape != (B,) \
            or ql.shape != (B,):
        raise ValueError("sequences must be (B, L) uint8, lengths (B,)")
    from .. import kernels
    out = torch.empty((B,), dtype=I32, device=tseq.device)
    x, o1, e1, o2, e2 = (int(v) for v in pens)
    kernels.launch("wfa_banded", tseq.contiguous(), qseq.contiguous(),
                   tl.to(I32).contiguous(), ql.to(I32).contiguous(), B, L,
                   int(wa), x, o1, e1, o2, e2, out)
    return out


def banded_score(pairs: List[Tuple[bytes, bytes]], pens=(4, 4, 2, 15, 1),
                 wa: int = 32, device="cuda") -> np.ndarray:
    """Batched banded dual-affine penalties; -1 where the end cell is
    outside the band.  Runs on the card unless `device` says otherwise,
    and raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("banded_score: no CUDA device available")
    if not pairs:
        return np.zeros(0, dtype=np.int32)
    s = banded_score_planes(*encode_pairs(pairs, dev), pens, wa).cpu().numpy()
    return np.where(s >= (1 << 28), -1, s).astype(np.int32)
