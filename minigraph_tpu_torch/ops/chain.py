"""Ring-buffer linear-chaining DP (comput_sc, lchain.c:114-139) of the
batched map step.

`lchain_dp_tiled_ref` is the plain PyTorch port of the JAX package's
ops/chain_jax.py `lchain_dp_tiled` on u32 anchor planes;
`lchain_dp_planes` is the wrapper of ops/chain_pallas.py
`lchain_dp_pallas_planes` (`chain_planes_traced`): the plain version
for CPU tensors, the CUDA kernel (csrc/chain_ring.cu, the counterpart
of the Pallas kernel `_make_kernel` there) for tensors on the card.

Semantics, shared by both JAX versions: anchor i scores the W anchors
before it (the ring of the Pallas kernel holds exactly those).  A
predecessor j is refused ("bad") when dq = qpos_i - qpos_j is <= 0 or
above max_dist_x or max_dist_y (both limits test dq, not dr), when
dr = tpos_i - tpos_j is 0, when |dr - dq| > bw, when the key
rid<<1|rev differs, or when j lies before the read's first anchor (a
ring slot never written).  best = max over the rest of sc + f_j; the
predecessor is the smallest anchor index among equal maxima; the anchor
extends it when best > span_i.  Anchors i >= n_a get f = NEG_BIG and
p = -1 (unlike the exact chain, which writes 0 there).  Nothing here
flags a read: this chain explores a window, not the reference's scan.

Inputs are the collectors' anchor planes (ops/u32.py convention: u32
values in int64 tensors): axh = rid<<1|rev, axl = tpos, ayh = ...|span,
ayl = qpos.  Outputs f, p are (B, A) int32.
"""
from __future__ import annotations

import math

import torch

from . import u32
from .chain_exact import NEG_BIG, _sc_valid

I32 = torch.int32
MAX_WINDOW = 256   # the kernel keeps at most 8 ring slots per lane


def _check(axh, axl, ayh, ayl, n_a, window, tile):
    B, A = axh.shape
    for t in (axl, ayh, ayl):
        if t.shape != (B, A) or t.dtype != torch.int64:
            raise ValueError("anchor planes must be (B, A) int64")
    if n_a.shape != (B,):
        raise ValueError("n_a must be (B,)")
    if window < 1:
        raise ValueError("chain window must be >= 1")
    if tile < 1 or A % tile:
        raise ValueError(f"anchor capacity {A} must be a multiple of the "
                         f"chain tile {tile}")


def lchain_dp_tiled_ref(axh, axl, ayh, ayl, n_a, max_dist_x: int,
                        max_dist_y: int, bw: int, pen_gap: float,
                        pen_skip: float, window: int = 64, tile: int = 16):
    """Plain PyTorch ring-buffer chain DP -> (f, p), (B, A) int32.

    The transition scores do not depend on f, so they are computed for
    every (anchor, window row) pair at once; only the max-plus step
    runs anchor by anchor.  `tile` only has to divide A: the result
    does not depend on it (the JAX versions take it for their loops)."""
    _check(axh, axl, ayh, ayl, n_a, window, tile)
    B, A = axh.shape
    W = window
    dev = axh.device
    n_a = n_a.to(I32).to(dev)
    f = torch.full((B, A), NEG_BIG, dtype=I32, device=dev)
    p = torch.full((B, A), -1, dtype=I32, device=dev)
    n_steps = int(n_a.max()) if B else 0   # later anchors are dead
    if n_steps == 0:
        return f, p
    n_steps = min(n_steps, A)

    def lpad(a, fill):
        return torch.cat([torch.full((B, W), fill, dtype=a.dtype,
                                     device=dev), a[:, :n_steps]], dim=1)

    # window row c of anchor i is anchor j = i - W + c (oldest first)
    def windows(a):
        return a.unfold(1, W, 1)[:, :n_steps]          # (B, n, W)

    xh = axh[:, :n_steps]
    tp, qp = u32.as_i32(axl[:, :n_steps]), u32.as_i32(ayl[:, :n_steps])
    sp = (ayh[:, :n_steps] & 0xFF).to(I32)
    xh_w = windows(lpad(axh, -1))
    tp_w = windows(lpad(u32.as_i32(axl), 0))
    qp_w = windows(lpad(u32.as_i32(ayl), 0))
    sp_w = windows(lpad((ayh & 0xFF).to(I32), 0))
    sc, ok = _sc_valid(tp[..., None], qp[..., None], tp_w, qp_w, sp_w,
                       max_dist_x, max_dist_y, bw, pen_gap, pen_skip)
    j_w = windows(torch.arange(-W, n_steps, device=dev)
                  .expand(B, W + n_steps))
    ok = ok & (xh_w == xh[..., None]) & (j_w >= 0)

    fbuf = torch.full((B, W + n_steps), NEG_BIG, dtype=I32, device=dev)
    big = torch.iinfo(I32).max
    for i in range(n_steps):
        tot = torch.where(ok[:, i], sc[:, i] + fbuf[:, i: i + W], NEG_BIG)
        best = tot.max(1).values
        pred = torch.where(tot == best[:, None], j_w[:, i].to(I32),
                           big).min(1).values
        alive = i < n_a
        use = (best > sp[:, i]) & alive
        f_i = torch.where(alive, torch.where(use, best, sp[:, i]), NEG_BIG)
        fbuf[:, W + i] = f_i
        f[:, i] = f_i
        p[:, i] = torch.where(use, pred, -1)
    return f, p


def lchain_dp_planes(axh, axl, ayh, ayl, n_a, maxdx: int = 5000,
                     maxdy: int = 5000, bw: int = 500,
                     pen_gap: float = 0.1827, pen_skip: float = 0.00913,
                     window: int = 32, tile: int = 256):
    """Chain DP on anchor planes: the plain version for CPU tensors, the
    CUDA kernel (csrc/chain_ring.cu) for tensors on the card, where the
    window may be at most MAX_WINDOW."""
    if axh.device.type == "cpu":
        return lchain_dp_tiled_ref(axh, axl, ayh, ayl, n_a, maxdx, maxdy, bw,
                                   pen_gap, pen_skip, window=window,
                                   tile=tile)
    _check(axh, axl, ayh, ayl, n_a, window, tile)
    if window > MAX_WINDOW:
        raise ValueError(f"chain kernel window must be <= {MAX_WINDOW}")
    from .. import kernels
    B, A = axh.shape
    dev = axh.device
    f = torch.empty((B, A), dtype=I32, device=dev)
    p = torch.empty((B, A), dtype=I32, device=dev)
    kernels.launch("chain_ring", u32.as_i32(axh).contiguous(),
                   u32.as_i32(axl).contiguous(), u32.as_i32(ayl).contiguous(),
                   (ayh & 0xFF).to(I32).contiguous(),
                   n_a.to(I32).contiguous(), B, A, int(window), int(maxdx),
                   int(maxdy), int(bw), float(pen_gap), float(pen_skip), f, p)
    return f, p


def lchain_dp_device(ax, ay, n_a, max_dist_x: int = 5000,
                     max_dist_y: int = 5000, bw: int = 500,
                     chn_pen_gap: float = 0.1827,
                     chn_pen_skip: float = 0.00913, window: int = 64):
    """Banded chain DP on u64 anchors (the contract of ops/chain_jax.py
    `lchain_dp_device`, the v1 map step's chain) -> (f, p), (B, A) int32.

    ax, ay: (B, A) u64 anchors as int64 bit patterns (ops/u64.py), sorted
    by x, padded with U64MAX.  The JAX package documents its
    `lchain_dp_tiled` as giving "identical results" to this scan; K4
    (csrc/chain_ring.cu) computes that one on the anchors' u32 planes,
    so this splits the records into the planes and calls
    `lchain_dp_planes`: the kernel on the card, the plain version on the
    CPU.  The tile only has to divide A (the result does not depend on
    it)."""
    from . import u64
    A = ax.shape[1]
    tile = math.gcd(A, 256) if A else 1
    return lchain_dp_planes(u64.srl(ax, 32), ax & u32.U32MAX,
                            u64.srl(ay, 32), ay & u32.U32MAX, n_a,
                            max_dist_x, max_dist_y, bw, chn_pen_gap,
                            chn_pen_skip, window=window, tile=tile)
