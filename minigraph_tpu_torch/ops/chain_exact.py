"""Exact-or-flag linear-chaining DP fill (mg_lchain_dp, lchain.c:165-207).

`lchain_dp_exact_win_ref` is the plain PyTorch port of the JAX
package's ops/chain_exact.py `lchain_dp_exact_win`; `lchain_dp_exact_win`
is the wrapper that launches the CUDA kernel (csrc/chain_exact.cu, the
counterpart of the Pallas kernel in ops/chain_exact_pallas.py) for
tensors on the card.

Semantics (see the JAX module's docstring for the proofs): each anchor
i scores the candidates of its window -- the W anchors before its tile
of T plus the tile rows before it -- with comput_sc (lchain.c:115-140);
the reference's max_skip early break is emulated by a conservative
count of skip-capable rows above the chosen predecessor, the max_ii
long-range candidate is applied when it fires under every possible
break, and a read whose result could differ from the reference's is
flagged (`sure` False) and re-run on the host.  The `sure` flag depends
on (window, tile); the result of a sure read does not.

Inputs are the front's anchor planes (ops/u32.py convention: u32 values
in int64 tensors): axh = rid<<1|rev, axl = tpos, ayh = ...|span,
ayl = qpos.  Outputs f, p are int32 (rows >= n_a hold f=0, p=-1), sure
is bool.
"""
from __future__ import annotations

import torch

from . import u32

I32 = torch.int32
NEG_BIG = -0x3FFFFFFF
_C1, _C2, _C3 = -0.34484843, 2.02466578, 0.67487759


def _mg_log2(x: torch.Tensor) -> torch.Tensor:
    """Bit-exact float32 fast log2 (mgpriv.h:63-71); valid for x >= 2."""
    i = u32.from_i32(x.to(torch.float32).view(I32))
    expo = ((i >> 23) & 255) - 128
    log2 = expo.to(torch.float32)
    zf = u32.as_i32((i & 0x807FFFFF) + (127 << 23)).view(torch.float32)
    f32 = torch.float32
    c1 = torch.tensor(_C1, dtype=f32, device=x.device)
    c2 = torch.tensor(_C2, dtype=f32, device=x.device)
    c3 = torch.tensor(_C3, dtype=f32, device=x.device)
    # one rounding per operation, as the reference's float32 C code
    return log2 + ((c1 * zf + c2) * zf - c3)


def _sc_valid(tp_i, qp_i, tp_j, qp_j, sp_j, mdx, mdy, bw, pen_gap,
              pen_skip):
    """comput_sc (lchain.c:115-140) over int32 planes -> (sc, valid)."""
    dq = qp_i - qp_j
    dr = tp_i - tp_j
    bad = (dq <= 0) | (dq > mdx) | (dr == 0) | (dq > mdy)
    dd = torch.abs(dr - dq)
    bad |= dd > bw
    dg = torch.minimum(dr, dq)
    sc = torch.minimum(sp_j, dg)
    f32 = torch.float32
    g = torch.tensor(pen_gap, dtype=f32, device=dd.device)
    s = torch.tensor(pen_skip, dtype=f32, device=dd.device)
    lin = g * dd.to(f32) + s * dg.to(f32)
    log_pen = torch.where(dd >= 1, _mg_log2((dd + 1).to(f32)),
                          torch.zeros((), dtype=f32, device=dd.device))
    pen = (lin + torch.tensor(0.5, dtype=f32, device=dd.device) * log_pen) \
        .to(I32)
    sc = sc - torch.where((dd != 0) | (dg > sp_j), pen, 0)
    return torch.where(bad, NEG_BIG, sc), ~bad


def _planes(axh, axl, ayh, ayl):
    """The kernel's view of the anchors: x-hi as u32 values, tpos/qpos
    as int32 bit patterns, span = ayh & 0xFF."""
    return (axh, axl, u32.as_i32(axl), u32.as_i32(ayl),
            (ayh & 0xFF).to(I32))


def _check(axh, axl, ayh, ayl, n_a, window, tile):
    B, A = axh.shape
    for t in (axl, ayh, ayl):
        if t.shape != (B, A) or t.dtype != torch.int64:
            raise ValueError("anchor planes must be (B, A) int64")
    if n_a.shape != (B,):
        raise ValueError("n_a must be (B,)")
    if A % tile:
        raise ValueError("anchor cap must be a multiple of the tile")


def lchain_dp_exact_win_ref(axh, axl, ayh, ayl, n_a, max_dist_x: int,
                            max_dist_y: int, bw: int, max_skip: int,
                            max_iter: int, pen_gap: float, pen_skip: float,
                            window: int = 1024, tile: int = 8):
    """Plain PyTorch windowed exact chain DP -> (f, p, sure).

    Step for step the JAX lchain_dp_exact_win: anchor i of tile i0
    sees the slice [i0 - W, i0 + T) of the left-padded planes."""
    _check(axh, axl, ayh, ayl, n_a, window, tile)
    B, N = axh.shape
    W, T = window, tile
    dev = axh.device
    xh, xl, tp, qp, sp = _planes(axh, axl, ayh, ayl)

    def lpad(a, fill):
        return torch.cat([torch.full((B, W), fill, dtype=a.dtype,
                                     device=dev), a], dim=1)

    xhp, xlp = lpad(xh, u32.U32MAX), lpad(xl, u32.U32MAX)
    tpp, qpp, spp = lpad(tp, -1), lpad(qp, -1), lpad(sp, 0xFF)
    f = torch.zeros((B, W + N), dtype=I32, device=dev)
    p = torch.full((B, W + N), -1, dtype=I32, device=dev)
    cnt = torch.zeros((B, W + N), dtype=I32, device=dev)
    max_ii = torch.full((B,), -1, dtype=I32, device=dev)
    f_mii = torch.zeros((B,), dtype=I32, device=dev)
    uncertain = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_a = n_a.to(I32).to(dev)
    col_iota = torch.arange(W + T, dtype=I32, device=dev)[None, :]
    n_steps = int(n_a.max()) if B else 0   # later steps write nothing
    for i0 in range(0, -(-n_steps // T) * T, T):
        sl = slice(i0, i0 + W + T)
        xhw, xlw, tpw = xhp[:, sl], xlp[:, sl], tpp[:, sl]
        qpw, spw = qpp[:, sl], spp[:, sl]
        fw, pw, cw = f[:, sl].clone(), p[:, sl].clone(), cnt[:, sl].clone()
        jg = i0 + col_iota - W            # global index of each column
        for t in range(T):
            i = i0 + t
            col = W + t
            active = i < n_a
            before = col_iota < col
            same_vx = xhw == xhw[:, col: col + 1]
            # u64 x-distance under a shared high word
            dx = xlw[:, col: col + 1] - xlw
            mask_dist = same_vx & (dx >= 0) & (dx <= max_dist_x) & before
            win = mask_dist & (jg >= i - max_iter)
            st_dist = i - mask_dist.sum(1).to(I32)
            st_win = i - win.sum(1).to(I32)
            # the reference window may reach below the slice: flag
            overflow = mask_dist[:, 0]

            sc, valid0 = _sc_valid(tpw[:, col: col + 1], qpw[:, col: col + 1],
                                   tpw, qpw, spw, max_dist_x, max_dist_y,
                                   bw, pen_gap, pen_skip)
            valid = valid0 & win
            sc_tot = torch.where(valid, sc + fw, NEG_BIG)
            q_span_i = spw[:, col]

            # full-window max; ties -> largest j (first processed)
            M = sc_tot.max(1).values
            idx = torch.where((sc_tot == M[:, None]) & valid, jg,
                              -1).max(1).values
            best = M > q_span_i

            # scan-free conservative break test
            marked = cw > 0
            splus = (valid & marked
                     & ~((jg == idx[:, None]) & best[:, None])).to(I32)
            cnt_above_idx = torch.where(jg > idx[:, None], splus, 0).sum(1)

            max_f = torch.where(best, M, q_span_i)
            max_j = torch.where(best, idx, -1)
            step_unc = (best & (cnt_above_idx > max_skip)) | overflow

            # max_ii long-range candidate (lchain.c:191-198)
            stale = (max_ii < 0) | (max_ii < st_dist)
            fmsk = torch.where(win, fw, NEG_BIG)
            Mf = fmsk.max(1).values
            idx_f = torch.where((fmsk == Mf[:, None]) & win, jg,
                                -1).max(1).values
            any_win = win.any(1)
            max_ii = torch.where(stale, torch.where(any_win, idx_f, -1),
                                 max_ii).to(I32)
            f_mii = torch.where(stale, torch.where(any_win, Mf, 0),
                                f_mii).to(I32)

            has_mii = max_ii >= 0
            mii_col = jg == max_ii[:, None]
            tmp = torch.where(mii_col & valid0, sc, NEG_BIG).max(1).values
            cand_ok = has_mii & (tmp > NEG_BIG)
            delta = cand_ok & (max_f < tmp + f_mii)
            fire_sure = has_mii & (max_ii < st_win - 1)
            cnt_above_mii = torch.where(jg > max_ii[:, None], splus,
                                        0).sum(1)
            fire_maybe = has_mii & ~fire_sure & (cnt_above_mii > max_skip)
            apply = fire_sure & delta
            step_unc |= fire_maybe & delta
            f_i = torch.where(apply, tmp + f_mii, max_f).to(I32)
            p_i = torch.where(apply, max_ii, max_j).to(I32)

            upd = (max_ii < 0) | (f_mii < f_i)
            max_ii = torch.where(active & upd, i, max_ii).to(I32)
            f_mii = torch.where(active & upd, f_i, f_mii)
            uncertain |= step_unc & active

            fw[:, col] = torch.where(active, f_i, fw[:, col])
            pw[:, col] = torch.where(active, p_i, pw[:, col])
            pcol = jg == torch.clamp(p_i, min=0)[:, None]
            cw += (pcol & (p_i >= 0)[:, None] & active[:, None]).to(I32)
        f[:, sl], p[:, sl], cnt[:, sl] = fw, pw, cw
    return f[:, W:], p[:, W:], ~uncertain


def lchain_dp_exact_win(axh, axl, ayh, ayl, n_a, max_dist_x: int,
                        max_dist_y: int, bw: int, max_skip: int,
                        max_iter: int, pen_gap: float, pen_skip: float,
                        window: int = 1024, tile: int = 8):
    """Exact chain DP: the plain version for CPU tensors, the CUDA
    kernel (csrc/chain_exact.cu) for tensors on the card."""
    if axh.device.type == "cpu":
        return lchain_dp_exact_win_ref(
            axh, axl, ayh, ayl, n_a, max_dist_x, max_dist_y, bw, max_skip,
            max_iter, pen_gap, pen_skip, window=window, tile=tile)
    _check(axh, axl, ayh, ayl, n_a, window, tile)
    from .. import kernels
    B, A = axh.shape
    if window + tile > 2048:
        raise ValueError("chain kernel window + tile must be <= 2048")
    dev = axh.device
    _, _, tp, qp, sp = _planes(axh, axl, ayh, ayl)
    xh = u32.as_i32(axh).contiguous()
    n_a32 = n_a.to(I32).contiguous()
    f = torch.empty((B, A), dtype=I32, device=dev)
    p = torch.empty((B, A), dtype=I32, device=dev)
    unc = torch.zeros((B,), dtype=I32, device=dev)
    kernels.launch("chain_exact", xh, tp.contiguous(), qp.contiguous(),
                   sp.contiguous(), n_a32, B, A, int(window), int(tile),
                   int(max_dist_x), int(max_dist_y), int(bw),
                   int(max_skip), int(max_iter), float(pen_gap),
                   float(pen_skip), f, p, unc)
    return f, p, unc == 0
