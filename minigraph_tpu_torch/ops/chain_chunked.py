"""Chunked-walk exact-or-flag chain DP (mg_lchain_dp, lchain.c:149-219).

Port of the JAX package's ops/chain_chunked_pallas.py: the contract of
ops/chain_exact.py (f, p, sure; a sure read equals the reference), but
each anchor i scores only the top TOP rows of its window, [i - TOP, i),
and walks deeper BLK-row blocks while a bound says a deeper row could
still win: sc <= span <= 31, so a block whose prefix max of f (over the
frozen rows of the tile, for the vertex of the tile's first or last
anchor) is <= M - 31 cannot beat M.  Ties go to the larger row, so
stopping there is exact.  There is no max_ii candidate, which requires
max_iter >= W + T (the sureness test then proves the reference's scan
reached the full-window argmax).

`lchain_dp_chunked_ref` is the plain PyTorch version: the TPU kernel's
walk step by step over the read's rows, with the kernel's W + T row
buffer as the read's own rows behind W virtual rows of the buffer's
initial values, so that it equals the kernel on every read, sure or
not.  `lchain_dp_chunked` launches the CUDA kernel (csrc/chain_chunked.cu)
for tensors on the card.  Arguments and outputs as
ops/chain_exact.lchain_dp_exact_win.
"""
from __future__ import annotations

import torch

from . import u32
from .chain_exact import NEG_BIG, _check, _planes, _sc_valid

I32 = torch.int32
TOP = 128      # always-scored top rows (covers the tile's own rows, T <= TOP)
BLK = 64       # rows of a deep-walk block
MAX_WINDOW = 32 * BLK    # the kernel keeps one block maximum a lane


def _check_chunked(axh, axl, ayh, ayl, n_a, window, tile, max_iter):
    _check(axh, axl, ayh, ayl, n_a, window, tile)
    if window % BLK or window < TOP:
        raise ValueError(f"chunked chain window must be a multiple of {BLK}"
                         f" and >= {TOP}")
    if not 1 <= tile <= TOP:
        raise ValueError(f"chunked chain tile must be in [1, {TOP}]")
    if max_iter < window + tile:
        raise ValueError("iteration clamp would bind inside the buffer "
                         "(max_iter < window + tile): use the full-window "
                         "chain")


def lchain_dp_chunked_ref(axh, axl, ayh, ayl, n_a, max_dist_x: int,
                          max_dist_y: int, bw: int, max_skip: int,
                          max_iter: int, pen_gap: float, pen_skip: float,
                          window: int = 768, tile: int = 128,
                          walk: dict = None):
    """Plain PyTorch chunked-walk chain DP -> (f, p, sure).

    `walk`, when given, receives the rows this run evaluated over the
    active anchors: "top" (the top chunk's rows, capped at i) and
    "blocks" (deep blocks walked)."""
    _check_chunked(axh, axl, ayh, ayl, n_a, window, tile, max_iter)
    B, N = axh.shape
    W, T = window, tile
    dev = axh.device
    xh, _, tp, qp, sp = _planes(axh, axl, ayh, ayl)

    def lpad(a, fill):
        return torch.cat([torch.full((B, W), fill, dtype=a.dtype,
                                     device=dev), a], dim=1)

    # column W + j holds row j; the W columns before are the buffer's
    # initial rows
    xh, tp, qp, sp = lpad(xh, u32.U32MAX), lpad(tp, 0), lpad(qp, 0), \
        lpad(sp, 0)
    fb = torch.full((B, W + N), NEG_BIG, dtype=I32, device=dev)
    cnt = torch.zeros((B, W + N), dtype=I32, device=dev)
    f = torch.zeros((B, N), dtype=I32, device=dev)
    p = torch.full((B, N), -1, dtype=I32, device=dev)
    uncertain = torch.zeros((B,), dtype=torch.bool, device=dev)
    n_a = n_a.to(I32).to(dev)
    rows = torch.arange(B, device=dev)
    top_iota = torch.arange(TOP, dtype=I32, device=dev)[None, :]
    blk_iota = torch.arange(BLK, dtype=I32, device=dev)[None, :]
    top_rows = torch.zeros((), dtype=torch.int64, device=dev)
    blocks = torch.zeros((), dtype=torch.int64, device=dev)
    NB = W // BLK

    n_steps = int(n_a.max()) if B else 0
    for i in range(n_steps):
        t = i % T
        i0 = i - t
        if t == 0:
            # per-tile prefix block maxima of f over the frozen rows
            # [i0 - W, i0), masked to the tile's first and last vertex
            xh_first = xh[:, W + i0: W + i0 + 1]
            xh_last = xh[:, W + i0 + T - 1: W + i0 + T]
            xw, fw = xh[:, i0: i0 + W], fb[:, i0: i0 + W]
            pm = []
            for xv in (xh_first, xh_last):
                m = torch.where(xw == xv, fw, NEG_BIG)
                pm.append(torch.cummax(m.view(B, NB, BLK).amax(2), 1).values)
            pmf, pml = pm
        c = W + i
        xh_i, tp_i, qp_i = xh[:, c: c + 1], tp[:, c: c + 1], qp[:, c: c + 1]
        sp_i = sp[:, c]
        active = i < n_a

        def eval_rows(c0, n, jg, jcap):
            """comput_sc and the window masks over columns [c0, c0+n)."""
            sl = slice(c0, c0 + n)
            dx = (tp_i.to(torch.int64) - tp[:, sl].to(torch.int64)) \
                & 0xFFFFFFFF
            cand = (xh[:, sl] == xh_i) & (dx <= max_dist_x) & (jg < jcap)
            sc, ok = _sc_valid(tp_i, qp_i, tp[:, sl], qp[:, sl], sp[:, sl],
                               max_dist_x, max_dist_y, bw, pen_gap,
                               pen_skip)
            valid = ok & cand
            sc_tot = torch.where(valid, sc + fb[:, sl], NEG_BIG)
            splus = (valid & (cnt[:, sl] > 0)).to(I32)
            return sc_tot, valid, splus, cand

        def argmax(sc_tot, valid, jg):
            M = sc_tot.max(1).values
            idx = torch.where((sc_tot == M[:, None]) & valid, jg,
                              -1).max(1).values
            return M, idx

        # the window reaches below buffer row 0: flag
        dx0 = (tp_i[:, 0].to(torch.int64) - tp[:, i0].to(torch.int64)) \
            & 0xFFFFFFFF
        overflow = (xh[:, i0] == xh_i[:, 0]) & (dx0 <= max_dist_x)

        # ---- top chunk: rows [i - TOP, i)
        jg = (i - TOP) + top_iota
        sc_tot, valid, splus, cand = eval_rows(c - TOP, TOP, jg, i)
        M, idx = argmax(sc_tot, valid, jg)
        cnt_seen = splus.sum(1)
        cnt_above = torch.where(jg > idx[:, None], splus, 0).sum(1)
        going = cand[:, 0] & active
        top_rows += min(TOP, i) * active.sum()

        # ---- deep walk, from the block just below the top chunk down
        vmatch1 = xh_i[:, 0] == xh_first[:, 0]
        vmatch2 = xh_i[:, 0] == xh_last[:, 0]
        b = (W - TOP - 1 + t) // BLK          # floor, as the TPU's
        while b >= 0 and bool(going.any()):
            pm = torch.where(vmatch1, pmf[:, b],
                             torch.where(vmatch2, pml[:, b], 0x3FFFFFFF))
            going = going & (pm + 31 > M)
            blocks += going.sum()
            jg = (i0 - W + BLK * b) + blk_iota
            sc_b, val_b, sp_b, cand_b = eval_rows(i0 + BLK * b, BLK, jg,
                                                  i - TOP)
            g = going[:, None]
            m_b, i_b = argmax(torch.where(g, sc_b, NEG_BIG), val_b & g, jg)
            s_b = torch.where(g, sp_b, 0).sum(1)
            sa_b = torch.where(g & (jg > i_b[:, None]), sp_b, 0).sum(1)
            upd = going & (m_b > M)
            idx = torch.where(upd, i_b, idx)
            cnt_above = torch.where(upd, cnt_seen + sa_b, cnt_above)
            M = torch.where(upd, m_b, M)
            cnt_seen = cnt_seen + s_b
            going = going & cand_b[:, 0]
            b -= 1

        best = M > sp_i
        f_i = torch.where(best, M, sp_i).to(I32)
        p_i = torch.where(best, idx, -1).to(I32)
        uncertain |= ((best & (cnt_above > max_skip)) | overflow) & active
        f[:, i] = torch.where(active, f_i, 0)
        p[:, i] = torch.where(active, p_i, -1)
        fb[:, c] = torch.where(active, f_i, NEG_BIG)
        # child mark at the parent row
        child = (p_i >= 0) & active
        cnt[rows, W + torch.clamp(p_i, min=0).to(torch.int64)] += \
            child.to(I32)
    if walk is not None:
        walk["top"] = walk.get("top", 0) + int(top_rows)
        walk["blocks"] = walk.get("blocks", 0) + int(blocks)
    return f, p, ~uncertain


def lchain_dp_chunked(axh, axl, ayh, ayl, n_a, max_dist_x: int,
                      max_dist_y: int, bw: int, max_skip: int,
                      max_iter: int, pen_gap: float, pen_skip: float,
                      window: int = 768, tile: int = 128):
    """Chunked-walk chain DP: the plain version for CPU tensors, the CUDA
    kernel (csrc/chain_chunked.cu) for tensors on the card."""
    if axh.device.type == "cpu":
        return lchain_dp_chunked_ref(
            axh, axl, ayh, ayl, n_a, max_dist_x, max_dist_y, bw, max_skip,
            max_iter, pen_gap, pen_skip, window=window, tile=tile)
    _check_chunked(axh, axl, ayh, ayl, n_a, window, tile, max_iter)
    if window > MAX_WINDOW:
        raise ValueError(f"chunked chain kernel window must be <= "
                         f"{MAX_WINDOW}")
    from .. import kernels
    B, A = axh.shape
    dev = axh.device
    _, _, tp, qp, sp = _planes(axh, axl, ayh, ayl)
    xh = u32.as_i32(axh).contiguous()
    n_a32 = n_a.to(I32).contiguous()
    f = torch.empty((B, A), dtype=I32, device=dev)
    p = torch.empty((B, A), dtype=I32, device=dev)
    unc = torch.zeros((B,), dtype=I32, device=dev)
    kernels.launch("chain_chunked", xh, tp.contiguous(), qp.contiguous(),
                   sp.contiguous(), n_a32, B, A, int(window), int(tile),
                   int(max_dist_x), int(max_dist_y), int(bw),
                   int(max_skip), float(pen_gap), float(pen_skip), f, p,
                   unc)
    return f, p, unc == 0
