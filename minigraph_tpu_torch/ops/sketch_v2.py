"""Exact minimizer sketch of the v1 map step, with no sequential scan.

Port of the JAX package's ops/sketch_jax2.py `sketch_device_v2`, plain
PyTorch on whatever device `codes` lives on (the JAX version is an XLA
stage, not a Pallas kernel).  It returns the host sketch's records
(x = hash<<8|span, y = rid<<32|pos<<1|strand, sketch.c:56-109) in
emission order, truncated to `cap`, as u64 bit patterns in int64
tensors (ops/u64.py): U64MAX pads each row.

Key identity (sketch_jax2.py): the reference's "current minimum" after
event t is always the newest minimum of the last w events, so every
emission rule is a stateless per-event window computation:

  A-emit[t]   : x_t <= min(W[t-1]) and l_t >= w+k        -> emit prev min
  B-emit[t]   : otherwise, newest-argmin(W[t-1]) == t-w  -> emit prev min
  B-ties[t]   : events in W[t] tied with newest-argmin(W[t])
  FW-ties[t]  : at l_t == w+k-1, events in W[t]\\{t} tied with prev min
  final       : newest-min of the last window

where W[t] = events [t-w+1, t] (events: every in-range position except
strand-symmetric k-mers; ambiguous bases are U64MAX events).  Unlike the
position-aligned planes of ops/sketch.py (K1), which raise `overflow`
for a read with two ties at one position, this sketch emits such reads
exactly.

The JAX version compacts with stable argsorts (cheap on a TPU) and
packs flags into the top bits of one gather; here each compaction is a
cumsum and a scatter and each field is gathered on its own, which
selects the same elements in the same order.  Window minima run on the
order-preserving key x ^ (1 << 63), so U64MAX stays the largest value.
"""
from __future__ import annotations

import torch

from . import u32, u64

I64 = torch.int64
KEY_MAX = u64.INT64_MAX          # skey(U64MAX)


def _compact(values, mask, fill):
    """Per row, the masked elements moved to the front in order, `fill`
    after them (the JAX `_compact`)."""
    B, L = mask.shape
    rank = torch.cumsum(mask.to(I64), 1) - 1
    dst = torch.where(mask, rank, L)
    out = torch.full((B, L + 1), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_(1, dst, values.expand(B, L).contiguous())
    return out[:, :L]


def sketch_device_v2(codes: torch.Tensor, lens: torch.Tensor, w: int,
                     k: int, cap: int, rid: torch.Tensor = None):
    """Batched exact minimizer sketch.

    codes (B, L) uint8 nt4 (4 = ambiguous), lens (B,) int32, rid (B,)
    u64 record ids (default 0).  Returns (x, y, n): (B, min(cap,
    2wL + 1)) int64 u64 records and (B,) int32 emission counts, capped
    at cap."""
    if not 2 * k <= 56:
        raise ValueError("k too large for the 64-bit minimizer record")
    B, L = codes.shape
    dev = codes.device
    code = codes.to(I64)
    n_len = lens.to(I64)[:, None]
    if rid is None:
        rid = torch.zeros(B, dtype=I64, device=dev)
    mask2k = (1 << (2 * k)) - 1
    pos = torch.arange(L, device=dev)[None, :]
    in_range = pos < n_len
    valid = (code < 4) & in_range

    # ---- registers over the valid subsequence (the C registers skip
    # ambiguous bases but persist across them)
    vidx = torch.cumsum(valid.to(I64), 1) - 1
    cvalid = pos < valid.sum(1, keepdim=True)
    cc = _compact(code, valid, 0)
    kf = torch.zeros((B, L), dtype=I64, device=dev)
    kr = torch.zeros((B, L), dtype=I64, device=dev)
    for d in range(k):
        cd = cc if d == 0 else torch.cat(
            [torch.zeros((B, d), dtype=I64, device=dev), cc[:, :L - d]], 1)
        kf = kf | (cd << (2 * d))
        kr = kr | torch.where(pos >= d, (3 ^ cd) << (2 * (k - 1 - d)), 0)
    kf = kf & mask2k
    sym_c = cvalid & (kf == kr)
    zc = kf >= kr
    canon_c = torch.where(zc, kr, kf)
    at = torch.clamp(vidx, min=0)
    sym = valid & torch.gather(sym_c, 1, at)
    z = torch.gather(zc, 1, at)
    canon = torch.gather(canon_c, 1, at)

    # ---- event stream: every in-range position except symmetric ones
    is_event = in_range & ~sym
    n_ev = is_event.sum(1)
    e_amb = _compact(~valid & in_range, is_event, False)
    e_z = _compact(z, is_event, False)
    e_pos = _compact(pos, is_event, 0)
    e_canon = _compact(canon, is_event, 0)
    t = pos
    in_ev = t < n_ev[:, None]
    # l[t]: events since the last ambiguous event (which has l = 0)
    last_amb = torch.cummax(torch.where(e_amb, t, -1), 1).values
    ln = torch.where(last_amb >= 0, t - last_amb, t + 1)
    span = torch.clamp(ln, max=k)
    has_info = in_ev & ~e_amb & (ln >= k)
    ex = torch.where(has_info, (u32.hash64(e_canon, mask2k) << 8) | span,
                     u64.U64MAX)
    ey = torch.where(has_info, (rid[:, None] << 32)
                     | (((e_pos << 1) | e_z.to(I64)) & 0xFFFFFFFF),
                     u64.U64MAX)
    kx = u64.skey(ex)

    # ---- windowed views, padded with w virtual U64MAX events:
    # wx[t, j] = event t - w + 1 + j
    px = torch.cat([torch.full((B, w), KEY_MAX, dtype=I64, device=dev),
                    kx], 1)
    py = torch.cat([torch.full((B, w), u64.U64MAX, dtype=I64, device=dev),
                    ey], 1)
    wx = px.unfold(1, w, 1)[:, 1:L + 1]
    wy = py.unfold(1, w, 1)[:, 1:L + 1]
    mval = wx.min(2).values
    eqm = wx == mval[..., None]
    jr = torch.arange(w, device=dev)
    last_j = torch.where(eqm, jr, -1).max(2).values   # newest argmin
    m_ev = t - w + 1 + last_j
    m_y = torch.gather(wy, 2, last_j[..., None]).squeeze(2)

    # state before event t = state after t - 1
    def prev(a, first):
        return torch.cat([torch.full((B, 1), first, dtype=a.dtype,
                                     device=dev), a[:, :-1]], 1)

    pmv, pmy, pme = prev(mval, KEY_MAX), prev(m_y, u64.U64MAX), \
        prev(m_ev, -1)
    a_cond = kx <= pmv
    b_cond = in_ev & ~a_cond & (pme == t - w)
    has_prev = pmv != KEY_MAX
    emit_a = in_ev & a_cond & (ln >= w + k) & has_prev
    emit_b = b_cond & (ln >= w + k - 1) & has_prev
    # B rescan ties: events in W[t] equal to the new minimum
    b_ties = (b_cond & (ln >= w + k - 1) & (mval != KEY_MAX))[..., None] \
        & eqm & (wy != m_y[..., None])
    # first-window ties: W[t] minus the newest slot, against the previous
    # minimum
    fw = in_ev & (ln == w + k - 1) & has_prev
    fw_ties = fw[..., None] & (wx[..., :-1] == pmv[..., None]) \
        & (wy[..., :-1] != pmy[..., None])

    # ---- emission slots, per t: [fw ties (w-1), A/B old (1), B ties
    # (w)], then the final emission
    S = 2 * w
    em = torch.cat([fw_ties, (emit_a | emit_b)[..., None], b_ties],
                   2).reshape(B, L * S)
    last = torch.clamp(n_ev - 1, min=0)[:, None]
    lastv = torch.where(n_ev[:, None] > 0, torch.gather(mval, 1, last),
                        KEY_MAX)
    lasty = torch.where(n_ev[:, None] > 0, torch.gather(m_y, 1, last),
                        u64.U64MAX)
    em = torch.cat([em, lastv != KEY_MAX], 1)
    n_slot = L * S + 1
    cur = em.sum(1)
    ncol = min(cap, n_slot)
    rank = torch.cumsum(em.to(I64), 1) - 1
    put = em & (rank < ncol)
    order = torch.zeros((B, ncol + 1), dtype=I64, device=dev)
    order.scatter_(1, torch.where(put, rank, ncol),
                   torch.arange(n_slot, device=dev).expand(B, n_slot)
                   .contiguous())
    order = order[:, :ncol]
    keep = torch.arange(ncol, device=dev)[None, :] \
        < torch.clamp(cur, max=ncol)[:, None]
    o_t = order // S
    o_slot = order % S
    is_fin = order == L * S
    is_old = o_slot == w - 1
    # window position of a tie slot: fw ties j = slot, B ties j = slot-w
    j_win = torch.where(o_slot < w - 1, o_slot, o_slot - w)
    u = torch.clamp(o_t + 1 + j_win, 0, L + w - 1)
    vx = torch.gather(px, 1, u)
    vy = torch.gather(py, 1, u)
    o_tc = torch.clamp(o_t, 0, L - 1)
    vx = torch.where(is_old, torch.gather(pmv, 1, o_tc), vx)
    vy = torch.where(is_old, torch.gather(pmy, 1, o_tc), vy)
    vx = torch.where(is_fin, lastv, vx)
    vy = torch.where(is_fin, lasty, vy)
    outx = torch.where(keep, u64.skey(vx), u64.U64MAX)
    outy = torch.where(keep, vy, u64.U64MAX)
    return outx, outy, torch.clamp(cur, max=cap).to(torch.int32)
