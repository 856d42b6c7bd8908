"""Exact chain backtrack + compaction on device tensors.

Port of the JAX package's ops/backtrack_jax.py `backtrack_compact`
(native/mgt_lchain.c mgt_chain_backtrack_core + compact_a, reference
lchain.c mg_chain_backtrack semantics).  The semantics, flags and the
per-lane SIMD interpreter are the JAX module's, step for step; see its
docstring for why each flag exists:

  * candidates = anchors with f >= min_sc, taken in (f, index) order
    from the top; ties are ordered by larger index first and a read is
    flagged whenever an equal-f pair could have interacted (the
    reference's radix sort is not stable);
  * peak-cut walk with speculative claims and an undo back to the cut;
  * chains failing min_cnt/min_sc are dropped but keep their claims;
  * compaction by first-anchor x (ties keep build order; a first-anchor
    x tie between two kept chains is flagged).

The claimer's chain-start f is packed into 15 bits of one int32 word
per anchor (bits [0..13] p+1, 14 claimed, 15 chain start, 16 visited,
[17..31] start-f low 15 bits), exactly as the JAX version packs it, so
the equal-f tie tests flag the same reads.

The plain version, `backtrack_compact_ref`, runs in three steps:

  (a) the candidate order: a stable sort of (f, index) and its inverse
      permutation (`candidate_order`; the JAX version sorts outside
      any kernel too);
  (b) the walk, the per-lane state machine (`walk_ref`);
  (c) the flags that read the walk's final planes and the compaction
      by first-anchor x.

On tensors on the card, `backtrack_compact` makes one launch of the
fused CUDA kernel csrc/backtrack.cu instead (one block a read: the
sort, the walk, the flags and the compaction in shared memory), with
the plain version's outputs, bitwise.

Where the JAX version reads plane[b, j[b]] with a one-hot reduction,
the plain walk gathers (torch.gather), with j < 0 reading 0.  It runs
in fixed chunks of interpreter steps and asks the device whether every
lane is done only between chunks, so the host waits once per chunk and
not once per step.  Lanes that are done do not change, so running a
chunk past the last live lane changes nothing.
"""
from __future__ import annotations

import torch

I32 = torch.int32
PK_P = 0x3FFF
PK_CLAIMED = 1 << 14
PK_START = 1 << 15
PK_VIS = 1 << 16
F15 = 0x7FFF
INT_MAX = 0x7FFFFFFF
INT64_MAX = (1 << 63) - 1
CHUNK = 64   # interpreter steps between "all lanes done" checks


def _take(plane, j):
    """plane[b, j[b]] per lane; j < 0 (or j >= A) reads 0."""
    A = plane.shape[1]
    ok = (j >= 0) & (j < A)
    v = torch.gather(plane, 1, torch.clamp(j, 0, A - 1).long()[:, None])[:, 0]
    return torch.where(ok, v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _put(plane, j, val, cond):
    """plane[b, j[b]] = val[b] where cond[b] (j valid there)."""
    A = plane.shape[1]
    jj = torch.clamp(j, 0, A - 1).long()[:, None]
    old = torch.gather(plane, 1, jj)[:, 0]
    plane.scatter_(1, jj, torch.where(cond, val, old)[:, None])


def candidate_order(f, n_a, min_sc: int):
    """Step (a): candidates (live anchors with f >= min_sc), their
    ascending (f, index) order s_idx, its inverse permutation r_of (the
    rank of each anchor) and the candidate count n_z, per lane."""
    B, A = f.shape
    dev = f.device
    idx = torch.arange(A, dtype=I32, device=dev)[None, :]
    live = idx < n_a[:, None]
    cand = live & (f >= min_sc)
    # ascending (f, index) order; non-candidates sort last with +INF
    key = torch.where(cand, f, INT_MAX)
    # stable sort on f keeps equal keys in index order: the explicit
    # (f, index) two-key sort of the JAX version
    s_idx = torch.sort(key, dim=1, stable=True).indices
    s_idx = s_idx.to(I32).contiguous()
    n_z = cand.sum(1).to(I32)
    # inverse permutation: rank of anchor a in the candidate order
    r_of = torch.empty_like(s_idx)
    r_of.scatter_(1, s_idx.long(), idx.expand(B, A).contiguous())
    return cand, s_idx, r_of, n_z


def walk_ref(f, p, s_idx, r_of, n_z, min_cnt: int, min_sc: int,
             max_drop: int, ucap: int, max_steps: int):
    """Step (b), the plain version: every lane's state machine (modes
    0 select, 1 walk, 2 undo, 3 done), one step of each live lane per
    iteration, at most max_steps steps a lane.  Returns a dict:
      pk: (B, A) the final packed plane (p+1, claim bits, claimer f)
      vbuf: (B, A) anchor indices of the kept chains, in build order
      u_sc/u_cnt: (B, ucap) chain score / anchor count, build order
      n_u, n_v: (B,) chains and anchors kept
      unsure: (B,) bool, an equal-f tie hit, > ucap chains or the step
        budget exhausted
      steps: (B,) the steps each lane took"""
    B, A = f.shape
    dev = f.device
    idx = torch.arange(A, dtype=I32, device=dev)[None, :]
    zeros = torch.zeros(B, dtype=I32, device=dev)
    mode = torch.where(n_z > 0, 0, 3).to(I32)
    k = n_z - 1
    pk_at = zeros.clone()
    best_s = zeros.clone()
    best_at = zeros.clone()
    best_pos = zeros.clone()
    sc0 = zeros.clone()
    cut = zeros.clone()
    nv0 = zeros.clone()
    lane_steps = zeros.clone()
    pk = (p.to(I32) + 1).contiguous()
    claimed_k = (idx >= n_z[:, None]).contiguous()
    vbuf = torch.zeros((B, A), dtype=I32, device=dev)
    u_sc = torch.zeros((B, ucap), dtype=I32, device=dev)
    u_cnt = torch.zeros((B, ucap), dtype=I32, device=dev)
    n_u = zeros.clone()
    n_v = zeros.clone()
    unsure = torch.zeros(B, dtype=torch.bool, device=dev)
    ur_oh = torch.arange(ucap, dtype=I32, device=dev)[None, :]

    def finish_chain(fin, cutv, nv_keep, nv_cur):
        cut_root = cutv < 0
        sc = torch.where(cut_root, sc0, sc0 - _take(f, cutv))
        cnt = nv_keep - nv0
        acc = fin & (sc >= min_sc) & (cnt >= min_cnt) & (cnt > 0)
        over_u = acc & (n_u >= ucap)
        put = acc & ~over_u
        w_u = (ur_oh == n_u[:, None]) & put[:, None]
        new_u_sc = torch.where(w_u, sc[:, None], u_sc)
        new_u_cnt = torch.where(w_u, cnt[:, None], u_cnt)
        nu = torch.where(put, n_u + 1, n_u)
        # reject: rewind v (claims stay, lchain.c:63-66)
        nvn = torch.where(fin, torch.where(acc, nv_keep, nv0), nv_cur)
        return new_u_sc, new_u_cnt, nu, nvn, over_u

    steps = 0
    while steps < max_steps:
        if not bool((mode != 3).any()):
            break
        for _ in range(min(CHUNK, max_steps - steps)):
            steps += 1
            lane_steps = lane_steps + (mode != 3).to(I32)
            nv = n_v
            # --- mode 0: select the highest-ranked unclaimed candidate
            sel = mode == 0
            k_free = torch.where(~claimed_k & (idx <= k[:, None]), idx,
                                 -1).max(1).values
            to_done = sel & (k_free < 0)
            to_walk = sel & (k_free >= 0)
            cand_i = _take(s_idx, k_free)
            f_cand = _take(f, cand_i)
            pk_cand = _take(pk, cand_i)
            sc0_n = torch.where(to_walk, f_cand, sc0)

            # --- mode 1: one walk step from `at` (claims as it goes)
            wlk = mode == 1
            at2 = (pk_at & PK_P) - 1
            root = at2 < 0
            pk2 = _take(pk, at2)
            fa2 = _take(f, at2)
            s = torch.where(root, sc0, sc0 - fa2)
            better = s > best_s
            drop = ~better & (best_s - s > max_drop)
            at2_claimed = ((pk2 & PK_CLAIMED) > 0) & ~root
            tie_hit = wlk & at2_claimed & (((pk2 >> 17) & F15)
                                           == (sc0 & F15))
            walk_end = wlk & (drop | root | at2_claimed)
            walk_go = wlk & ~walk_end
            best_s_n = torch.where(wlk & better, s, best_s)
            best_at_n = torch.where(wlk & better, at2, best_at)
            best_pos_n = torch.where(walk_go & better, nv, best_pos)
            best_s_n = torch.where(to_walk, 0, best_s_n)
            best_at_n = torch.where(to_walk, cand_i, best_at_n)

            # append+claim: the selected start (to_walk) or at2 (walk_go)
            app = to_walk | walk_go
            app_i = torch.where(to_walk, cand_i, at2)
            base = torch.where(to_walk, pk_cand, pk2)
            tie_hit = tie_hit | (app & ((base & PK_VIS) > 0)
                                 & (((base >> 17) & F15) == (sc0_n & F15)))
            newv = (base & PK_P) | PK_CLAIMED | PK_VIS \
                | torch.where(to_walk, PK_START, 0) \
                | ((sc0_n & F15) << 17)
            _put(pk, app_i, newv.to(I32), app)
            rk = _take(r_of, app_i)
            _put(claimed_k, rk, torch.ones_like(app), app)
            _put(vbuf, nv, app_i, app)
            nv = torch.where(app, nv + 1, nv)

            # walk end: resolve the cut
            cut_n = torch.where(walk_end, best_at_n, cut)
            keep_all = walk_end & ((best_at_n == at2) | (best_at_n < 0))
            need_undo = walk_end & ~keep_all & (nv > best_pos_n)
            fin_now = walk_end & ~need_undo
            nv_keep = torch.where(keep_all, nv, best_pos_n)

            # --- mode 2: one undo step (visited bit + claimer-f stay)
            und = mode == 2
            u_at = _take(vbuf, nv - 1)
            old = _take(pk, u_at)
            _put(pk, u_at, old & ~(PK_CLAIMED | PK_START), und)
            u_rk = _take(r_of, u_at)
            _put(claimed_k, u_rk, torch.zeros_like(und), und)
            nv = torch.where(und, nv - 1, nv)
            undo_done = und & (nv <= best_pos)
            fin_now = fin_now | undo_done

            # --- chain completion (accept/reject)
            cutv = torch.where(undo_done, cut, cut_n)
            u_sc, u_cnt, n_u_new, n_v_fin, over_u = finish_chain(
                fin_now, cutv, torch.where(undo_done, nv, nv_keep), nv)
            k_new = torch.where(fin_now, k - 1, k)
            k_new = torch.where(to_walk, k_free, k_new)

            # --- transitions
            mode_n = mode
            mode_n = torch.where(to_done, 3, mode_n)
            mode_n = torch.where(to_walk, 1, mode_n)
            mode_n = torch.where(walk_end & need_undo, 2, mode_n)
            mode_n = torch.where(fin_now, 0, mode_n)
            pk_at = torch.where(to_walk, pk_cand,
                                torch.where(walk_go, pk2, pk_at))
            best_pos = torch.where(to_walk, nv - 1, best_pos_n)
            nv0 = torch.where(to_walk, nv - 1, nv0)
            best_s, best_at = best_s_n, best_at_n
            sc0, cut, k = sc0_n, cut_n, k_new
            mode = mode_n.to(I32)
            n_u = n_u_new
            n_v = torch.where(fin_now, n_v_fin, nv)
            unsure = unsure | over_u | tie_hit
    unsure = unsure | (mode != 3)
    return dict(pk=pk, vbuf=vbuf, u_sc=u_sc, u_cnt=u_cnt, n_u=n_u, n_v=n_v,
                unsure=unsure, steps=lane_steps)


# shared memory of one block of the fused kernel (csrc/backtrack.cu
# smem_bytes): the sort's 64-bit keys over the next power of two of A
# (s_idx and r_of after the sort), f and pk side by side, the chain keys,
# five clock stamps, vbuf, a bit a rank, seven int arrays of ucap and
# eight int scalars
SMEM_LIMIT = 232448
# threads of a block: the compaction gives each chain one
MAX_UCAP = 256


def walk_smem_bytes(A: int, ucap: int) -> int:
    n_pow2 = 1 << (max(A, 1) - 1).bit_length()
    return 8 * n_pow2 + 12 * A + 4 * max(1, (A + 31) // 32) + 36 * ucap + 72


def backtrack_compact(f, p, n_a, axh, axl, ayh, ayl, min_cnt: int,
                      min_sc: int, max_drop: int, ucap: int,
                      max_steps: int = None, clock=None):
    """(B, A) planes -> compacted chains, per lane: the plain version for
    CPU tensors, one launch of the fused CUDA kernel (csrc/backtrack.cu)
    for tensors on the card.

    f, p: int32 DP scores and parents; n_a: (B,); anchor planes are u32
    values in int64 tensors.  max_steps (default 8*A + 16) is the step
    budget of a lane; no entry point passes it.  clock: None, or a
    (B, 4) int64 tensor on the card that takes each block's clock64()
    cycles of the kernel's four phases (order, walk, flags, compaction).
    Returns a dict:
      c_axh/c_axl/c_ayh/c_ayl: (B, A) compacted chain anchors (dense
        from 0, forward order, chains in first-anchor-x order)
      u_sc/u_cnt: (B, ucap) int32 chain score / anchor count
      n_u, n_v: (B,) int32 live counts
      bt_unsure: (B,) bool — step budget exceeded, > ucap chains, or an
        equal-f interaction
      steps: (B,) int32 steps each lane's walk took
    """
    if f.device.type == "cpu":
        if clock is not None:
            raise ValueError("the clock buffer is the CUDA kernel's")
        return backtrack_compact_ref(f, p, n_a, axh, axl, ayh, ayl,
                                     min_cnt, min_sc, max_drop, ucap,
                                     max_steps)
    from .. import kernels
    B, A = f.shape
    if not 1 <= ucap <= MAX_UCAP:
        raise ValueError(f"backtrack kernel: ucap={ucap} outside "
                         f"[1, {MAX_UCAP}]")
    # past A = 8192, so also every A the packed parent field cannot hold
    if walk_smem_bytes(A, ucap) > SMEM_LIMIT:
        raise ValueError(f"backtrack kernel: A={A} needs "
                         f"{walk_smem_bytes(A, ucap)} bytes of shared "
                         f"memory, a block holds {SMEM_LIMIT}")
    if clock is not None and (clock.shape != (B, 4)
                              or clock.dtype != torch.int64):
        raise ValueError("clock must be a (B, 4) int64 tensor")
    if max_steps is None:
        max_steps = 8 * A + 16
    dev = f.device
    out = {k: torch.empty((B, A), dtype=torch.int64, device=dev)
           for k in ("c_axh", "c_axl", "c_ayh", "c_ayl")}
    out.update(u_sc=torch.empty((B, ucap), dtype=I32, device=dev),
               u_cnt=torch.empty((B, ucap), dtype=I32, device=dev),
               n_u=torch.empty(B, dtype=I32, device=dev),
               n_v=torch.empty(B, dtype=I32, device=dev),
               bt_unsure=torch.empty(B, dtype=torch.bool, device=dev),
               steps=torch.empty(B, dtype=I32, device=dev))
    planes = [x.to(torch.int64).contiguous() for x in (axh, axl, ayh, ayl)]
    kernels.launch("backtrack", f.to(I32).contiguous(),
                   p.to(I32).contiguous(), n_a.to(I32).contiguous(),
                   *planes, B, A, int(ucap), int(min_cnt), int(min_sc),
                   int(max_drop), int(max_steps), out["c_axh"],
                   out["c_axl"], out["c_ayh"], out["c_ayl"], out["u_sc"],
                   out["u_cnt"], out["n_u"], out["n_v"], out["bt_unsure"],
                   out["steps"], clock)
    return out


def backtrack_compact_ref(f, p, n_a, axh, axl, ayh, ayl, min_cnt: int,
                          min_sc: int, max_drop: int, ucap: int,
                          max_steps: int = None):
    """The plain version of backtrack_compact, on any device: steps (a),
    (b) and (c) in PyTorch."""
    return _backtrack(walk_ref, f, p, n_a, axh, axl, ayh, ayl, min_cnt,
                      min_sc, max_drop, ucap, max_steps)


def _backtrack(walk, f, p, n_a, axh, axl, ayh, ayl, min_cnt, min_sc,
               max_drop, ucap, max_steps):
    B, A = f.shape
    dev = f.device
    if A >= 1 << 14:
        raise ValueError("anchor cap exceeds the packed parent field")
    if max_steps is None:
        max_steps = 8 * A + 16
    f = f.to(I32)
    n_a = n_a.to(I32)
    cand, s_idx, r_of, n_z = candidate_order(f, n_a, min_sc)
    w = walk(f, p, s_idx, r_of, n_z, min_cnt, min_sc, max_drop, ucap,
             max_steps)
    pk, vbuf, u_sc, u_cnt = w["pk"], w["vbuf"], w["u_sc"], w["u_cnt"]
    n_u, n_v = w["n_u"], w["n_v"]
    # a candidate claimed mid-path by an equal-f chain was silently
    # skipped by the select: flag it (15-bit f compare)
    unsure = w["unsure"] | (((pk & PK_CLAIMED) > 0) & cand
                            & (((pk >> 17) & F15) == (f & F15))
                            & ((pk & PK_START) == 0)).any(1)

    # ---- compact: chains by first-anchor x asc (stable) ----
    ur = torch.arange(ucap, dtype=I32, device=dev)[None, :]
    u_live = ur < n_u[:, None]
    coff = torch.cumsum(u_cnt, 1, dtype=I32) - u_cnt     # exclusive
    first_v = torch.gather(vbuf, 1, torch.clamp(coff + u_cnt - 1,
                                                min=0).long())
    fv = torch.clamp(first_v, max=A - 1).long()
    # x keys are u32 pairs packed into one int64 (axh < 2**31, as
    # rid<<1|rev always is); non-live chains sort after every live key
    kx = torch.where(u_live, (torch.gather(axh, 1, fv) << 32)
                     | torch.gather(axl, 1, fv), INT64_MAX)
    perm = torch.sort(kx, dim=1, stable=True).indices
    skx = torch.gather(kx, 1, perm)
    unsure = unsure | ((skx[:, 1:] == skx[:, :-1])
                       & (torch.arange(1, ucap, device=dev)[None, :]
                          < n_u[:, None])).any(1)
    cnt_o = torch.gather(u_cnt, 1, perm)
    sc_o = torch.gather(u_sc, 1, perm)
    coff_src_o = torch.gather(coff, 1, perm)
    coff_out = torch.cumsum(cnt_o, 1, dtype=I32) - cnt_o

    # per output position t: which chain, which offset
    t = torch.arange(A, dtype=I32, device=dev)[None, :].expand(B, A)
    starts = torch.where(u_live, coff_out, INT_MAX).contiguous()
    rank = torch.searchsorted(starts, t.contiguous(), right=True) - 1
    rank = torch.clamp(rank, 0, ucap - 1)
    o = t - torch.gather(coff_out, 1, rank)
    src = torch.gather(coff_src_o, 1, rank) \
        + torch.gather(cnt_o, 1, rank) - 1 - o
    a_idx = torch.gather(vbuf, 1, torch.clamp(src, 0, A - 1).long())
    vmask = t < n_v[:, None]
    a_idx = torch.clamp(a_idx, 0, A - 1).long()

    def g(plane):
        z = torch.gather(plane, 1, a_idx)
        return torch.where(vmask, z, torch.zeros((), dtype=z.dtype,
                                                 device=dev))

    return dict(c_axh=g(axh), c_axl=g(axl), c_ayh=g(ayh), c_ayl=g(ayl),
                u_sc=sc_o, u_cnt=cnt_o, n_u=n_u, n_v=n_v,
                bt_unsure=unsure, steps=w["steps"])
