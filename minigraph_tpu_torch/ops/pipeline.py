"""Batched map step: sketch -> seed collection -> chain DP on one padded
batch of reads (port of the JAX package's ops/pipeline.py).

The JAX package has three builders of this step, which differ in how
they are dispatched on the TPU (one jit, chained dispatches, the XLA
sketch and chain against the Pallas kernels).  In the port all three
run the same stages -- the sketch through ops/sketch.py (K1 on the
card), the collect chosen by the index type, the chain through
ops/chain.py (K4 on the card) -- so they share one body and differ only
in their defaults:

* `make_map_step_v3`: chain tile 256, so acap must be a multiple of 256;
* `make_map_pipeline_v2`: the chain's limits and tile may be passed;
* `make_map_step_v2`: window 64 and chain tile 8 by default.

Index types: `HashJoinIndex` (ops/anchors.py collect_anchors_hash),
`BucketedJoinIndex` (ops/anchors_bucketed.py, the bucketed probe K5 on
the card) and `JoinIndex` (collect_anchors_join).  The step runs on the
device its tables live on: the CUDA kernels for tables on the card, the
plain versions for tables on the CPU.  It never moves to another
device; `pallas_interpret` has no counterpart here.  `b_chunk` is kept
from the JAX signatures, where it sizes the one-hot matmuls' batch
chunks; the port's scatters need no chunking, so it is unused.

Each step returns the JAX dict: f, p (B, acap) int32 chain scores and
predecessors, best (B,) the read's best f, best_anchor (B,) its first
index, n_anchors (B,) and overflow (B,) bool (sketch tie overflow or
qcap/acap overflow: the read needs the exact path).

The v1 step (`DeviceIndex`, `collect_anchors_device`, `make_map_step`,
ops/pipeline.py:28-117, 303-323) keeps the JAX package's u64 records:
the exact sketch of ops/sketch_v2.py (x = hash<<8|span, y =
rid<<32|pos<<1|strand), a binary search of the sorted minimizer keys,
anchors packed as the reference packs them (map-algo.c:152-192) and
the chain of ops/chain.py `lchain_dp_device` (K4 on the card).  The
records are int64 bit patterns (ops/u64.py): searches and sorts run on
the order-preserving key x ^ (1 << 63), so U64MAX padding sorts last as
in the JAX sorts.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .anchors import (HashJoinIndex, JoinIndex, collect_anchors_hash,
                      collect_anchors_join)
from .anchors_bucketed import BucketedJoinIndex, collect_anchors_bucketed
from . import u64
from .chain import lchain_dp_device, lchain_dp_planes
from .sketch import sketch_planes
from .sketch_v2 import sketch_device_v2

CHAIN_DEFAULTS = dict(maxdx=5000, maxdy=5000, bw=500, pen_gap=0.1827,
                      pen_skip=0.00913)


def _tables_device(ji) -> torch.device:
    if isinstance(ji, (BucketedJoinIndex, JoinIndex)):
        return ji.keymat.device
    if isinstance(ji, HashJoinIndex):
        return ji.tag.device
    raise TypeError(f"unsupported index type {type(ji).__name__}")


def _make_step(ji, w, k, acap, occ_cap, qcap, window, max_occ, tile,
               chain):
    dev = _tables_device(ji)
    if isinstance(ji, BucketedJoinIndex):
        collect = collect_anchors_bucketed
    elif isinstance(ji, HashJoinIndex):
        collect = collect_anchors_hash
    else:
        collect = collect_anchors_join

    def run(codes, lens):
        """codes (B, L) uint8 nt4, lens (B,) int32: numpy or tensors."""
        codes = torch.as_tensor(codes, dtype=torch.uint8).to(dev)
        lens = torch.as_tensor(lens, dtype=torch.int32).to(dev)
        sp = sketch_planes(codes, lens, w, k)
        axh, axl, ayh, ayl, n_a, q_ovf = collect(
            ji, sp.hh, sp.hl, sp.meta, sp.t_hh, sp.t_hl, sp.t_meta,
            max_occ, occ_cap, qcap=qcap, acap=acap)
        f, p = lchain_dp_planes(axh, axl, ayh, ayl, n_a, window=window,
                                tile=tile, **chain)
        best, best_i = best_anchor(f)
        return {"f": f, "p": p, "best": best, "best_anchor": best_i,
                "n_anchors": n_a, "overflow": sp.overflow | q_ovf}

    return run


def make_map_step_v3(ji, w: int, k: int, acap: int = 2048,
                     occ_cap: int = 16, qcap: int = 512,
                     window: int = 32, max_occ: int = 50,
                     b_chunk: int = 32, **chain_kw):
    """The production map step (ops/pipeline.py make_map_step_v3): the
    chain's limits are fixed and its tile is 256, so acap must be a
    multiple of 256 (`chain_kw` is accepted and ignored, as there)."""
    return _make_step(ji, w, k, acap, occ_cap, qcap, window, max_occ, 256,
                      CHAIN_DEFAULTS)


def make_map_pipeline_v2(ji, w: int, k: int, acap: int = 2048,
                         occ_cap: int = 16, qcap: int = 512,
                         window: int = 32, max_occ: int = 50,
                         b_chunk: int = 32, **chain_kw):
    """Map step with the chain's keywords (maxdx, maxdy, bw, pen_gap,
    pen_skip, tile; ops/pipeline.py make_map_pipeline_v2)."""
    chain = dict(CHAIN_DEFAULTS)
    tile = chain_kw.pop("tile", 256)
    unknown = set(chain_kw) - set(chain)
    if unknown:
        raise TypeError(f"unknown chain keywords {sorted(unknown)}")
    chain.update(chain_kw)
    return _make_step(ji, w, k, acap, occ_cap, qcap, window, max_occ, tile,
                      chain)


def make_map_step_v2(ji, w: int, k: int, acap: int = 2048,
                     occ_cap: int = 16, qcap: int = 512,
                     window: int = 64, max_occ: int = 50,
                     max_dist_x: int = 5000, max_dist_y: int = 5000,
                     bw: int = 500, chn_pen_gap: float = 0.1827,
                     chn_pen_skip: float = 0.00913, b_chunk: int = 32):
    """Map step with chain tile 8 and explicit chain parameters
    (ops/pipeline.py make_map_step_v2)."""
    return _make_step(ji, w, k, acap, occ_cap, qcap, window, max_occ, 8,
                      dict(maxdx=max_dist_x, maxdy=max_dist_y, bw=bw,
                           pen_gap=chn_pen_gap, pen_skip=chn_pen_skip))


@dataclass
class DeviceIndex:
    """The minimizer index and segment table on a device (ops/pipeline.py
    DeviceIndex): keys and positions as u64 bit patterns."""
    keys: torch.Tensor        # (K,) int64 u64 sorted minimizers
    key_start: torch.Tensor   # (K,) int32
    key_cnt: torch.Tensor     # (K,) int32
    pos: torch.Tensor         # (P,) int64 u64 position records
    seg_len: torch.Tensor     # (S,) int32
    k: int
    w: int

    @classmethod
    def from_host(cls, gi, device="cuda") -> "DeviceIndex":
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass "
                               "device='cpu' for the plain versions")

        def i32(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

        return cls(keys=u64.from_numpy(gi.keys, dev),
                   key_start=i32(gi.key_start), key_cnt=i32(gi.key_cnt),
                   pos=u64.from_numpy(gi.pos, dev),
                   seg_len=i32([s.len for s in gi.g.seg]), k=gi.k, w=gi.w)


def collect_anchors_device(idx_keys, idx_start, idx_cnt, idx_pos, seg_len,
                           mv_x, mv_y, n_mv, max_occ: int, occ_cap: int,
                           acap: int):
    """Index probe and anchor construction (collect_seed_hits semantics,
    map-algo.c:152-192) with a fixed per-minimizer occurrence cap.

    idx_keys may end in U64MAX padding (an "idx" shard's keys).  mv_x,
    mv_y: (B, M) minimizer records; n_mv: (B,).  Returns (ax, ay, n_a):
    (B, min(acap, M * occ_cap)) anchors sorted by x, U64MAX after the
    n_a live ones, and n_a (B,) int32."""
    B, M = mv_x.shape
    dev = mv_x.device
    K, P, S = idx_keys.numel(), idx_pos.numel(), seg_len.numel()
    minier = u64.srl(mv_x, 8)
    k_idx = torch.searchsorted(u64.skey(idx_keys), u64.skey(minier))
    k_idx = torch.clamp(k_idx, max=K - 1)
    live = torch.arange(M, device=dev)[None, :] < n_mv.to(torch.int64)[:, None]
    found = (idx_keys[k_idx] == minier) & live
    cnt = torch.where(found, idx_cnt[k_idx].to(torch.int64), 0)
    start = torch.where(found, idx_start[k_idx].to(torch.int64), 0)
    cnt = torch.where(found & (cnt < max_occ), cnt, 0)

    q_pos = mv_y & 0xFFFFFFFF
    q_span = mv_x & 0xFF
    seg_id = u64.srl(mv_y, 32)
    same_prev = minier[:, 1:] == minier[:, :-1]
    f0 = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    tandem = torch.cat([f0, same_prev], 1) | torch.cat([same_prev, f0], 1)

    # expand: up to occ_cap hits a minimizer, an (M, occ_cap) grid
    occ = torch.clamp(cnt, max=occ_cap)
    slot = torch.arange(occ_cap, device=dev)
    hit_ok = slot < occ[..., None]
    r = idx_pos[torch.clamp(start[..., None] + slot, max=P - 1)]
    rid = u64.srl(r, 32)
    rpos = (r & 0xFFFFFFFF) >> 1
    rev = (r ^ q_pos[..., None]) & 1
    slen = seg_len[torch.clamp(rid, 0, S - 1)].to(torch.int64)
    tpos = torch.where(rev == 0, rpos,
                       slen - (rpos + 1 - q_span[..., None]) - 1)
    axv = (rid << 33) | (rev << 32) | tpos
    occ_b = torch.clamp(cnt, max=255)
    ayv = (occ_b << 56) | ((seg_id & 0xFFFFFFFF) << 48) \
        | torch.where(tandem, 1 << 42, 0) | (q_span << 32) \
        | u64.srl(q_pos, 1)
    ayv = ayv[..., None].expand(B, M, occ_cap)
    # invalid hits take U64MAX, the largest key: one stable sort packs
    # and orders the anchors
    axf = torch.where(hit_ok, axv, u64.U64MAX).reshape(B, M * occ_cap)
    ayf = torch.where(hit_ok, ayv, u64.U64MAX).reshape(B, M * occ_cap)
    n_a = torch.clamp(occ.sum(1), max=acap).to(torch.int32)
    order = torch.sort(u64.skey(axf), dim=1, stable=True).indices[:, :acap]
    return (torch.gather(axf, 1, order), torch.gather(ayf, 1, order), n_a)


def make_map_step(dix: DeviceIndex, mcap: int, acap: int, occ_cap: int = 16,
                  window: int = 64, max_occ: int = 50, max_dist_x: int = 5000,
                  max_dist_y: int = 5000, bw: int = 500,
                  chn_pen_gap: float = 0.1827, chn_pen_skip: float = 0.00913):
    """The v1 batched map step (ops/pipeline.py make_map_step): the exact
    sketch capped at mcap records a read, the binary-search collect
    capped at acap anchors, the chain over a window of `window`
    anchors (K4 on the card).  Runs on the device of dix's tables.
    step(codes, lens) returns f, p (B, A) int32, best, best_anchor and
    n_anchors (B,)."""
    dev = dix.keys.device

    def map_step(codes, lens):
        codes = torch.as_tensor(codes, dtype=torch.uint8).to(dev)
        lens = torch.as_tensor(lens, dtype=torch.int32).to(dev)
        mx, my, n_mv = sketch_device_v2(codes, lens, dix.w, dix.k, cap=mcap)
        ax, ay, n_a = collect_anchors_device(
            dix.keys, dix.key_start, dix.key_cnt, dix.pos, dix.seg_len,
            mx, my, n_mv, max_occ, occ_cap, acap)
        f, p = lchain_dp_device(ax, ay, n_a, max_dist_x, max_dist_y, bw,
                                chn_pen_gap, chn_pen_skip, window=window)
        best, best_i = best_anchor(f)
        return {"f": f, "p": p, "best": best, "best_anchor": best_i,
                "n_anchors": n_a}

    return map_step


def best_anchor(f):
    """(max f, its first index) of each row, as jnp.max and jnp.argmax."""
    best = f.max(1).values
    first = torch.arange(f.shape[1], device=f.device).expand_as(f)
    best_i = torch.where(f == best[:, None], first, f.shape[1]) \
        .min(1).values.to(torch.int32)
    return best, best_i
