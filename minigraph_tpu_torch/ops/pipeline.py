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

`DeviceIndex`, `collect_anchors_device` and `make_map_step` (v1) use
another sketch record format and are not ported here.
"""
from __future__ import annotations

import torch

from .anchors import (HashJoinIndex, JoinIndex, collect_anchors_hash,
                      collect_anchors_join)
from .anchors_bucketed import BucketedJoinIndex, collect_anchors_bucketed
from .chain import lchain_dp_planes
from .sketch import sketch_planes

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
        best = f.max(1).values
        first = torch.arange(f.shape[1], device=dev).expand_as(f)
        best_i = torch.where(f == best[:, None], first, f.shape[1]) \
            .min(1).values.to(torch.int32)
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
