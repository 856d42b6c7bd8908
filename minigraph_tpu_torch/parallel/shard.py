"""Multi-GPU scaling of the batched map step on torch.distributed.

Port of the JAX package's parallel/shard.py.  The layout is the same:
read batches are data-parallel over the mesh's "data" axis; the
minimizer index is replicated, or sharded by key range over the "idx"
axis with an all-gather of the per-shard seed hits.  JAX runs one
process over every chip of a mesh (shard_map); PyTorch runs one
process a device, so here each rank of the process group calls the
same step, and the collectives of shard_map are spelled out:

* `make_mesh` builds a `DeviceMesh` of shape (n // idx_shards,
  idx_shards), named ("data", "idx"), over the process group the caller
  initialised (parallel/dist.py `initialize`, or
  torch.distributed.init_process_group).  Rank r is the mesh's
  (r // idx_shards, r % idx_shards).
* Every step factory returns `step(codes, lens)`, which each rank calls
  with the whole batch: the rank takes its contiguous block of rows
  along "data" (JAX's P("data"); B must divide evenly), runs the local
  step on the shard of the tables its "idx" coordinate picks, and, for
  the idx-sharded steps, all-gathers the per-shard anchors over "idx"
  and sums n_a there (JAX's all_gather and psum), stacks the shards in
  idx order, sorts stably on x only, truncates to acap and chains.  It
  then all-gathers its rows over "data", so every rank returns the
  global arrays that JAX's out_specs describe.

Collectives run on the tables' device.  A gloo group takes host
tensors: a tensor on the card is staged through the host for it,
chosen by the group's backend (NCCL takes it as it is).

The steps' windows follow the JAX ones: v1 64 (its default) and 32
idx-sharded, the v2, hash and join idx-sharded steps 16 with tile 8.
The JAX make_mesh falls back to CPU devices when the platform has
fewer chips; this one never does: a card asked for and absent is an
error.  The JAX package's parallel/_smap.py (a shard_map import shim)
has no counterpart.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import u64
from ..ops.anchors import (HashJoinIndex, JoinIndex, collect_anchors_hash,
                           collect_anchors_join)
from ..ops.chain import lchain_dp_device, lchain_dp_planes
from ..ops.pipeline import (DeviceIndex, collect_anchors_device,
                            make_map_step, make_map_step_v2)
from ..ops.sketch import sketch_planes
from ..ops.sketch_v2 import sketch_device_v2
from ..ops.u32 import U32MAX

CHAIN = (5000, 5000, 500, 0.1827, 0.00913)   # the idx steps' chain


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or card rank % device_count (ranks
    share cards when there are more ranks than cards)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu'")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, idx_shards: int = 1,
              device="cuda"):
    """A ("data", "idx") DeviceMesh of shape (n // idx_shards,
    idx_shards) over the initialised process group of n ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(parallel/dist.py initialize)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"make_mesh: {n} devices asked for, the process "
                         f"group has {world} ranks")
    if idx_shards < 1 or n % idx_shards:
        raise ValueError(f"make_mesh: {idx_shards} idx shards do not "
                         f"divide {n} devices")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, (n // idx_shards, idx_shards),
                            mesh_dim_names=("data", "idx"))


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `t` over `group`, in group-rank order, on t's
    device.  bool travels as uint8; a gloo group gets host tensors."""
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()
    src = src.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(device=t.device, dtype=t.dtype) for o in out]


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    src = t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" \
        else t.clone()
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=group)
    return src.to(t.device)


def _my_rows(mesh, codes, lens, dev):
    n_data = mesh.size(0)
    d = mesh.get_local_rank("data")
    codes = torch.as_tensor(codes, dtype=torch.uint8)
    lens = torch.as_tensor(lens, dtype=torch.int32)
    B = codes.shape[0]
    if B % n_data:
        raise ValueError(f"batch of {B} reads does not split over "
                         f"{n_data} data ranks")
    b = B // n_data
    return (codes[d * b:(d + 1) * b].to(dev), lens[d * b:(d + 1) * b].to(dev))


def _gather_rows(mesh, out):
    """The global arrays from each data rank's rows (JAX's out_specs
    P("data"))."""
    group = mesh.get_group("data")
    if isinstance(out, dict):
        return {k: torch.cat(all_gather(v, group), 0) for k, v in out.items()}
    return tuple(torch.cat(all_gather(v, group), 0) for v in out)


def _merge_shards(mesh, parts, n_a, key_of, acap):
    """all_gather the per-shard anchor arrays over "idx" (stacked in idx
    order), lay them out (b, I * acap_shard) as JAX's moveaxis +
    reshape does, sort stably on x alone and truncate to acap; n_a is
    summed over "idx".  Returns (merged arrays, min(n_all, acap))."""
    group = mesh.get_group("idx")
    b = n_a.shape[0]
    merged = [torch.stack(all_gather(a, group), 1).reshape(b, -1)
              for a in parts]
    n_all = all_reduce_sum(n_a, group)
    order = torch.sort(key_of(merged), dim=1, stable=True).indices[:, :acap]
    return ([torch.gather(a, 1, order) for a in merged],
            torch.clamp(n_all, max=acap).to(torch.int32))


def _plane_key(merged):
    """The unsigned (axh, axl) order of anchor planes; padding last."""
    axh, axl = merged[0], merged[1]
    return torch.where(axh == U32MAX, u64.INT64_MAX, (axh << 32) | axl)


def make_sharded_map_step(mesh, dix: DeviceIndex, mcap: int, acap: int,
                          **kw):
    """The v1 map step with data-parallel reads and a replicated device
    index (parallel/shard.py make_sharded_map_step)."""
    step = make_map_step(dix, mcap, acap, **kw)
    dev = dix.keys.device

    def run(codes, lens):
        return _gather_rows(mesh, step(*_my_rows(mesh, codes, lens, dev)))

    return run


def make_sharded_map_step_v2(mesh, ji, w: int, k: int, acap: int = 1024,
                             **kw):
    """Data-parallel reads on the join pipeline (make_map_step_v2), the
    join tables replicated."""
    step = make_map_step_v2(ji, w=w, k=k, acap=acap, **kw)
    dev = ji.keymat.device

    def run(codes, lens):
        return _gather_rows(mesh, step(*_my_rows(mesh, codes, lens, dev)))

    return run


def make_index_sharded_map_step_v2(mesh, ji: JoinIndex, w: int, k: int,
                                   acap: int = 1024, occ_cap: int = 16,
                                   qcap: int = 256, window: int = 16,
                                   max_occ: int = 50):
    """The join pipeline with the key table sharded by column range over
    "idx": each rank joins against its slice of per = ceil(K / I)
    columns (a minimizer matches in exactly one shard), the per-shard
    anchors are merged and chained.  Returns step(codes, lens) ->
    (best, n_anchors).

    The JAX version pads the last shard's keymat with never-matching
    columns; the port's join recovers its keys from keymat, where such a
    column would read as key 0, so each shard is built from its real
    columns only (a query is then matched against the same keys)."""
    n_idx = mesh.size(1)
    i = mesh.get_local_rank("idx")
    dev = ji.keymat.device
    K = ji.keymat.shape[1]
    per = -(-K // n_idx)
    a, b = min(i * per, K), min((i + 1) * per, K)
    shard = JoinIndex.from_arrays(
        {"keymat": ji.keymat[:, a:b].cpu().numpy(),
         "keyext": ji.keyext[a:b].cpu().numpy()}, dev)
    acap_shard = max(acap // n_idx, 256)

    def run(codes, lens):
        codes, lens = _my_rows(mesh, codes, lens, dev)
        sp = sketch_planes(codes, lens, w, k)
        axh, axl, ayh, ayl, n_a, _ = collect_anchors_join(
            shard, sp.hh, sp.hl, sp.meta, sp.t_hh, sp.t_hl, sp.t_meta,
            max_occ, occ_cap, qcap=qcap, acap=acap_shard)
        planes, n = _merge_shards(mesh, (axh, axl, ayh, ayl), n_a,
                                  _plane_key, acap)
        f, _ = lchain_dp_planes(*planes, n, *CHAIN, window=window, tile=8)
        return _gather_rows(mesh, (f.max(1).values, n))

    return run


def shard_index_by_key(gi_keys, gi_start, gi_cnt, gi_pos, n_shards: int):
    """Split the flat index into contiguous key-range shards, padded to
    equal sizes (keys with U64MAX, counts and starts with 0, positions
    with 0) for "idx" sharding; starts are rebased to each shard's
    positions.  numpy in, numpy (uint64 keys and positions) out."""
    K = len(gi_keys)
    per = -(-K // n_shards)
    shards = []
    for s in range(n_shards):
        a, b = s * per, min((s + 1) * per, K)
        keys = np.full(per, 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)
        cnt = np.zeros(per, dtype=np.int32)
        start = np.zeros(per, dtype=np.int32)
        if a < b:
            keys[: b - a] = gi_keys[a:b]
            cnt[: b - a] = gi_cnt[a:b]
            p0 = gi_start[a]
            p1 = gi_start[b - 1] + gi_cnt[b - 1]
            start[: b - a] = gi_start[a:b] - p0
            pos = np.asarray(gi_pos[p0:p1], dtype=np.uint64)
        else:
            pos = np.zeros(0, dtype=np.uint64)
        shards.append((keys, start, cnt, pos))
    pmax = max(len(s[3]) for s in shards)
    pos_arr = np.full((n_shards, max(pmax, 1)), 0, dtype=np.uint64)
    for s, sh in enumerate(shards):
        pos_arr[s, : len(sh[3])] = sh[3]
    return (np.stack([s[0] for s in shards]),
            np.stack([s[1] for s in shards]),
            np.stack([s[2] for s in shards]),
            pos_arr)


def shard_hash_arrays(gi, n_shards: int) -> List[dict]:
    """One cuckoo table a contiguous key-range shard, as numpy arrays
    (HashJoinIndex.key_arrays), all with one hbits: a shard whose table
    grew makes every shard rebuild at its size (parallel/shard.py
    shard_hash_index).  Position offsets are rebased per shard."""
    seg_len = np.asarray([s.len for s in gi.g.seg], dtype=np.int64)
    keys_sh, start_sh, cnt_sh, pos_sh = shard_index_by_key(
        np.asarray(gi.keys), np.asarray(gi.key_start),
        np.asarray(gi.key_cnt), np.asarray(gi.pos), n_shards)
    hbits_min = 0
    while True:  # until every shard fits the common table size
        shards = []
        for s in range(n_shards):
            real = keys_sh[s] != np.uint64(0xFFFFFFFFFFFFFFFF)
            shards.append(HashJoinIndex.key_arrays(
                keys_sh[s][real], start_sh[s][real].astype(np.int64),
                cnt_sh[s][real].astype(np.int64), pos_sh[s], seg_len,
                hbits_min=hbits_min))
        hb = max(h["hbits"] for h in shards)
        if all(h["hbits"] == hb for h in shards):
            return shards
        hbits_min = hb


def shard_hash_index(gi, n_shards: int, occ_cap: int = 16, device="cuda"):
    """The shards of `shard_hash_arrays` as HashJoinIndex tables on
    `device`, and their common hbits.  The JAX version stacks the shards
    (padding the position planes to the longest) into one array that
    shard_map splits; here each rank keeps its shard's table."""
    arrays = shard_hash_arrays(gi, n_shards)
    return ([HashJoinIndex.from_arrays(a, occ_cap, device) for a in arrays],
            arrays[0]["hbits"])


def make_hash_sharded_map_step(mesh, gi, acap: int = 1024, occ_cap: int = 16,
                               qcap: int = 256, window: int = 16,
                               max_occ: int = 50, device="cuda"):
    """The cuckoo-hash probe with the table sharded over "idx": every key
    lives in exactly one shard's table, each rank probes its rows'
    queries against its shard, the anchors are merged and chained.  The
    tables are built on every rank (one hbits for all shards) and each
    keeps its own on `device`.  Returns step(codes, lens) -> (best,
    n_anchors)."""
    n_idx = mesh.size(1)
    dev = rank_device(device)
    arrays = shard_hash_arrays(gi, n_idx)[mesh.get_local_rank("idx")]
    shard = HashJoinIndex.from_arrays(arrays, occ_cap, dev)
    acap_shard = max(acap // n_idx, 256)
    w, k = gi.w, gi.k

    def run(codes, lens):
        codes, lens = _my_rows(mesh, codes, lens, dev)
        sp = sketch_planes(codes, lens, w, k)
        axh, axl, ayh, ayl, n_a, _ = collect_anchors_hash(
            shard, sp.hh, sp.hl, sp.meta, sp.t_hh, sp.t_hl, sp.t_meta,
            max_occ, occ_cap, qcap=qcap, acap=acap_shard)
        planes, n = _merge_shards(mesh, (axh, axl, ayh, ayl), n_a,
                                  _plane_key, acap)
        f, _ = lchain_dp_planes(*planes, n, *CHAIN, window=window, tile=8)
        return _gather_rows(mesh, (f.max(1).values, n))

    return run


def make_index_sharded_map_step(mesh, dix: DeviceIndex, mcap: int, acap: int,
                                occ_cap: int = 16, window: int = 32,
                                max_occ: int = 50):
    """The v1 map step with the minimizer index sharded by key range over
    "idx": each rank probes its shard (shard_index_by_key), the
    per-shard hits are merged by a stable sort on x and chained
    (lchain_dp_device).  Returns step(codes, lens) -> (best,
    n_anchors)."""
    n_idx = mesh.size(1)
    i = mesh.get_local_rank("idx")
    dev = dix.keys.device
    keys_sh, start_sh, cnt_sh, pos_sh = shard_index_by_key(
        u64.to_numpy(dix.keys), dix.key_start.cpu().numpy(),
        dix.key_cnt.cpu().numpy(), u64.to_numpy(dix.pos), n_idx)
    keys = u64.from_numpy(keys_sh[i], dev)
    start = torch.from_numpy(start_sh[i].astype(np.int32)).to(dev)
    cnt = torch.from_numpy(cnt_sh[i].astype(np.int32)).to(dev)
    pos = u64.from_numpy(pos_sh[i], dev)
    acap_shard = max(acap // n_idx, 256)

    def run(codes, lens):
        codes, lens = _my_rows(mesh, codes, lens, dev)
        mx, my, n_mv = sketch_device_v2(codes, lens, dix.w, dix.k, cap=mcap)
        ax, ay, n_a = collect_anchors_device(
            keys, start, cnt, pos, dix.seg_len, mx, my, n_mv, max_occ,
            occ_cap, acap_shard)
        (ax, ay), n = _merge_shards(mesh, (ax, ay), n_a,
                                    lambda m: u64.skey(m[0]), acap)
        f, _ = lchain_dp_device(ax, ay, n, *CHAIN, window=window)
        return _gather_rows(mesh, (f.max(1).values, n))

    return run
