"""The port's sketch (minigraph_tpu_torch/ops/sketch.py) against the JAX
package's: the plain PyTorch version bitwise against
ops/sketch_jax4.sketch_planes, and the interpret-mode Pallas kernel
(ops/sketch_pallas.py) on one tiny case.  Integer outputs: tolerance 0."""
from functools import partial

import jax
import numpy as np
import pytest
import torch

from minigraph_tpu.ops.sketch_jax import encode_batch as jax_encode_batch
from minigraph_tpu.ops.sketch_jax4 import sketch_planes as jax_sketch
from minigraph_tpu_torch.ops.sketch import (encode_batch, sketch_planes,
                                            sketch_planes_ref)

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)

W, K = 11, 17
FIELDS = ("hh", "hl", "meta", "t_hh", "t_hl", "t_meta", "n", "overflow")


def synth_reads(rng, n, lo, hi):
    """Reads with N runs, tandem repeats, lower case, empty and tiny."""
    reads = []
    for i in range(n):
        L = int(rng.integers(lo, hi + 1))
        s = rng.choice(list("ACGT"), L)
        for _ in range(int(rng.integers(0, 3))):
            st = int(rng.integers(0, max(1, L)))
            s[st: st + int(rng.integers(1, 40))] = "N"
        if i % 3 == 0 and L > 60:
            unit = rng.choice(list("ACGT"), int(rng.integers(1, 9)))
            st = int(rng.integers(0, L - 50))
            ln = min(L - st, int(rng.integers(40, 400)))
            s[st: st + ln] = np.resize(unit, ln)
        if i % 5 == 0:
            s = np.char.lower(s)
        reads.append("".join(s))
    reads[0] = ""
    reads[1] = "ACG"
    reads[2] = "ACGT" * (hi // 4)             # ties everywhere: overflow
    return reads


def as_np(sp):
    return [np.asarray(x).astype(np.int64) for x in sp]


def test_encode_batch_matches_jax():
    rng = np.random.default_rng(1)
    reads = synth_reads(rng, 12, 0, 300)
    c0, l0 = jax_encode_batch(reads, pad_to=320)
    c1, l1 = encode_batch(reads, pad_to=320)
    assert np.array_equal(np.asarray(c0), c1)
    assert np.array_equal(np.asarray(l0), l1)


@pytest.mark.parametrize("seed,L", [(3, 512), (4, 1024)])
def test_sketch_ref_matches_jax(seed, L):
    rng = np.random.default_rng(seed)
    reads = synth_reads(rng, 24, 0, L)
    reads[3] = "ACGTTGCA" * (L // 8)         # full-length lane: fin at L
    codes, lens = encode_batch(reads, pad_to=L)
    want = as_np(jax.jit(partial(jax_sketch, w=W, k=K))(codes, lens))
    got = sketch_planes(torch.from_numpy(codes), torch.from_numpy(lens),
                        W, K)
    got = as_np([t.numpy() for t in got])
    for name, a, b in zip(FIELDS, want, got):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert want[7].any(), "want some overflow lanes"


def test_sketch_ref_matches_pallas_interpret():
    """The TPU kernel itself (interpret mode) on one tiny case."""
    from minigraph_tpu.ops.sketch_pallas import sketch_planes_pallas

    rng = np.random.default_rng(5)
    reads = synth_reads(rng, 4, 100, 256)
    codes, lens = encode_batch(reads, pad_to=256)
    want = as_np(sketch_planes_pallas(codes, lens, W, K, rb=2, tl=64,
                                      interpret=True))
    got = as_np([t.numpy() for t in sketch_planes_ref(
        torch.from_numpy(codes), torch.from_numpy(lens), W, K)])
    for name, a, b in zip(FIELDS, want, got):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_sketch_wrapper_checks_inputs():
    codes = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        sketch_planes(codes, lens, W, 16)            # even k
    with pytest.raises(TypeError):
        sketch_planes(codes.to(torch.int32), lens, W, K)


EMPTY = (1 << 62) | 0xFF
U32 = 0xFFFFFFFF


def hash64_np(key, mask):
    """ops/sketch.py's hash on numpy uint64 (wrapping arithmetic)."""
    m = np.uint64(mask)

    def u(x):
        return np.uint64(x)

    key = (~key + (key << u(21))) & m
    key = key ^ (key >> u(24))
    key = (key + (key << u(3)) + (key << u(8))) & m
    key = key ^ (key >> u(14))
    key = (key + (key << u(2)) + (key << u(4))) & m
    key = key ^ (key >> u(28))
    return (key + (key << u(31))) & m


def sketch_tiled_model(codes, lens, w, k, S):
    """The sketch kernel's tiling (csrc/sketch.cu), every (read, S-slot
    tile) at once: a tile sees only its H + S staged bases, H = w + k + 1
    (code 4 outside [0, n_len)), and absolute positions.  Per slot t it
    computes the events t - w .. t, the newest minimum M' of t - w + 1 ..
    t - 1, the minima at t and t - 1 from M', and the emission and tie
    rules; n and overflow are sums and ORs over the tiles."""
    B, L = codes.shape
    H, wk = w + k + 1, w + k
    nt = -(-(L + 1) // S)
    p0 = (np.arange(nt) * S)[None, :, None]
    n_len = lens.astype(np.int64)[:, None, None]
    q = p0 + np.arange(-H, S)[None, None, :]
    inside = (q >= 0) & (q < n_len) & (q < L)
    staged = np.where(inside, codes[np.arange(B)[:, None, None],
                                    np.clip(q, 0, L - 1)], 4)
    staged = np.where(staged < 4, staged, 4).astype(np.uint64)
    del codes                    # from here on only the staged bases
    # wk invalid bases before them, read only by the halo's events past
    # their clamp (lmax = k), so the slices below stay in range
    staged = np.concatenate([np.full((B, nt, wk), 4, np.uint64), staged], 2)
    # events at positions p0 - w + e, staged at H - w + e
    E = S + w
    pos = p0 - w + np.arange(E)[None, None, :]
    lmax = np.where(pos >= p0, wk, k)
    shape = (B, nt, E)
    run = np.zeros(shape, np.int64)
    alive = np.ones(shape, bool)
    kf = np.zeros(shape, np.uint64)
    kr = np.zeros(shape, np.uint64)
    for d in range(wk):
        c = staged[:, :, wk + H - w - d: wk + H - w - d + E]
        alive &= (c < 4) & (d < lmax)
        run += alive
        if d < k:
            kf |= c << np.uint64(2 * d)
            kr |= (np.uint64(3) ^ c) << np.uint64(2 * (k - 1 - d))
    info = run >= k
    z = kf >= kr
    h = hash64_np(np.where(z, kr, kf), (1 << (2 * k)) - 1)
    ex = np.where(info, (h << np.uint64(8)) | np.uint64(k),
                  np.uint64(EMPTY))
    em = np.where(info, (k << 26) | (pos << 1) | z, U32)

    def at(a, j):                # event j of each slot's windows
        return a[:, :, j: j + S]

    mx = np.full((B, nt, S), EMPTY, np.uint64)
    mj = np.full((B, nt, S), -1)
    for j in range(1, w):
        take = at(ex, j) <= mx
        mx, mj = np.where(take, at(ex, j), mx), np.where(take, j, mj)
    e_t, x0 = at(ex, w), at(ex, 0)
    cur_new = e_t <= mx
    m_x, m_j = np.where(cur_new, e_t, mx), np.where(cur_new, w, mj)
    prev_old = (mj < 0) | (x0 < mx)
    pm_x, pm_j = np.where(prev_old, x0, mx), np.where(prev_old, 0, mj)
    emj = np.stack([at(em, j) for j in range(w + 1)], -1)
    m_m = np.take_along_axis(emj, m_j[..., None], -1)[..., 0]
    pm_m = np.take_along_axis(emj, pm_j[..., None], -1)[..., 0]
    l = at(run, w)
    t = p0 + np.arange(S)[None, None, :]
    in_range = t < n_len
    pmv_ok = pm_x != EMPTY
    A = e_t <= pm_x
    Bc = in_range & ~A & (pm_j == 0)
    main = (in_range & A & (l >= wk) & pmv_ok) | (Bc & (l >= wk - 1)
                                                  & pmv_ok)
    b_base = Bc & (l >= wk - 1) & (m_x != EMPTY)
    fw = in_range & (l == wk - 1) & pmv_ok
    shp = (B, nt, S)
    t_x = np.full(shp, EMPTY, np.uint64)
    t_m = np.full(shp, U32)
    tie_n = np.zeros(shp, np.int64)
    tie_fw = np.zeros(shp, bool)
    for j in range(1, w + 1):
        for cond in ((fw & (j < w) & (at(ex, j) == pm_x)
                      & (at(em, j) != pm_m)),
                     b_base & (at(ex, j) == m_x) & (at(em, j) != m_m)):
            first = cond & (tie_n == 0)
            t_x = np.where(first, at(ex, j), t_x)
            t_m = np.where(first, at(em, j), t_m)
            tie_n += cond
        tie_fw |= fw & (j < w) & (at(ex, j) == pm_x) & (at(em, j) != pm_m)
    fin = t == n_len
    fin_ok = fin & (n_len > 0) & pmv_ok
    o_m = np.where(fin_ok | (~fin & main), pm_m, U32)
    cnt = np.where(fin, fin_ok, main.astype(np.int64) + (tie_n > 0))
    flag = ~fin & ((tie_n > 1) | (tie_fw & main))

    def planes(x, m):
        x, m = x.reshape(B, -1)[:, : L + 1], m.reshape(B, -1)[:, : L + 1]
        hs = x >> np.uint64(8)
        empty = m == U32
        return [np.where(empty, U32, (hs >> np.uint64(32)).astype(np.int64)),
                np.where(empty, U32, (hs & np.uint64(U32)).astype(np.int64)),
                m.astype(np.int64)]

    live = t <= L
    return (planes(pm_x, o_m) + planes(t_x, t_m)
            + [(cnt * live).sum((1, 2)).astype(np.int32),
               (flag & live).any((1, 2))])


def tile_edge_reads(rng, L, S):
    """Reads whose N runs, ends and tandem repeats sit on and next to the
    S-slot tile boundaries: N runs that straddle a boundary or end right
    before one, n_len at a boundary, one before and one after it, n_len
    == L, reads shorter than the halo, and an empty read."""
    acgt = np.array(list("ACGT"))
    lens = [min(n, L) for n in (0, 5, L, S, S - 1, S + 1, 2 * S, 2 * S - 1,
                                19, L - 1)]
    reads = []
    for i, n in enumerate(lens):
        s = rng.choice(acgt, n)
        for b in range(S, n + S, S):
            if i % 2:            # straddles the boundary
                s[max(0, b - 4): b + 6] = "N"
            else:                # ends right before it
                s[max(0, b - 9): b] = "N"
        if i % 3 == 2 and n > 80:     # ties, and first-window overflow
            st = int(rng.integers(0, n - 60))
            s[st: st + 60] = np.resize(acgt[: int(rng.integers(1, 4))], 60)
        reads.append("".join(s))
    return reads


@pytest.mark.parametrize("w,k,S,pallas", [
    (11, 17, 64, True), (11, 17, 256, False), (10, 19, 64, True),
    (10, 19, 256, False), (5, 15, 64, True), (5, 15, 256, False),
    (1, 15, 64, False), (32, 17, 64, False), (32, 27, 256, False)])
def test_sketch_tiling_matches_ref(w, k, S, pallas):
    """The kernel's tiling bitwise against the plain version (and the TPU
    kernel in interpret mode) on tile-edge reads and random reads."""
    rng = np.random.default_rng(w * 100 + k + S)
    L = 320
    reads = tile_edge_reads(rng, L, S) + synth_reads(rng, 6, 0, L)
    codes, lens = encode_batch(reads, pad_to=L)
    got = sketch_tiled_model(codes, lens, w, k, S)
    ref = as_np([t.numpy() for t in sketch_planes_ref(
        torch.from_numpy(codes), torch.from_numpy(lens), w, k)])
    for name, a, b in zip(FIELDS, ref, got):
        np.testing.assert_array_equal(a, np.asarray(b).astype(np.int64),
                                      err_msg=name)
    assert ref[6].any() and (ref[0][lens > 0] != U32).any()
    if pallas:
        from minigraph_tpu.ops.sketch_pallas import sketch_planes_pallas
        want = as_np(sketch_planes_pallas(codes, lens, w, k, rb=16, tl=64,
                                          interpret=True))
        for name, a, b in zip(FIELDS, want, got):
            np.testing.assert_array_equal(a, np.asarray(b).astype(np.int64),
                                          err_msg=name)
