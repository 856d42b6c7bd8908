"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These tests import neither jax nor the JAX package, so they run
on a GPU machine without JAX:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Without a CUDA device every test here skips (the kernels have no CPU
mode).  Integer outputs and the probes' present slots: tolerance 0.  An
empty slot of the bucketed probe holds its bucket's payload column sum,
held to a relative tolerance of KB * 2^-24 (the bound on a float32 sum
of KB non-negative terms in any order; both versions round the exact
sum once, so they agree bitwise in practice)."""
import io

import numpy as np
import pytest
import torch

from minigraph_tpu_torch import kernels
from minigraph_tpu_torch.ops.backtrack import (backtrack_compact,
                                               backtrack_compact_ref)
from minigraph_tpu_torch.ops.chain import lchain_dp_planes, lchain_dp_tiled_ref
from minigraph_tpu_torch.ops.chain_chunked import (lchain_dp_chunked,
                                                   lchain_dp_chunked_ref)
from minigraph_tpu_torch.ops.chain_exact import (lchain_dp_exact_win,
                                                 lchain_dp_exact_win_ref)
from minigraph_tpu_torch.ops.probe import (probe_bucketed, probe_bucketed_ref,
                                           probe_flat, probe_flat_ref)
from minigraph_tpu_torch.ops.sketch import sketch_planes, sketch_planes_ref
from minigraph_tpu_torch.ops.wfa_banded import (banded_score_planes,
                                                banded_score_ref,
                                                encode_pairs)

pytestmark = pytest.mark.cuda
MDX = MDY = 5000
BW, MAX_SKIP, MAX_ITER = 500, 25, 5000
PEN_GAP, PEN_SKIP = 0.1827, 0.000913


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def synth_codes(rng, B, L):
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0], lens[-1] = 0, L
    for b in range(B):
        st = int(rng.integers(0, L))
        codes[b, st: st + int(rng.integers(1, 30))] = 4
        if b % 3 == 0:
            unit = rng.integers(0, 4, int(rng.integers(1, 6)))
            st = int(rng.integers(0, L))
            codes[b, st:] = np.resize(unit, L - st)
    return codes, lens


def synth_planes(rng, B, A, dense_frac=0.25, scramble=0.0):
    """Sorted anchor planes like real seed hits, with repeat pileups;
    `scramble` of each read's anchors trade query positions (short
    chains, so the chunked chain walks below its top rows)."""
    U = 0xFFFFFFFF
    planes = [np.full((B, A), U, np.int64) for _ in range(4)]
    n_a = rng.integers(0, A + 1, B).astype(np.int32)
    n_a[0], n_a[-1] = 0, A
    for b in range(B):
        n = int(n_a[b])
        if n == 0:
            continue
        nv = int(rng.integers(1, 4))
        vid = np.sort(rng.integers(0, 50, n) % nv)
        qpos = np.sort(rng.integers(0, 2000, n))
        tpos = qpos + rng.integers(0, 300, nv)[vid] + rng.integers(-40, 40, n)
        if rng.random() < dense_frac:
            lo = int(rng.integers(0, max(1, n // 2)))
            hi = min(n, lo + int(rng.integers(20, 80)))
            tpos[lo:hi] = tpos[lo] + rng.integers(0, 5, hi - lo)
        tpos = np.maximum(tpos, 1)
        order = np.lexsort((tpos, vid))
        planes[0][b, :n] = vid[order]
        planes[1][b, :n] = tpos[order]
        planes[2][b, :n] = rng.integers(15, 24, n)
        planes[3][b, :n] = qpos[order]
        if scramble:
            sel = rng.choice(n, int(n * scramble), replace=False)
            planes[3][b, sel] = rng.permutation(planes[3][b, sel])
    return [torch.from_numpy(p) for p in planes] + [torch.from_numpy(n_a)]


@pytest.mark.parametrize("B,L", [(1, 1), (3, 31), (16, 64), (64, 2048),
                                 (4, 8192)])
def test_sketch_kernel_matches_ref(card, B, L):
    rng = np.random.default_rng(B * 131 + L)
    codes, lens = synth_codes(rng, B, L)
    c = torch.from_numpy(codes).to(card)
    n = torch.from_numpy(lens).to(card)
    before = kernels.launches["sketch"]
    got = sketch_planes(c, n, 11, 17)
    assert kernels.launches["sketch"] == before + 1
    for a, b in zip(got, sketch_planes_ref(c, n, 11, 17)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("w,k", [(10, 19), (5, 15)])
def test_sketch_kernel_other_wk(card, w, k):
    codes, lens = synth_codes(np.random.default_rng(w), 8, 512)
    c = torch.from_numpy(codes).to(card)
    n = torch.from_numpy(lens).to(card)
    for a, b in zip(sketch_planes(c, n, w, k), sketch_planes_ref(c, n, w, k)):
        assert torch.equal(a, b)


def edge_codes(rng, L, S=256):
    """Reads on and next to the kernel's S-slot tile boundaries: N runs
    that straddle a boundary or end right before one, n_len at a
    boundary, one before and one after it, n_len == L, reads shorter
    than the halo, an empty read, and tandem repeats (ties)."""
    lens = [min(n, L) for n in (0, 5, L, S, S - 1, S + 1, 2 * S, 2 * S - 1,
                                19, L - 1, L - S)]
    codes = rng.integers(0, 4, (len(lens), L)).astype(np.uint8)
    for i, n in enumerate(lens):
        for b in range(S, n + S, S):
            if i % 2:
                codes[i, max(0, b - 4): b + 6] = 4
            else:
                codes[i, max(0, b - 9): b] = 4
        if i % 3 == 2 and n > 80:
            st = int(rng.integers(0, n - 60))
            codes[i, st: st + 60] = np.resize(
                rng.integers(0, 4, int(rng.integers(1, 4))), 60)
    return codes, np.array(lens, np.int32)


# the kernel's tiling: tile edges, L not a multiple of the tile, the
# widest window (w = 32) and w = 1
@pytest.mark.parametrize("w,k,L", [(11, 17, 2048), (10, 19, 1000),
                                   (5, 15, 777), (1, 15, 600),
                                   (32, 17, 1300), (32, 27, 513)])
def test_sketch_kernel_tile_edges(card, w, k, L):
    rng = np.random.default_rng(w * 1000 + L)
    c0, l0 = edge_codes(rng, L)
    c1, l1 = synth_codes(rng, 16, L)
    c = torch.from_numpy(np.concatenate([c0, c1])).to(card)
    n = torch.from_numpy(np.concatenate([l0, l1])).to(card)
    before = kernels.launches["sketch"]
    got = sketch_planes(c, n, w, k)
    assert kernels.launches["sketch"] == before + 1
    for a, b in zip(got, sketch_planes_ref(c, n, w, k)):
        assert torch.equal(a, b)


def test_sketch_kernel_rejects_wide_window(card):
    c = torch.zeros((2, 64), dtype=torch.uint8, device=card)
    n = torch.full((2,), 64, dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError):
        sketch_planes(c, n, 40, 17)


@pytest.mark.parametrize("W,T,A,B,max_iter",
                         [(64, 16, 256, 8, MAX_ITER), (128, 32, 512, 32,
                                                       MAX_ITER),
                          (0, 8, 64, 4, MAX_ITER), (64, 16, 256, 8, 40),
                          (512, 128, 512, 16, MAX_ITER)])
def test_chain_kernel_matches_ref(card, W, T, A, B, max_iter):
    rng = np.random.default_rng(W + T + A + max_iter)
    planes = [t.to(card) for t in synth_planes(rng, B, A, dense_frac=0.5)]
    args = (MDX, MDY, BW, MAX_SKIP, max_iter, PEN_GAP, PEN_SKIP)
    before = kernels.launches["chain_exact"]
    got = lchain_dp_exact_win(*planes, *args, window=W, tile=T)
    assert kernels.launches["chain_exact"] == before + 1
    ref = lchain_dp_exact_win_ref(*planes, *args, window=W, tile=T)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# the two-pass kernel on broken-up chains: the 2 and 32 kb buckets'
# windows, the 2048-row cap, an empty window and a small tile, each
# with the max_iter clamp binding inside the window and without it
@pytest.mark.parametrize("max_iter", [40, MAX_ITER])
@pytest.mark.parametrize("W,T,A", [(512, 128, 1024), (768, 128, 2048),
                                   (1920, 128, 2560), (0, 8, 256),
                                   (64, 16, 512)])
def test_chain_kernel_scrambled(card, W, T, A, max_iter):
    rng = np.random.default_rng(W + A + max_iter)
    planes = [t.to(card) for t in synth_planes(rng, 8, A, dense_frac=0.5,
                                               scramble=0.3)]
    args = (MDX, MDY, BW, MAX_SKIP, max_iter, PEN_GAP, PEN_SKIP)
    got = lchain_dp_exact_win(*planes, *args, window=W, tile=T)
    ref = lchain_dp_exact_win_ref(*planes, *args, window=W, tile=T)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (got[1] >= 0).any()


@pytest.mark.parametrize("W,T,A,B", [(32, 256, 512, 16), (16, 64, 256, 8),
                                     (64, 8, 128, 5), (200, 16, 256, 4),
                                     (1, 8, 64, 3)])
def test_chain_ring_kernel_matches_ref(card, W, T, A, B):
    rng = np.random.default_rng(W * 7 + A)
    planes = [t.to(card) for t in synth_planes(rng, B, A, dense_frac=0.5)]
    before = kernels.launches["chain_ring"]
    got = lchain_dp_planes(*planes, window=W, tile=T)
    assert kernels.launches["chain_ring"] == before + 1
    ref = lchain_dp_tiled_ref(*planes, MDX, MDY, BW, 0.1827, 0.00913,
                              window=W, tile=T)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def tie_planes(rng, B, A):
    """Anchors with exact duplicates (tied sc + f, the smallest anchor
    index wins), in every fourth read a run of 40 of them (ties 32 ring
    slots apart, inside one lane), a qpos jump past max_dist_x (refused
    pairs), n_a = 0 and n_a = A."""
    U = 0xFFFFFFFF
    pl = [np.full((B, A), U, np.int64) for _ in range(4)]
    n_a = rng.integers(1, A + 1, B).astype(np.int32)
    n_a[0], n_a[-1] = 0, A
    for b in range(B):
        n = int(n_a[b])
        if n == 0:
            continue
        vid = np.sort(rng.integers(0, 3, n))
        qpos = np.sort(rng.integers(0, 3000, n))
        qpos[n // 2:] += 6000 if b % 2 else 0
        tpos = np.maximum(qpos + rng.integers(0, 300, 3)[vid]
                          + rng.integers(-40, 40, n), 1)
        span = rng.integers(15, 24, n)
        order = np.lexsort((tpos, vid))
        vid, tpos, qpos, span = (a[order] for a in (vid, tpos, qpos, span))
        dup = rng.random(n) < 0.1
        if b % 4 == 3 and n > 100:
            dup[n // 2 + 5: n // 2 + 45] = True
        for i in np.nonzero(dup)[0]:
            if i:
                vid[i], tpos[i], qpos[i], span[i] = \
                    vid[i - 1], tpos[i - 1], qpos[i - 1], span[i - 1]
        pl[0][b, :n], pl[1][b, :n], pl[3][b, :n] = vid, tpos, qpos
        pl[2][b, :n] = span
    return [torch.from_numpy(p) for p in pl] + [torch.from_numpy(n_a)]


@pytest.mark.parametrize("W", [1, 31, 32, 33, 256])
def test_chain_ring_kernel_ties(card, W):
    A = 512 if W == 256 else 256
    planes = [t.to(card) for t in tie_planes(np.random.default_rng(W), 12,
                                             A)]
    got = lchain_dp_planes(*planes, window=W, tile=A)
    ref = lchain_dp_tiled_ref(*planes, MDX, MDY, BW, 0.1827, 0.00913,
                              window=W, tile=A)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert (ref[1] >= 0).sum() > 10


def test_chain_ring_kernel_rejects_wide_window(card):
    planes = [t.to(card) for t in synth_planes(np.random.default_rng(2), 2,
                                               64)]
    with pytest.raises(ValueError):
        lchain_dp_planes(*planes, window=257, tile=8)


@pytest.mark.parametrize("A,W,T,scramble", [(512, 512, 128, 0.0),
                                             (2048, 768, 128, 0.3),
                                             (5376, 768, 128, 1.0)])
def test_chain_chunked_kernel_matches_ref(card, A, W, T, scramble):
    rng = np.random.default_rng(A + W)
    planes = [t.to(card) for t in synth_planes(rng, 8, A, dense_frac=0.5,
                                               scramble=scramble)]
    args = (MDX, MDY, BW, MAX_SKIP, MAX_ITER, PEN_GAP, PEN_SKIP)
    before = kernels.launches["chain_chunked"]
    got = lchain_dp_chunked(*planes, *args, window=W, tile=T)
    assert kernels.launches["chain_chunked"] == before + 1
    walk = {}
    ref = lchain_dp_chunked_ref(*planes, *args, window=W, tile=T, walk=walk)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # the full-window chain flags the same reads
    assert torch.equal(got[2], lchain_dp_exact_win(*planes, *args, window=W,
                                                   tile=T)[2])
    if scramble:
        assert walk["blocks"] > 0


# the two-pass kernel on broken-up chains at W = 128, the 2 and 32 kb
# buckets' windows and the widest the kernel takes, with reads longer
# than the window (they overflow it) and tiles of several groups
@pytest.mark.parametrize("W,T,A", [(128, 128, 1024), (128, 16, 512),
                                   (512, 128, 1024), (768, 128, 2048),
                                   (768, 64, 1536), (2048, 128, 2560)])
def test_chain_chunked_kernel_scrambled(card, W, T, A):
    rng = np.random.default_rng(W + T + A)
    planes = [t.to(card) for t in synth_planes(rng, 8, A, dense_frac=0.5,
                                               scramble=0.5)]
    args = (MDX, MDY, BW, MAX_SKIP, MAX_ITER, PEN_GAP, PEN_SKIP)
    before = kernels.launches["chain_chunked"]
    got = lchain_dp_chunked(*planes, *args, window=W, tile=T)
    assert kernels.launches["chain_chunked"] == before + 1
    walk = {}
    ref = lchain_dp_chunked_ref(*planes, *args, window=W, tile=T, walk=walk)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert walk["blocks"] > 0 and (got[1] >= 0).any()
    assert not got[2].all()


def test_chain_chunked_kernel_shared_memory_limit(card):
    """The read's marked bitmask grows with A: at 2^20 rows the block
    still fits and matches; at 2^21 the launch is refused (RuntimeError),
    never run on a smaller buffer."""
    args = (MDX, MDY, BW, MAX_SKIP, MAX_ITER, PEN_GAP, PEN_SKIP)
    for A, fits in ((1 << 20, True), (1 << 21, False)):
        rng = np.random.default_rng(A)
        small = synth_planes(rng, 1, 1024, dense_frac=0.5, scramble=0.5)
        planes = [torch.full((1, A), 0xFFFFFFFF, dtype=torch.int64)
                  for _ in range(4)]
        for big, sm in zip(planes, small):
            big[:, :1024] = sm
        planes = [t.to(card) for t in planes] + [small[4].to(card)]
        if fits:
            got = lchain_dp_chunked(*planes, *args, window=128, tile=128)
            ref = lchain_dp_chunked_ref(*planes, *args, window=128,
                                        tile=128)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)
        else:
            with pytest.raises(RuntimeError):
                lchain_dp_chunked(*planes, *args, window=128, tile=128)


def test_chain_chunked_kernel_rejects_bad_shapes(card):
    planes = [t.to(card) for t in synth_planes(np.random.default_rng(2), 2,
                                               256)]
    args = (MDX, MDY, BW, MAX_SKIP, MAX_ITER, PEN_GAP, PEN_SKIP)
    for W, T in ((160, 32), (2112, 64)):
        with pytest.raises(ValueError):
            lchain_dp_chunked(*planes, *args, window=W, tile=T)


def gap_pairs(rng, n, max_len):
    """Target/query pairs of mixed lengths: diverged copies (substitutions
    and short indels), unrelated sequences and out-of-band skews."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k in range(n):
        t = rng.choice(acgt, int(rng.integers(1, max_len + 1)))
        if k % 8 == 7:
            q = rng.choice(acgt, max(1, len(t) + int(rng.integers(-40, 41))))
        else:
            q = t.copy()
            sub = rng.random(len(q)) < 0.03
            q[sub] = rng.choice(acgt, int(sub.sum()))
            for _ in range(int(rng.integers(0, 4))):
                p = int(rng.integers(0, len(q)))
                q = np.concatenate([q[:p], rng.choice(acgt, int(rng.integers(
                    0, 3))), q[p + int(rng.integers(0, 3)):]])
        pairs.append((t.tobytes(), q.tobytes()))
    pairs.append((b"ACGT" * 100, b"ACGT"))       # beyond every band
    return pairs


@pytest.mark.parametrize("wa", [32, 64, 96, 128])
def test_wfa_banded_kernel_matches_ref(card, wa):
    pairs = gap_pairs(np.random.default_rng(wa), 96, 2048)
    planes = encode_pairs(pairs, card)
    before = kernels.launches["wfa_banded"]
    got = banded_score_planes(*planes, wa=wa)
    assert kernels.launches["wfa_banded"] == before + 1
    ref = banded_score_ref(*planes, wa=wa)
    assert torch.equal(got, ref)
    assert (got < 1 << 28).any() and (got >= 1 << 28).any()


def edge_gap_pairs(rng, wa):
    """Length skews of wa - 3 .. wa either way (the end cell leaves the
    band among them), empty sequences, one length 0, diverged copies;
    an odd count, so the last warp is part full."""
    acgt = np.frombuffer(b"ACGT", np.uint8)

    def rnd(n):
        return rng.choice(acgt, n).tobytes()
    pairs = [(b"", b""), (b"", b"ACG"), (b"ACGTA", b""), (b"A", b"A"),
             (b"A", b"C")]
    for d in (wa - 3, wa - 2, wa - 1, wa):
        n = int(rng.integers(20, 600))
        pairs += [(rnd(n + d), rnd(n)), (rnd(n), rnd(n + d))]
    for _ in range(40):
        t = rng.choice(acgt, int(rng.integers(30, 2048)))
        q = t.copy()
        sub = rng.random(len(q)) < 0.03
        q[sub] = rng.choice(acgt, int(sub.sum()))
        p = int(rng.integers(0, len(q) - 5))
        q = np.concatenate([q[:p], q[p + int(rng.integers(0, 5)):]])
        pairs.append((t.tobytes(), q.tobytes()))
    if len(pairs) % 2 == 0:
        pairs.append((b"ACGT" * 30, b"ACGT"))
    return pairs


@pytest.mark.parametrize("wa", [32, 64, 96, 128])
def test_wfa_banded_kernel_edges(card, wa):
    planes = encode_pairs(edge_gap_pairs(np.random.default_rng(wa), wa),
                          card)
    got = banded_score_planes(*planes, wa=wa)
    ref = banded_score_ref(*planes, wa=wa)
    assert torch.equal(got, ref)
    assert (ref < 1 << 28).sum() >= 20 and (ref >= 1 << 28).any()


def test_wfa_banded_kernel_rejects_odd_band(card):
    planes = encode_pairs([(b"ACGT", b"ACGA")], card)
    with pytest.raises(ValueError):
        banded_score_planes(*planes, wa=48)


def probe_inputs(rng, nb, qb, kb, B, occ_cap=4, empty=0.0):
    """Unique keys per bucket, payload integers below 2^23, query slots
    with hits, misses, and all-zero (empty) or -1 (unused) slots."""
    ext = 2 + 3 * occ_cap
    km = np.zeros((nb, 9, kb), np.float32)
    km[:, 8, :] = 1.0
    ke = np.zeros((nb, ext, kb), np.float32)
    sq = np.full((9, B, nb * qb), empty, np.float32)

    def feats(m):
        c = np.stack([(m >> (9 * i)) & 0x1FF for i in range(4)], -1) \
            .astype(np.float32)
        cols = []
        for i in range(4):
            cols += [c[:, i] * c[:, i], c[:, i]]
        return np.stack(cols + [np.ones(len(m), np.float32)]), c

    for v in range(nb):
        n_keys = int(rng.integers(kb // 2, kb + 1))
        keys = np.unique(rng.integers(0, (1 << 34) // nb, 2 * n_keys)
                         * nb + v)[:n_keys]
        n_keys = len(keys)
        f, c = feats(keys)
        km[v, 1:8:2, :n_keys] = -2.0 * c.T
        km[v, 0:8:2, :n_keys] = 1.0
        km[v, 8, :n_keys] = (c ** 2).sum(1)
        ke[v, :, :n_keys] = rng.integers(0, 1 << 23, (ext, n_keys))
        ke[v, 1, :n_keys] = 1.0
        for b in range(B):
            n = int(rng.integers(0, qb + 1))
            m = np.where(rng.random(n) < 0.6, rng.choice(keys, n),
                         rng.integers(0, 1 << 30, n) * nb + v)
            sq[:, b, v * qb: v * qb + n] = feats(m)[0]
    return [torch.from_numpy(a) for a in (sq, km, ke)]


@pytest.mark.parametrize("nb,qb,kb,B", [(4, 8, 512, 8), (64, 24, 1024, 16),
                                        (1, 5, 300, 3)])
def test_probe_bucketed_kernel_matches_ref(card, nb, qb, kb, B):
    sq, km, ke = (t.to(card) for t in probe_inputs(
        np.random.default_rng(nb + kb), nb, qb, kb, B))
    before = kernels.launches["probe_bucketed"]
    got = probe_bucketed(sq, km, ke)
    assert kernels.launches["probe_bucketed"] == before + 1
    ref = probe_bucketed_ref(sq, km, ke)
    present = sq[8] != 0
    assert torch.equal(got[:, present], ref[:, present])
    torch.testing.assert_close(got[:, ~present], ref[:, ~present],
                               rtol=kb * 2.0 ** -24, atol=0)


def test_probe_bucketed_kernel_edges(card):
    """A bucket with no present slot, KB not a multiple of the kernel's
    key chunk, more present slots in a bucket than one block's tile, and
    matches in the last key of a bucket."""
    nb, qb, kb, B = 4, 16, 700, 64
    rng = np.random.default_rng(11)
    sq, km, ke = (t.numpy().copy() for t in probe_inputs(rng, nb, qb, kb, B))
    # the last column of bucket 0 holds a key no other column holds
    c = np.array([((1 << 35) >> (9 * i)) & 0x1FF for i in range(4)],
                 np.float32)
    km[0, 0:8:2, kb - 1] = 1.0
    km[0, 1:8:2, kb - 1] = -2.0 * c
    km[0, 8, kb - 1] = (c ** 2).sum()
    ke[0, :, kb - 1] = rng.integers(0, 1 << 23, ke.shape[1])
    ke[0, 1, kb - 1] = 1.0
    # every slot of bucket 0 present (B * qb = 1024 slots), each the key
    # of one of its columns (padding columns match nothing)
    cols = rng.integers(0, kb, B * qb)
    cols[::7] = kb - 1
    cq = -km[0][1:8:2][:, cols] / 2.0
    q = np.empty((9, B * qb), np.float32)
    q[0:8:2], q[1:8:2], q[8] = cq * cq, cq, 1.0
    sq[:, :, :qb] = q.reshape(9, B, qb)
    sq[:, :, 2 * qb: 3 * qb] = 0.0          # bucket 2: all slots empty
    sq, km, ke = (torch.from_numpy(a).to(card) for a in (sq, km, ke))
    got = probe_bucketed(sq, km, ke)
    ref = probe_bucketed_ref(sq, km, ke)
    present = sq[8] != 0
    assert int(present[:, :qb].sum()) == B * qb
    assert torch.equal(got[:, present], ref[:, present])
    torch.testing.assert_close(got[:, ~present], ref[:, ~present],
                               rtol=kb * 2.0 ** -24, atol=0)
    last = torch.from_numpy(cols == kb - 1).to(card).reshape(B, qb)
    assert bool((got[1][:, :qb][last] == 1).all())
    assert torch.equal(got[:, :, 2 * qb: 3 * qb],
                       ref[:, :, 2 * qb: 3 * qb])


def test_probe_kernel_repeated_keys(card):
    """Keys held twice or three times in a bucket: a slot that matches
    several keys gets their payloads summed in key order (payloads below
    2^20, so every order gives the same exact sum)."""
    nb, qb, kb, B = 2, 32, 600, 16
    rng = np.random.default_rng(12)
    sq, km, ke = (t.numpy().copy() for t in probe_inputs(rng, nb, qb, kb, B))
    ke %= 1 << 20
    for src, dst in ((3, 590), (3, 599), (17, 300), (40, 41)):
        km[0, :, dst] = km[0, :, src]
        ke[0, :, dst] = rng.integers(0, 1 << 20, ke.shape[1])
        ke[0, 1, dst] = 1.0
    cols = np.array([3, 17, 40, 5] * (B * qb // 4))
    cq = -km[0][1:8:2][:, cols] / 2.0
    q = np.empty((9, B * qb), np.float32)
    q[0:8:2], q[1:8:2], q[8] = cq * cq, cq, 1.0
    sq[:, :, :qb] = q.reshape(9, B, qb)
    sq, km, ke = (torch.from_numpy(a).to(card) for a in (sq, km, ke))
    got = probe_bucketed(sq, km, ke)
    ref = probe_bucketed_ref(sq, km, ke)
    present = sq[8] != 0
    assert torch.equal(got[:, present], ref[:, present])
    # ext[1] counts the matched keys: 3, 2, 2 and 1
    assert sorted(set(got[1][:, :4].flatten().tolist())) == [1.0, 2.0, 3.0]


@pytest.mark.parametrize("qcap,kpad,B", [(24, 512, 8), (384, 2048, 16)])
def test_probe_flat_kernel_matches_ref(card, qcap, kpad, B):
    sq, km, ke = (t.to(card) for t in probe_inputs(
        np.random.default_rng(qcap), 1, qcap, kpad, B, occ_cap=16,
        empty=-1.0))
    before = kernels.launches["probe_flat"]
    got = probe_flat(sq, km, ke)
    assert kernels.launches["probe_flat"] == before + 1
    assert torch.equal(got, probe_flat_ref(sq, km, ke))


def test_map_files_on_card_matches_host(card, tmp_path):
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.mapping.mapper import map_files
    from minigraph_tpu_torch.options import IndexOptions, MapOptions
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa,
                                                 write_fasta)
    ref = make_reference(300_000, seed=3)
    hap = write_bubble_rgfa(ref, 4, str(tmp_path / "g.gfa"), seg_len=20_000)
    write_fasta(str(tmp_path / "r.fa"),
                simulate_reads([hap], 60, seed=5, mean_len=1500,
                               min_len=300, max_len=6000))
    outs = {}
    for dev in ("cuda", None):
        buf = io.StringIO()
        map_files(read_gfa(str(tmp_path / "g.gfa")), [str(tmp_path / "r.fa")],
                  IndexOptions(), MapOptions(), out=buf, n_threads=2,
                  device=dev)
        outs[dev] = buf.getvalue()
    assert outs["cuda"] == outs[None]
    assert outs[None].count("\n") >= 50


BT_KEYS = ("c_axh", "c_axl", "c_ayh", "c_ayl", "u_sc", "u_cnt", "n_u", "n_v",
           "bt_unsure", "steps")


def bt_planes(rng, B, A):
    """Backtrack inputs: random parent forests whose f values rise and
    fall (tests/test_backtrack_device.py's fuzz), an empty lane, a lane
    of n_a = A, a lane of 100 three-anchor chains (over ucap = 64), a
    lane of few distinct f values (interacting equal-f ties) and a lane
    of kept chains two of which start at one x."""
    F = np.zeros((B, A), np.int32)
    P = np.full((B, A), -1, np.int32)
    NA = np.zeros(B, np.int32)
    for b in range(1, B):
        n = A if b == 1 else int(rng.integers(min(20, A), A + 1))
        NA[b] = n
        lo, hi, step = (40, 44, (0, 3)) if b == 3 else (10, 80, (-40, 60))
        for i in range(n):
            if i and rng.random() < 0.9:
                j = int(rng.integers(max(0, i - 12), i))
                P[b, i] = j
                F[b, i] = F[b, j] + int(rng.integers(*step))
            else:
                F[b, i] = int(rng.integers(lo, hi))
    if A >= 300 and B > 2:
        NA[2] = 300
        F[2, :300], P[2, :300] = 0, -1
        for c in range(100):
            i = 3 * c
            F[2, i: i + 3] = [5, 20, 45 + c % 10]
            P[2, i + 1: i + 3] = [i, i + 1]
    ax = np.sort(rng.integers(0, 1 << 33, (B, A)), axis=1)
    if A >= 300 and B > 4:
        # lane 4: twenty kept three-anchor chains, the first anchors of
        # chains 3 and 10 at one x (flagged, build order kept)
        NA[4] = 60
        F[4], P[4] = 0, -1
        for c in range(20):
            i = 3 * c
            F[4, i: i + 3] = [5, 20, 45 + (7 * c) % 20]
            P[4, i + 1: i + 3] = [i, i + 1]
        ax[4, 9] = ax[4, 30]
    ay = rng.integers(0, 1 << 40, (B, A))
    planes = [ax >> 32, ax & 0xFFFFFFFF, ay >> 32, ay & 0xFFFFFFFF]
    return [torch.from_numpy(x).cuda() for x in (F, P, NA, *planes)]


@pytest.mark.parametrize("max_steps", [None, 64])
@pytest.mark.parametrize("A,B", [(16, 6), (512, 16), (2048, 8), (5376, 6)])
def test_backtrack_kernel_matches_ref(card, A, B, max_steps):
    args = bt_planes(np.random.default_rng(A), B, A)
    kw = dict(min_cnt=3, min_sc=40, max_drop=60, ucap=64,
              max_steps=max_steps)
    got = backtrack_compact(*args, **kw)
    ref = backtrack_compact_ref(*args, **kw)
    torch.cuda.synchronize()
    for key in BT_KEYS:
        assert torch.equal(got[key], ref[key]), key
    assert int(got["n_u"].sum()) > 0
    if max_steps:
        assert got["bt_unsure"][got["steps"] >= max_steps].all()
        assert A == 16 or (got["steps"] >= max_steps).any()
    if A >= 300 and max_steps is None:
        assert int(got["n_u"][2]) == 64 and got["bt_unsure"][2]
        assert int(got["n_u"][4]) == 20 and got["bt_unsure"][4]


def test_backtrack_kernel_clock(card):
    """The clock buffer takes four positive phase cycle counts a block
    and changes no output; a wrongly shaped buffer is refused."""
    args = bt_planes(np.random.default_rng(9), 8, 2048)
    kw = dict(min_cnt=3, min_sc=40, max_drop=60, ucap=64)
    clk = torch.zeros((8, 4), dtype=torch.int64, device="cuda")
    kernels.reset_launches()
    got = backtrack_compact(*args, clock=clk, **kw)
    ref = backtrack_compact(*args, **kw)
    assert kernels.launches["backtrack"] == 2
    for key in BT_KEYS:
        assert torch.equal(got[key], ref[key]), key
    assert bool((clk > 0).all())
    with pytest.raises(ValueError):
        backtrack_compact(*args, clock=clk[:4], **kw)


def test_backtrack_kernel_shared_memory_limit(card):
    """Past the 227 KB a block may hold the wrapper refuses the shape;
    the widest that fits (A = 8192: its sort takes 8192 keys, one more
    anchor doubles them) runs and agrees with the plain version."""
    from minigraph_tpu_torch.ops.backtrack import SMEM_LIMIT, walk_smem_bytes
    A = 8192
    assert walk_smem_bytes(A, 64) <= SMEM_LIMIT < walk_smem_bytes(A + 1, 64)
    args = bt_planes(np.random.default_rng(5), 3, A)
    kw = dict(min_cnt=3, min_sc=40, max_drop=60, ucap=64)
    got = backtrack_compact(*args, **kw)
    ref = backtrack_compact_ref(*args, **kw)
    for key in BT_KEYS:
        assert torch.equal(got[key], ref[key]), key
    wide = bt_planes(np.random.default_rng(6), 2, A + 1)
    with pytest.raises(ValueError):
        backtrack_compact(*wide, **kw)


def test_front_launches_backtrack_once_a_batch(card, tmp_path):
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.mapping.device_front import DeviceFront
    from minigraph_tpu_torch.options import MapOptions
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa)
    ref = make_reference(300_000, seed=8)
    hap = write_bubble_rgfa(ref, 9, str(tmp_path / "g.gfa"), seg_len=20_000)
    reads = [s for _, s in simulate_reads([hap], 40, seed=10, mean_len=3000,
                                          min_len=300, max_len=9000)]
    mo = MapOptions()
    front = DeviceFront(build_index(read_gfa(str(tmp_path / "g.gfa")), 17,
                                    11, mo), mo, device="cuda",
                        buckets=((2048, 16), (8192, 8), (32768, 8)))
    kernels.reset_launches()
    out = front.gather(front.submit(reads))
    assert front.n_batches >= 3
    assert kernels.launches["backtrack"] == front.n_batches
    assert sum(fr is not None for fr in out) >= 20


def test_front_staging_on_card(card, tmp_path):
    """The front's packed words reach the host through one asynchronous
    copy a bucket batch into pinned memory from its pool: the staged
    buffers are pinned; two handles in flight (submit k, submit k + 1,
    gather k, gather k + 1) give the blobs of one handle at a time and
    never share a buffer; once warm, further batches allocate no pinned
    memory (the front's stage_pinned_bytes)."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.mapping import device_front as dfm
    from minigraph_tpu_torch.options import MapOptions
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa)
    ref = make_reference(300_000, seed=16)
    hap = write_bubble_rgfa(ref, 17, str(tmp_path / "g.gfa"), seg_len=20_000)
    reads = [s for _, s in simulate_reads([hap], 80, seed=18, mean_len=3000,
                                          min_len=300, max_len=9000)]
    part = (reads[:40], reads[40:])
    mo = MapOptions()
    front = dfm.DeviceFront(build_index(read_gfa(str(tmp_path / "g.gfa")),
                                        17, 11, mo), mo, device="cuda",
                            buckets=((2048, 16), (8192, 8), (32768, 8)))

    def words(flat, n):
        out = [None] * n
        for pos, blob in flat:
            for j, ri in enumerate(pos.tolist()):
                p0, na = int(blob["prefix"][j]), int(blob["n_a"][j])
                m0, nm = int(blob["mprefix"][j]), int(blob["n_mini"][j])
                u0, nu = int(blob["uprefix"][j]), int(blob["n_u"][j])
                out[ri] = (blob["AX"][p0: p0 + na].copy(),
                           blob["AY"][p0: p0 + na].copy(),
                           blob["MINI"][m0: m0 + nm].copy(),
                           blob["U"][u0: u0 + nu].copy())
        return out

    def spans(handle):
        """The byte ranges of a handle's staged buffers."""
        out = []
        for entry in handle[1]:
            lease = entry[1].base
            assert isinstance(lease, dfm._Lease)
            assert lease.tensor.is_pinned()
            ptr = lease.tensor.data_ptr()
            out.append((ptr, ptr + lease.tensor.numel() * 8))
        return out

    one = [words(front.gather_flat(front.submit(p)), len(p)) for p in part]
    h0 = front.submit(part[0])
    h1 = front.submit(part[1])
    s0, s1 = spans(h0), spans(h1)
    assert all(b <= c or d <= a for a, b in s0 for c, d in s1)
    two = [words(front.gather_flat(h), len(p)) for h, p in ((h0, part[0]),
                                                            (h1, part[1]))]
    del h0, h1
    n_dev = 0
    for a, b in zip(one, two):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                n_dev += 1
                for u, v in zip(x, y):
                    assert u.dtype == v.dtype and np.array_equal(u, v)
    assert n_dev >= 40
    # warm: the same shapes again take their buffers back from the pool
    pinned = front.stage_pinned_bytes
    assert pinned > 0 and front.stage_bytes >= pinned
    for _ in range(3):
        for p in part:
            front.gather_flat(front.submit(p))
    assert front.stage_pinned_bytes == pinned


@pytest.mark.parametrize("preset", ["asm", "rmq"])
def test_seed_only_front_on_card(card, tmp_path, preset):
    """asm (k = 19, the wide-key hash join) and --rmq: the seed-only
    front launches the sketch kernel and no chain or backtrack kernel,
    its anchors equal the native collect's, and map_files on the card
    writes the host run's bytes."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.mapping.device_front import DeviceFront
    from minigraph_tpu_torch.mapping.mapper import map_files
    from minigraph_tpu_torch.mapping.seeds import collect_native
    from minigraph_tpu_torch.options import (MG_M_RMQ, IndexOptions,
                                             MapOptions, opt_set)
    from minigraph_tpu_torch.tools.synth import (cut_contigs, make_haplotype,
                                                 make_reference,
                                                 write_bubble_rgfa,
                                                 write_fasta)
    ref = make_reference(300_000, seed=12)
    write_bubble_rgfa(ref, 13, str(tmp_path / "g.gfa"), seg_len=20_000)
    io_, mo = IndexOptions(), MapOptions()
    if preset == "asm":
        opt_set("asm", io_, mo)
    else:
        mo.flag |= MG_M_RMQ
    ctg = cut_contigs(make_haplotype(ref, 14), 15, mean_len=5000,
                      min_len=500, max_len=30000, long_every=20,
                      long_len=40000)
    write_fasta(str(tmp_path / "q.fa"), ctg)
    gi = build_index(read_gfa(str(tmp_path / "g.gfa")), io_.k, io_.w, mo)
    front = DeviceFront(gi, mo, device="cuda")
    seqs = [s for _, s in ctg if len(s) <= 32768]
    kernels.reset_launches()
    out = front.gather(front.submit(seqs))
    assert kernels.launches["sketch"] == front.n_batches >= 2
    for name in ("chain_exact", "chain_chunked", "backtrack"):
        assert kernels.launches[name] == 0, name
    n = 0
    for seq, fr in zip(seqs, out):
        if fr is None:
            continue
        ax, ay, rep_len, mini_pos, n_mv = collect_native(gi, mo, mo.occ_max1,
                                                         seq)
        assert np.array_equal(fr.ax, ax) and np.array_equal(fr.ay, ay)
        assert np.array_equal(np.asarray(fr.mini_pos, np.int64), mini_pos)
        assert (fr.rep_len, fr.n_mv, fr.u) == (rep_len, n_mv, None)
        n += 1
    assert n >= len(seqs) // 2
    outs = {}
    for dev in ("cuda", None):
        buf = io.StringIO()
        map_files(read_gfa(str(tmp_path / "g.gfa")), [str(tmp_path / "q.fa")],
                  io_, mo, out=buf, n_threads=2, device=dev)
        outs[dev] = buf.getvalue()
    assert outs["cuda"] == outs[None]
    assert outs[None].count("\n") >= 20


def wfa_gap_pairs(rng, n, lo, hi):
    """Gap pairs of lo-hi bp: 2% substitutions, 1% indels of 1-3 bp,
    every 5th query cut short by 20-80 bp, an exact pair, a homopolymer
    against one base."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pairs = [(b"ACGT" * (lo // 4), b"ACGT" * (lo // 4)),
             (b"A", b"T" * lo)]
    for k in range(n - 2):
        t = rng.choice(acgt, int(rng.integers(lo, hi + 1)))
        q = t.copy()
        sub = rng.random(len(q)) < 0.02
        q[sub] = rng.choice(acgt, int(sub.sum()))
        for pos in sorted(rng.choice(len(q), len(q) // 100, replace=False),
                          reverse=True):
            q = np.insert(q, pos, rng.choice(acgt, 2)) if pos % 2 \
                else np.delete(q, pos)
        if k % 5 == 4:
            q = q[: len(q) - int(rng.integers(20, 81))]
        pairs.append((t.tobytes(), q[:hi].tobytes()))
    return pairs


@pytest.mark.parametrize("lmax,s_cap,B", [(192, 400, 24), (768, 1024, 64),
                                          (2048, 3072, 16), (192, 60, 24)])
def test_wfa_exact_kernels_match_ref(card, lmax, s_cap, B):
    """wfa_wave and wfa_walk against the plain versions: score, end_d,
    no_ext, ops and fin_i/fin_k whole, tb on the rows below each score;
    the walk on the kernel's tb and on the plain version's; at the last
    shape a score budget some pairs exceed."""
    from minigraph_tpu_torch.ops import wfa_exact as wx
    pens = (4, 4, 2, 15, 1)
    pairs = wfa_gap_pairs(np.random.default_rng(lmax + s_cap), B, lmax // 3,
                      lmax)
    enc = wx.encode_pairs(pairs, L=lmax, device="cuda")
    kernels.reset_launches()
    got = wx.wfa_device(*enc, pens, d_cap=lmax, s_cap=s_cap)
    ref = wx.wfa_device_ref(*enc, pens, d_cap=lmax, s_cap=s_cap)
    assert kernels.launches["wfa_wave"] == 1
    for i in (0, 2, 3, 4):
        assert torch.equal(got[i], ref[i]), i
    score = got[0].cpu()
    assert (score >= 0).any()
    if s_cap == 60:
        assert (score < 0).any()
    for b in range(B):
        n = int(score[b]) if score[b] >= 0 else s_cap
        assert torch.equal(got[1][:n, b], ref[1][:n, b]), b
    t_cap = 2 * lmax + 4
    walk = wx.wfa_tb_walk(*enc, got[1], got[0], got[3], got[4], pens,
                          d_cap=lmax, t_cap=t_cap)
    assert kernels.launches["wfa_walk"] == 1
    for tb_src in (got, ref):
        want = wx.wfa_tb_walk_ref(*enc, tb_src[1], tb_src[0], tb_src[3],
                                  tb_src[4], pens, d_cap=lmax, t_cap=t_cap)
        for a, b in zip(walk, want):
            assert torch.equal(a, b)
    # a second call reuses the tb plane and gives the same results
    again = wx.wfa_device(*enc, pens, d_cap=lmax, s_cap=s_cap, tb=got[1])
    assert again[1] is got[1] and torch.equal(again[0], got[0])


def test_wfa_exact_kernels_edges(card):
    """Empty and one-base sequences, a query of pads' length, and
    malformed shapes refused."""
    from minigraph_tpu_torch.ops import wfa_exact as wx
    pens = (4, 4, 2, 15, 1)
    pairs = [(b"A", b"A"), (b"A", b"C"), (b"", b"ACGT"), (b"ACGT", b""),
             (b"AC" * 32, b"CA" * 32), (b"T" * 64, b"T" * 64)]
    enc = wx.encode_pairs(pairs, L=64, device="cuda")
    got = wx.wfa_device(*enc, pens, d_cap=64, s_cap=200)
    ref = wx.wfa_device_ref(*enc, pens, d_cap=64, s_cap=200)
    for i in (0, 2, 3, 4):
        assert torch.equal(got[i], ref[i]), i
    walk = wx.wfa_tb_walk(*enc, got[1], got[0], got[3], got[4], pens,
                          d_cap=64, t_cap=132)
    want = wx.wfa_tb_walk_ref(*enc, ref[1], ref[0], ref[3], ref[4], pens,
                              d_cap=64, t_cap=132)
    for a, b in zip(walk, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        wx.wfa_device(enc[0], enc[1], enc[2][:, :10], enc[3], pens,
                      d_cap=64, s_cap=200)
    with pytest.raises(ValueError):
        wx.wfa_device(*enc, pens, d_cap=64, s_cap=200, tb=got[1][:10])


def test_wfa_exact_kernels_clock_and_budget(card):
    """At the widest bucket's D = 4097: unrelated 2048 bp sequences whose
    score reaches s_cap (the ring's drift at its deepest) beside gap
    pairs, against the plain versions; then the clock buffers, which
    leave every output as it was: a pair's steps are its score + 1 (all
    s_cap where the budget ran out), its phases fit in its cycles, the
    walk's steps are its ops and its tb reads at most its steps + 1."""
    from minigraph_tpu_torch.ops import wfa_exact as wx
    pens, lmax, s_cap = (4, 4, 2, 15, 1), 2048, 600
    rng = np.random.default_rng(61)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    far = [(rng.choice(acgt, lmax).tobytes(), rng.choice(acgt, lmax)
            .tobytes()) for _ in range(2)]
    pairs = far + wfa_gap_pairs(rng, 6, 700, 2048)
    enc = wx.encode_pairs(pairs, L=lmax, device="cuda")
    got = wx.wfa_device(*enc, pens, d_cap=lmax, s_cap=s_cap)
    ref = wx.wfa_device_ref(*enc, pens, d_cap=lmax, s_cap=s_cap)
    for i in (0, 2, 3, 4):
        assert torch.equal(got[i], ref[i]), i
    score = got[0].cpu()
    assert (score[:2] < 0).all() and (score[2:] >= 0).any()
    for b in range(len(pairs)):
        n = int(score[b]) if score[b] >= 0 else s_cap
        assert torch.equal(got[1][:n, b], ref[1][:n, b]), b
    t_cap = 2 * lmax + 4
    walk = wx.wfa_tb_walk(*enc, got[1], got[0], got[3], got[4], pens,
                          d_cap=lmax, t_cap=t_cap)
    want = wx.wfa_tb_walk_ref(*enc, ref[1], ref[0], ref[3], ref[4], pens,
                              d_cap=lmax, t_cap=t_cap)
    for a, b in zip(walk, want):
        assert torch.equal(a, b)
    B = len(pairs)
    cw = torch.full((B, len(wx.WAVE_CLK)), -7, dtype=torch.int64,
                    device="cuda")
    ck = torch.zeros((B, len(wx.WALK_CLK)), dtype=torch.int64,
                     device="cuda")
    again = wx.wfa_device(*enc, pens, d_cap=lmax, s_cap=s_cap, tb=got[1],
                          clock=cw)
    for i in (0, 3, 4):
        assert torch.equal(again[i], got[i]), i
    walk2 = wx.wfa_tb_walk(*enc, got[1], got[0], got[3], got[4], pens,
                           d_cap=lmax, t_cap=t_cap, clock=ck)
    for a, b in zip(walk2, walk):
        assert torch.equal(a, b)
    cw, ck = cw.cpu(), ck.cpu()
    c = {n: cw[:, i] for i, n in enumerate(wx.WAVE_CLK)}
    steps = torch.where(score >= 0, score + 1, torch.full_like(score, s_cap))
    assert torch.equal(c["steps"], steps.long())
    assert (c["cycles"] > 0).all() and (c["ext_iter"] > 0).all()
    assert (c["ext"] + c["end"] + c["wave"] <= c["cycles"]).all()
    k = {n: ck[:, i] for i, n in enumerate(wx.WALK_CLK)}
    assert torch.equal(k["steps"], (walk[0].cpu() > 0).sum(0).long())
    assert (k["tb_reads"] <= k["steps"] + 1).all()
    assert (k["cycles"][score >= 0] > 0).all()
    with pytest.raises(ValueError):
        wx.wfa_device(*enc, pens, d_cap=lmax, s_cap=s_cap, clock=cw.cuda()
                      [:, :3])
    with pytest.raises(ValueError):         # the int16 ring's limit
        wx.wfa_device(*enc, pens, d_cap=lmax, s_cap=32767)


def test_gap_pool_on_card_matches_cpu(card):
    """DeviceWfaPool on the card against the same pool on the CPU (its
    plain versions), result for result, with the launches counted."""
    from minigraph_tpu_torch.align.cigar_device import DeviceWfaPool
    rng = np.random.default_rng(3)
    jobs = wfa_gap_pairs(rng, 40, 40, 200) + [(b"ACGT" * 10, b"AC")]
    buckets = ((64, 80, 8), (192, 240, 8))
    pool = DeviceWfaPool(buckets=buckets, device="cuda")
    kernels.reset_launches()
    got = pool.run(jobs)
    cpu = DeviceWfaPool(buckets=buckets, device="cpu")
    assert got == cpu.run(jobs)
    assert (pool.n_device, pool.n_host) == (cpu.n_device, cpu.n_host)
    assert pool.n_device > 0
    assert kernels.launches["wfa_wave"] == kernels.launches["wfa_walk"] > 0


# ---- the GWFA bridge kernel (csrc/gwfa.cu)

@pytest.fixture(scope="module")
def gwfa_graphs(tmp_path_factory):
    """A 300 kb bubble graph of 5 kb segments and a star graph with a
    vertex of degree 8, each with its edseqs."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 write_bubble_rgfa,
                                                 write_star_gfa)
    d = tmp_path_factory.mktemp("gwfa")
    write_bubble_rgfa(make_reference(300_000, seed=5), 6, str(d / "g.gfa"),
                      seg_len=5000, bubble_every=2)
    write_star_gfa(str(d / "star.gfa"), 7)
    out = {}
    for name in ("g", "star"):
        g = read_gfa(str(d / f"{name}.gfa"))
        out[name] = (g, build_index(g, 15, 10).es)
    return out


def gwfa_jobs(graph, seed, qcap, n=16):
    """Bridge jobs of the bucket (qcap / 4, qcap] (or up to 256) at
    mutation rates 3, 8 and 25, n of them."""
    from minigraph_tpu_torch.tools.synth import bridge_jobs
    g, es = graph
    rng = np.random.default_rng(seed)
    lo = 0 if qcap <= 256 else 256
    jobs = []
    while len(jobs) < n:
        for mrate in (3, 8, 25):
            jobs += [j for j in bridge_jobs(g, es, rng, 8, mrate, qcap)
                     if len(j[0]) > lo]
    return jobs[:n]


def gwfa_check(graph, jobs, qcap, J=None, degcap=6, **caps):
    """The kernel on the jobs packed for the card (one launch), bitwise
    against the plain version on the CPU."""
    from minigraph_tpu_torch.ops import gwfa as gw
    g, es = graph
    gd, _ = gw.build_device_graph(g, es, degcap)
    args = gw.pack_jobs(jobs, qcap, J)
    want = gw.gwfa_batch_ref(gd, *args, degcap=degcap, **caps)
    gdc = gd.to("cuda")
    cargs = gw.pack_jobs(jobs, qcap, J, device="cuda")
    n0 = kernels.launches["gwfa"]
    got = gw.gwfa_batch(gdc, *cargs, degcap=degcap, **caps)
    torch.cuda.synchronize()
    assert kernels.launches["gwfa"] == n0 + 1
    for key in ("s", "flags", "walk", "n_walk"):
        assert torch.equal(got[key].cpu(), want[key]), key
    return want


@pytest.mark.parametrize("qcap", [256, 1024])
def test_gwfa_kernel_matches_ref(card, gwfa_graphs, qcap):
    want = gwfa_check(gwfa_graphs["g"], gwfa_jobs(gwfa_graphs["g"], qcap,
                                                  qcap), qcap)
    assert int((want["flags"] == 0).sum()) >= 8
    assert int((want["s"] >= 0).sum()) >= 4


@pytest.mark.parametrize("qcap,seed", [(256, 105), (1024, 102)])
def test_gwfa_kernel_ties(card, gwfa_graphs, qcap, seed):
    """Batches with a tainted winning lineage (F_TIE)."""
    want = gwfa_check(gwfa_graphs["g"], gwfa_jobs(gwfa_graphs["g"], seed,
                                                  qcap), qcap)
    assert int((want["flags"] & 1).sum()) > 0


@pytest.mark.parametrize("caps", [
    dict(degcap=1, dcap=64, evcap=64),
    dict(hopcap=1),
    dict(dcap=16, evcap=16, ccap=32),
    dict(tcap=8),
    dict(fcap=8),
    dict(max_steps=4),
], ids=["degcap1", "hopcap1", "ccap32", "tcap8", "fcap8", "steps4"])
def test_gwfa_kernel_flag_caps(card, gwfa_graphs, caps):
    """Reduced caps that make each flag bit fire: flags and the other
    outputs equal the plain version's."""
    want = gwfa_check(gwfa_graphs["g"], gwfa_jobs(gwfa_graphs["g"], 11,
                                                  256), 256, **caps)
    assert int((want["flags"] != 0).sum()) > 0


def test_gwfa_kernel_padded_batch(card, gwfa_graphs):
    """Five jobs padded to 32 with one-base pad jobs, and an empty batch,
    which launches nothing and so counts no launch."""
    from minigraph_tpu_torch.ops import gwfa as gw
    gwfa_check(gwfa_graphs["g"], gwfa_jobs(gwfa_graphs["g"], 12, 256, 5),
               256, J=32)
    g, es = gwfa_graphs["g"]
    gd, _ = gw.build_device_graph(g, es)
    n0 = kernels.launches["gwfa"]
    res = gw.gwfa_batch(gd.to("cuda"),
                        *gw.pack_jobs([], 256, 0, device="cuda"))
    assert res["s"].shape == (0,)
    assert kernels.launches["gwfa"] == n0


def test_gwfa_kernel_eighty_jobs(card, gwfa_graphs):
    """An 80-job launch at QCAP 256, the shape of the pool's one call a
    batch, with one job a pad."""
    want = gwfa_check(gwfa_graphs["g"], gwfa_jobs(gwfa_graphs["g"], 80,
                                                  256, 79), 256, J=80)
    assert int((want["flags"] == 0).sum()) >= 40


def test_gwfa_kernel_clock(card, gwfa_graphs):
    """The clock buffer leaves the outputs as they are and takes each
    job's phase cycles, synchronisations and waves."""
    from minigraph_tpu_torch.ops import gwfa as gw
    g, es = gwfa_graphs["g"]
    gd, _ = gw.build_device_graph(g, es)
    gd = gd.to("cuda")
    args = gw.pack_jobs(gwfa_jobs(gwfa_graphs["g"], 14, 256), 256,
                        device="cuda")
    want = gw.gwfa_batch(gd, *args)
    clk = torch.zeros((16, gw.CLK_N), dtype=torch.int64, device="cuda")
    got = gw.gwfa_batch(gd, *args, clock=clk)
    for key in ("s", "flags", "walk", "n_walk"):
        assert torch.equal(got[key], want[key]), key
    col = {c: clk[:, i].cpu() for i, c in enumerate(gw.CLK_COLUMNS)}
    assert bool((sum(col[p] for p in gw.CLK_PHASES) > 0).all())
    assert bool((col["steps"] >= 1).all())
    assert bool((col["waves"] >= col["steps"]).all())
    assert bool((col["syncs"] > 0).all())


def test_gwfa_kernel_high_degree(card, gwfa_graphs):
    """A vertex of degree 8 at degcap 6 (F_DEG) and at degcap 8."""
    from minigraph_tpu_torch.tools.synth import bridge_jobs
    g, es = gwfa_graphs["star"]
    rng = np.random.default_rng(13)
    jobs = bridge_jobs(g, es, rng, 24, 8, 1024)[:16]
    want = gwfa_check(gwfa_graphs["star"], jobs, 1024)
    assert int(((want["flags"] & 8) != 0).sum()) > 0
    gwfa_check(gwfa_graphs["star"], jobs, 1024, degcap=8, dcap=256,
               evcap=128)


def test_gwfa_pool_kernel_time_on_card(card, gwfa_graphs):
    """The pool's kernel_ms times the launch alone, inside batch_ms (the
    wrapper call around it): 0 < kernel_ms <= batch_ms; its results
    (jobs over in one copy, outputs back in one) equal a CPU pool's."""
    from minigraph_tpu_torch.align.gwfa_device import DeviceGwfaPool
    g, es = gwfa_graphs["g"]

    class Index:            # what the pool reads of an index
        pass
    gi = Index()
    gi.g, gi.es = g, es
    jobs = gwfa_jobs(gwfa_graphs["g"], 21, 1024, 8) \
        + gwfa_jobs(gwfa_graphs["g"], 22, 256, 8)
    rows, q = [], b""
    for qb, v0, e0, v1, e1, med in jobs:
        rows.append([len(q), len(q) + len(qb), v0, e0, v1, e1, med, 0])
        q += qb
    pool = DeviceGwfaPool(gi, device="cuda")
    n0 = kernels.launches["gwfa"]
    rows = np.asarray(rows, dtype=np.int64)
    got = pool.run(rows, q.decode("latin-1"))
    assert kernels.launches["gwfa"] - n0 == pool.n_batches == 2
    assert 0 < pool.kernel_ms <= pool.batch_ms
    # the one-copy round trip gives the plain version's results
    want = DeviceGwfaPool(gi, device="cpu").run(rows, q.decode("latin-1"))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# ---- the chunk-halo sweep (index/midx_device.py) on K1

@pytest.mark.parametrize("k,w", [(19, 10), (17, 11)])
@pytest.mark.parametrize("B,pad", [(128, 4096), (16, 32768)])
def test_sketch_kernel_chunk_widths(card, k, w, B, pad):
    """K1 at the sweep's widths pad + 2w + k + 2 (4137 / 32809 at asm's
    and lr's (k, w)), no multiple of the kernel's 256-slot tile."""
    L = pad + 2 * w + k + 2
    codes, lens = synth_codes(np.random.default_rng(L + B), B, L)
    c, n = torch.from_numpy(codes), torch.from_numpy(lens)
    want = sketch_planes_ref(c.to(card), n.to(card), w, k)
    n0 = kernels.launches["sketch"]
    got = sketch_planes(c.to(card), n.to(card), w, k)
    assert kernels.launches["sketch"] == n0 + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_sketch_segments_device_on_card(card):
    """The sweep on the card equals its plain version bit for bit, one
    launch a chunk batch; the tandem sequence's planes overflow and it
    goes whole to the host sketch.  Against the host sketch: the same
    records, in the same order except for the 36 kb sequence, whose last
    chunk sits in the 4096 bucket, which the 300 bp sequence opened
    first: the JAX package's sweep decodes it first too (ROADMAP C)."""
    from minigraph_tpu_torch.index.midx_device import (
        DEV_BUCKETS, chunk_jobs, sketch_segments_device)
    from minigraph_tpu_torch.index.sketch import sketch
    rng = np.random.default_rng(8)
    seqs = ["".join(rng.choice(list("ACGTN"), n, p=[.249] * 4 + [.004]))
            for n in (300, 5000, 40000, 70000, 36000)]
    seqs.append("ACGT" * 1500)
    for k, w in ((19, 10), (17, 11)):
        n0 = kernels.launches["sketch"]
        got = sketch_segments_device(seqs, w, k, device="cuda")
        jobs = chunk_jobs(seqs, w, k, DEV_BUCKETS[-1][0])
        small = sum(len(j[2]) <= DEV_BUCKETS[0][0] + w + k + 1
                    for j in jobs)
        assert kernels.launches["sketch"] - n0 \
            == -(-small // 128) + -(-(len(jobs) - small) // 16)
        plain = sketch_segments_device(seqs, w, k, device="cpu")
        for i, (s, (x, y), (px, py)) in enumerate(zip(seqs, got, plain)):
            hx, hy = sketch(s, w, k, rid=0)
            assert np.array_equal(x, px) and np.array_equal(y, py)
            if i != 4:
                assert np.array_equal(x, hx) and np.array_equal(y, hy)
            order = np.argsort(y, kind="stable")
            h_order = np.argsort(hy, kind="stable")
            assert np.array_equal(y[order], hy[h_order])
            assert np.array_equal(x[order], hx[h_order])


@pytest.fixture(scope="module")
def v1_data(tmp_path_factory):
    """A 300 kb bubble graph and 64 reads padded to 2048 (one empty)."""
    from minigraph_tpu_torch.graph.gfa_io import read_gfa
    from minigraph_tpu_torch.index.midx import build_index
    from minigraph_tpu_torch.ops.sketch import encode_batch
    from minigraph_tpu_torch.tools.synth import (make_reference,
                                                 simulate_reads,
                                                 write_bubble_rgfa)
    path = str(tmp_path_factory.mktemp("v1") / "g.gfa")
    ref = make_reference(300_000, seed=131)
    hap = write_bubble_rgfa(ref, 132, path, seg_len=30_000)
    reads = [s for _, s in simulate_reads([hap], 63, seed=133,
                                          mean_len=1300, min_len=800,
                                          max_len=1900)] + [""]
    codes, lens = encode_batch(reads, pad_to=2048)
    return build_index(read_gfa(path), 17, 11), codes, lens


def test_v1_step_on_card_matches_cpu(card, v1_data):
    """ops/pipeline.py make_map_step (the exact sketch, the binary-search
    collect, K4 at W = 64) on the card against the same step on CPU
    tensors: every output bitwise, K4 launched once."""
    from minigraph_tpu_torch.ops.pipeline import DeviceIndex, make_map_step
    gi, codes, lens = v1_data
    kernels.reset_launches()
    got = make_map_step(DeviceIndex.from_host(gi, card), 512, 2048)(
        codes, lens)
    assert kernels.launches["chain_ring"] == 1
    want = make_map_step(DeviceIndex.from_host(gi, "cpu"), 512, 2048)(
        codes, lens)
    for key, v in want.items():
        assert torch.equal(v, got[key].cpu()), key
    assert int(want["n_anchors"].max()) > 100


@pytest.mark.parametrize("window", [64, 32])
def test_ring_chain_on_v1_anchors(card, v1_data, window):
    """K4 through ops/chain.py lchain_dp_device at the v1 step's windows
    against its plain version on the v1 collect's anchors."""
    from minigraph_tpu_torch.ops import u32, u64
    from minigraph_tpu_torch.ops.chain import lchain_dp_device
    from minigraph_tpu_torch.ops.pipeline import (DeviceIndex,
                                                  collect_anchors_device)
    from minigraph_tpu_torch.ops.sketch_v2 import sketch_device_v2
    gi, codes, lens = v1_data
    dix = DeviceIndex.from_host(gi, card)
    mx, my, n_mv = sketch_device_v2(torch.from_numpy(codes).cuda(),
                                    torch.from_numpy(lens).cuda(), gi.w,
                                    gi.k, 512)
    ax, ay, n_a = collect_anchors_device(
        dix.keys, dix.key_start, dix.key_cnt, dix.pos, dix.seg_len, mx, my,
        n_mv, 50, 16, 2048)
    got = lchain_dp_device(ax, ay, n_a, window=window)
    want = lchain_dp_tiled_ref(u64.srl(ax, 32), ax & u32.U32MAX,
                               u64.srl(ay, 32), ay & u32.U32MAX, n_a, MDX,
                               MDY, BW, 0.1827, 0.00913, window=window)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_sharded_steps_nccl_world_one(card, v1_data):
    """parallel/shard.py's five steps on a 1x1 mesh of an NCCL process
    group of one rank: each equals its unsharded step on the card."""
    import socket

    import torch.distributed as dist

    from minigraph_tpu_torch.ops.anchors import HashJoinIndex, JoinIndex
    from minigraph_tpu_torch.ops.pipeline import (DeviceIndex, make_map_step,
                                                  make_map_step_v2)
    from minigraph_tpu_torch.parallel import shard
    gi, codes, lens = v1_data
    w, k = gi.w, gi.k
    dix, ji = DeviceIndex.from_host(gi, card), JoinIndex.from_host(gi, 16,
                                                                    card)
    hi = HashJoinIndex.from_host(gi, 16, card)
    v2 = make_map_step_v2(ji, w, k, acap=512, qcap=512, window=16)(codes,
                                                                    lens)
    v1w = make_map_step(dix, 512, 512, window=32)(codes, lens)
    hs = make_map_step_v2(hi, w, k, acap=512, qcap=512, window=16)(codes,
                                                                    lens)
    want = {"v1": make_map_step(dix, 512, 512)(codes, lens), "v2": v2,
            "v2_idx": v2, "hash_idx": hs, "v1_idx": v1w}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        mesh = shard.make_mesh(1, device="cuda")
        steps = {
            "v1": shard.make_sharded_map_step(mesh, dix, 512, 512),
            "v2": shard.make_sharded_map_step_v2(mesh, ji, w, k, acap=512,
                                                 qcap=512, window=16),
            "v2_idx": shard.make_index_sharded_map_step_v2(
                mesh, ji, w, k, acap=512, qcap=512),
            "hash_idx": shard.make_hash_sharded_map_step(
                mesh, gi, acap=512, qcap=512, device="cuda"),
            "v1_idx": shard.make_index_sharded_map_step(mesh, dix, 512,
                                                        512)}
        for name, step in steps.items():
            res = step(codes, lens)
            if not isinstance(res, dict):
                res = {"best": res[0], "n_anchors": res[1]}
            for key, v in res.items():
                assert torch.equal(v, want[name][key]), (name, key)
    finally:
        dist.destroy_process_group()
