"""The hash join's tables (ops/anchors.py HashJoinIndex.key_arrays): the
cuckoo walk in C (csrc/cuckoo.c) slot for slot against the JAX
package's ops/anchors_hash.py and against the Python walk it replaced
(kept here as the oracle), the payload of starts past 22 and 32 bits
through `_hash_probe`, and the seed-only front's collect on an index
whose starts are rebased past 2^22, against the unpadded index and the
host collect."""
import numpy as np
import pytest
import torch

from minigraph_tpu.ops.anchors_hash import HashJoinIndex as JaxHash
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping.device_front import DeviceFront
from minigraph_tpu_torch.mapping.seeds import (collect_minimizers,
                                               collect_seed_hits)
from minigraph_tpu_torch.ops.anchors import (CUCKOO_STEPS, CUCKOO_TRIES,
                                             U32MAX, HashJoinIndex,
                                             _hash_probe, _slot_hashes_np,
                                             cuckoo_table)
from minigraph_tpu_torch.options import IndexOptions, MapOptions, opt_set
from minigraph_tpu_torch.tools.synth import (make_reference, simulate_reads,
                                             write_bubble_rgfa)

torch.set_num_threads(1)

TABLES = ("tag", "pay", "p_rid", "p_sel")


def python_walk(hh, hl, hbits):
    """The pure-Python cuckoo walk the port ran before csrc/cuckoo.c:
    (table, hbits) or RuntimeError after CUCKOO_TRIES sizes."""
    for _ in range(CUCKOO_TRIES):
        s1, s2 = _slot_hashes_np(hh, hl, hbits)
        s1, s2 = s1.tolist(), s2.tolist()
        table = [-1] * (1 << hbits)
        ok = True
        for j in range(len(s1)):
            cur, slot = j, s1[j]
            for _ in range(CUCKOO_STEPS):
                if table[slot] < 0:
                    table[slot] = cur
                    cur = -1
                    break
                cur, table[slot] = table[slot], cur
                a, b = s1[cur], s2[cur]
                slot = b if slot == a else a
            if cur >= 0:
                ok = False
                break
        if ok:
            return np.asarray(table, dtype=np.int64), hbits
        hbits += 1
    raise RuntimeError("cuckoo build failed")


def index_arrays(n_keys, seed, n_seg=7):
    """A flat index (keys below 2^34, as the JAX table requires)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 34, n_keys, dtype=np.uint64))
    cnt = rng.integers(1, 300, len(keys)).astype(np.int64)
    start = np.cumsum(cnt) - cnt
    seg_len = rng.integers(500, 5000, n_seg).astype(np.int64)
    rid = rng.integers(0, n_seg, int(cnt.sum())).astype(np.uint64)
    rpos = (rng.integers(0, 400, len(rid)).astype(np.uint64) << np.uint64(1)) \
        | rng.integers(0, 2, len(rid)).astype(np.uint64)
    return keys, start, cnt, (rid << np.uint64(32)) | rpos, seg_len


def key_words(keys):
    return ((keys >> np.uint64(32)).astype(np.uint32),
            keys.astype(np.uint32))


def first_hbits(n_keys):
    return max(4, int(np.ceil(np.log2(max(n_keys, 1) * 2))))


# (keys, seed): 64 keys of seed 11 fail the first table size, so the
# build retries at one more hbits
WALKS = [(64, 11), (300, 1), (5000, 2)]


@pytest.mark.parametrize("n_keys,seed", WALKS)
def test_tables_match_jax(n_keys, seed):
    keys, start, cnt, pos, seg_len = index_arrays(n_keys, seed)
    want = JaxHash.from_arrays(keys, start, cnt, pos, seg_len, k=17, w=11)
    got = HashJoinIndex.key_arrays(keys, start, cnt, pos, seg_len)
    assert got["hbits"] == want.hbits
    if (n_keys, seed) == (64, 11):
        assert got["hbits"] == first_hbits(len(keys)) + 1
    for k in TABLES:
        assert got[k].dtype == np.uint32
        np.testing.assert_array_equal(np.asarray(getattr(want, k)), got[k],
                                      err_msg=k)


@pytest.mark.parametrize("n_keys,seed,hbits_min",
                         [(64, 11, 0), (20000, 3, 0), (20000, 4, 17),
                          (3000, 5, 0)])
def test_c_walk_matches_python_walk(n_keys, seed, hbits_min):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 40, n_keys, dtype=np.uint64))
    hh, hl = key_words(keys)
    hbits = max(first_hbits(len(keys)), hbits_min)
    want, want_hbits = python_walk(hh, hl, hbits)
    got, got_hbits = cuckoo_table(hh, hl, hbits)
    assert got_hbits == want_hbits
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert sorted(got[got >= 0].tolist()) == list(range(len(keys)))


def test_walk_gives_up_after_six_sizes():
    """Three copies of one key share both slots at every size: both
    walks raise after six."""
    keys = np.array([5, 5, 5, 9], dtype=np.uint64)
    hh, hl = key_words(keys)
    with pytest.raises(RuntimeError):
        python_walk(hh, hl, 4)
    with pytest.raises(RuntimeError):
        cuckoo_table(hh, hl, 4)


# keys in no table: the first has the words of an empty slot (tag 0,
# and pay & 3 == 3 where pay is -1)
ABSENT = np.array([3 << 32, 0x3FFFFFFFF, 0x2FFFFFFF1], dtype=np.uint64)


def probe(hi, keys):
    """_hash_probe of each key, then of the ABSENT keys."""
    q = np.concatenate([keys, ABSENT])
    hh, hl = key_words(q)
    qhh = torch.from_numpy(hh.astype(np.int64))[None]
    qhl = torch.from_numpy(hl.astype(np.int64))[None]
    found, cnt, start = _hash_probe(hi, qhh, qhl,
                                    torch.ones_like(qhh, dtype=torch.bool))
    return found[0].numpy(), cnt[0].numpy(), start[0].numpy()


def test_payload_past_32_bits_round_trips():
    keys = np.array([7, 1 << 33, (1 << 34) - 3, 12345], dtype=np.uint64)
    start = np.array([3, (1 << 22) + 11, (1 << 32) + 5, (1 << 45) + 1],
                     dtype=np.int64)
    cnt = np.array([1, 300, 2, 255], dtype=np.int64)
    pos = np.zeros(1, dtype=np.uint64)
    arrays = HashJoinIndex.key_arrays(keys, start, cnt, pos,
                                      np.array([100], dtype=np.int64))
    assert arrays["pay"].dtype == np.int64
    filled = arrays["pay"] != -1
    assert filled.sum() == len(keys)
    hi = HashJoinIndex.from_arrays(arrays, 16, "cpu")
    assert hi.empty == -1
    found, got_cnt, got_start = probe(hi, keys)
    np.testing.assert_array_equal(found, [1] * len(keys) + [0] * 3)
    np.testing.assert_array_equal(got_cnt[:len(keys)], np.minimum(cnt, 255))
    np.testing.assert_array_equal(got_start[:len(keys)], start)
    with pytest.raises(ValueError):
        HashJoinIndex.key_arrays(keys, start + (1 << 53), cnt, pos,
                                 np.array([100], dtype=np.int64))


def test_payload_equal_to_the_empty_marker_goes_wide():
    """start 2^22 - 1 with cnt >= 255 and hh & 3 == 3 makes the u32
    payload 0xFFFFFFFF, the u32 table's empty slot: the table takes the
    64-bit layout, and the key and an empty slot stay apart."""
    keys = np.array([(3 << 32) | 5, (1 << 32) | 77], dtype=np.uint64)
    start = np.array([(1 << 22) - 1, 5], dtype=np.int64)
    cnt = np.array([400, 3], dtype=np.int64)
    arrays = HashJoinIndex.key_arrays(keys, start, cnt,
                                      np.zeros(1, dtype=np.uint64),
                                      np.array([100], dtype=np.int64))
    assert arrays["pay"].dtype == np.int64
    assert U32MAX in arrays["pay"].tolist()
    hi = HashJoinIndex.from_arrays(arrays, 16, "cpu")
    found, got_cnt, got_start = probe(hi, keys)
    np.testing.assert_array_equal(found, [1, 1, 0, 0, 0])
    np.testing.assert_array_equal(got_start[:2], start)
    np.testing.assert_array_equal(got_cnt[:2], [255, 3])


def asm_front(tmp_path):
    path = str(tmp_path / "g.gfa")
    ref = make_reference(150_000, seed=71)
    hap = write_bubble_rgfa(ref, 72, path, seg_len=25_000)
    reads = [s for _, s in simulate_reads([hap, ref], 40, seed=73,
                                          mean_len=1200, min_len=300,
                                          max_len=2000)]
    io_, mo = IndexOptions(), MapOptions()
    opt_set("asm", io_, mo)
    gi = build_index(read_gfa(path), io_.k, io_.w, mo)
    return gi, mo, reads


def test_front_collect_with_starts_past_22_bits(tmp_path):
    """The seed-only front (asm: k = 19 takes the hash join) on the
    index's tables, and on the same index with its position array
    padded in front by 2^22 unused entries and every start rebased past
    them: the same anchors read for read, each the host collect's."""
    gi, mo, reads = asm_front(tmp_path)
    fronts = [DeviceFront(gi, mo, device="cpu", buckets=((2048, 32),))
              for _ in range(2)]
    assert fronts[0].hashed and not fronts[0].chain_enabled
    pad = 1 << 22
    rebased = HashJoinIndex.key_arrays(
        gi.keys, np.asarray(gi.key_start, dtype=np.int64) + pad,
        gi.key_cnt, np.concatenate([np.zeros(pad, dtype=np.uint64),
                                    np.asarray(gi.pos, dtype=np.uint64)]),
        np.asarray([s.len for s in gi.g.seg], dtype=np.int64))
    assert rebased["pay"].dtype == np.int64
    assert (rebased["pay"][rebased["pay"] >= 0] >> 10).min() >= pad
    fronts[1].ji = HashJoinIndex.from_arrays(rebased, fronts[1].occ_cap,
                                             "cpu")
    want, got = (f.gather(f.submit(reads)) for f in fronts)
    n_dev = 0
    for r, a, b in zip(reads, want, got):
        assert (a is None) == (b is None)
        if a is None:
            continue
        n_dev += 1
        mv_x, mv_y = collect_minimizers(gi, [len(r)], [r])
        hax, hay, hrep, hmini = collect_seed_hits(gi, mo, mo.occ_max1,
                                                  mv_x, mv_y)
        for fr in (a, b):
            np.testing.assert_array_equal(fr.ax, hax)
            np.testing.assert_array_equal(fr.ay, hay)
            assert fr.rep_len == hrep and fr.n_mv == len(mv_x)
            np.testing.assert_array_equal(np.asarray(fr.mini_pos),
                                          np.asarray(hmini))
    assert n_dev >= 25


def test_front_counts_what_the_collect_touches(tmp_path):
    """The hash join's collect counters follow the padded batch shapes
    (B x qcap minimizer slots probed, B x acap anchor slots), the table
    words a probed slot reads and the tables' device bytes; the flat
    join counts nothing."""
    gi, mo, reads = asm_front(tmp_path)
    front = DeviceFront(gi, mo, device="cpu", buckets=((2048, 16),))
    front.gather(front.submit(reads))
    qcap, acap, _, _ = front.caps(2048)
    assert front.n_batches == -(-len(reads) // 16)
    assert front.collect_probed == front.n_batches * 16 * qcap
    assert front.collect_anchor_slots == front.n_batches * 16 * acap
    assert front.table_slot_words == 2 + (front.ji.tag_hi is not None)
    want = sum(t.numel() * t.element_size()
               for t in (front.ji.tag, front.ji.pay, front.ji.p_rid,
                         front.ji.p_sel, front.ji.tag_hi)
               if t is not None)
    assert front.table_bytes == want > 0
    gi17 = build_index(gi.g, 17, 11, mo)
    flat = DeviceFront(gi17, mo, device="cpu", buckets=((2048, 16),))
    assert not flat.hashed and flat.table_slot_words == 0
    flat.gather(flat.submit(reads))
    assert flat.collect_probed == flat.collect_anchor_slots == 0
