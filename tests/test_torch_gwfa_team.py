"""The GWFA kernel's team schedule, and its one-copy wrapper, on the CPU.

The per-job model of csrc/gwfa.cu (tests/test_torch_gwfa.py model_job:
team appends by ballot and popcount, the dedup's hash table, the
kernel's rank and bitonic sorts, the walk on one thread; held there
against the plain version at both buckets, the flag caps and the F_TIE
batches) against the JAX package's gwfa_batch on a batch with a
tainted winner.  The sorts and appends alone against Python's sort and
sequential compaction, around every length where the kernel changes
sort or chunk.  The one-copy wrapper: pack_jobs' seven tensors are
views of one buffer holding what the per-tensor packing held, and
out_views reads the kernel's one output buffer; gwfa_launch refuses
jobs on the CPU.  The compare tools refuse to run without a card.
Tolerance: exact equality."""
import numpy as np
import pytest
import torch

from minigraph_tpu.ops import gwfa_jax
from minigraph_tpu_torch.ops import gwfa as gw
# graphs: the module fixture of test_torch_gwfa.py, shared
from test_torch_gwfa import (NT, F_TIE, bitonic_model,  # noqa: F401
                             graphs, make_jobs, model_job, rank_sort_model,
                             team_append, team_append_same, team_sort)

torch.set_num_threads(1)


def test_model_matches_jax(graphs):
    """The model against the JAX package directly, on a batch with a
    tainted winner (F_TIE)."""
    g, es, jg, jes = graphs["g"]
    jobs = make_jobs(graphs["g"], 105, 256)
    gd, _ = gw.build_device_graph(g, es)
    args = gw.pack_jobs(jobs, 256)
    jgd, _ = gwfa_jax.build_device_graph(jg, jes, degcap=6)
    want = gwfa_jax.gwfa_batch(
        jgd, *(np.asarray(x.numpy(), dtype=np.int32) for x in args))
    G = tuple(x.tolist() for x in gd)
    q, ql, v0, o0, v1, o1, med = (x.tolist() for x in args)
    tie = 0
    for j in range(len(ql)):
        s, flags, walk, n_walk = model_job(G, q[j], ql[j], v0[j], o0[j],
                                           v1[j], o1[j], med[j])
        assert (s, flags, n_walk) == (int(want["s"][j]),
                                      int(want["flags"][j]),
                                      int(want["n_walk"][j])), j
        assert walk == np.asarray(want["walk"][j]).tolist(), j
        tie |= flags & F_TIE
    assert tie


def test_sorts():
    """team_sort (by rank up to 512 entries, else the shared-memory
    bitonic network) sorts like Python at every length around its
    switch; keys share their leading fields in runs and end in their
    position."""
    rng = np.random.default_rng(17 + NT)
    for n in (1, 2, 3, 5, 31, 32, 33, 255, 256, 257, 511, 512, 513, 600):
        vd = rng.integers(0, max(2, n // 3), n).tolist()
        k = rng.integers(0, 4, n).tolist()
        keys = [(a, -b, i) for i, (a, b) in enumerate(zip(vd, k))]
        pad = ((1 << 63) - 1, 1 << 31, (1 << 31) - 1)
        assert team_sort(keys, NT, pad) == sorted(keys), n
    keys = [(i * 7919 % 251, i) for i in range(251)]
    assert rank_sort_model(keys) == sorted(keys)
    assert bitonic_model(keys, (1 << 63, 0), NT) == sorted(keys)


def test_team_appends():
    """Ballot-and-popcount slots are the compaction's positions; the
    shared-predicate passes land where sequential passes put them, caps
    included."""
    rng = np.random.default_rng(NT)
    for n, cap, count in ((0, 8, 0), (5, 3, 1), (40, 100, 7),
                          (300, 64, 30), (31, 2048, 0)):
        items = [i if rng.random() < 0.4 else None for i in range(n)]
        kept = [i for i in items if i is not None]
        out, c, over = team_append(items, count, cap, NT)
        assert out == [(count + r, i) for r, i in enumerate(kept)]
        assert c == min(count + len(kept), cap)
        assert over == (count + len(kept) > cap)
        out, c3, over3 = team_append_same(items, count, cap, NT, 3)
        seq, c_seq, over_seq = [], count, False
        for a in range(3):
            o, c_seq, ov = team_append(items, c_seq, cap, NT)
            seq += [(slot, a, i) for slot, i in o]
            over_seq |= ov
        assert (c3, over3) == (c_seq, over_seq)
        assert sorted((s, a, i) for s, a, i in out if s < cap) \
            == sorted((s, a, i) for s, a, i in seq if s < cap)


def test_pack_jobs_one_buffer(graphs):
    """The seven job tensors are views of one int32 buffer (queries,
    then the six fields) and hold what the per-tensor packing held:
    -1-padded queries, pad rows of one base at vertex 0."""
    jobs = make_jobs(graphs["g"], 5, 256, 11)
    J, qcap = 16, 256
    args = gw.pack_jobs(jobs, qcap, J)
    # the per-tensor packing
    q = np.full((J, qcap), -1, dtype=np.int32)
    cols = np.zeros((6, J), dtype=np.int32)
    cols[0] = 1
    for i, (qb, v0, off0, v1, off1, max_ed) in enumerate(jobs):
        q[i, : len(qb)] = np.frombuffer(qb, dtype=np.uint8)
        cols[:, i] = (len(qb), v0, off0, v1, off1, max_ed)
    assert args[0].shape == (J, qcap) and args[0].dtype == torch.int32
    assert np.array_equal(args[0].numpy(), q)
    for r in range(6):
        assert args[1 + r].shape == (J,) and args[1 + r].is_contiguous()
        assert np.array_equal(args[1 + r].numpy(), cols[r])
    base = args[0].untyped_storage().data_ptr()
    for r, x in enumerate(args):
        assert x.untyped_storage().data_ptr() == base
        off = 0 if r == 0 else 4 * (J * qcap + (r - 1) * J)
        assert x.data_ptr() - base == off
    empty = gw.pack_jobs([], qcap, 0)
    assert empty[0].shape == (0, qcap) and empty[1].shape == (0,)
    with pytest.raises(ValueError):
        gw.pack_jobs([(b"A" * 300, 0, 0, 0, 0, 5)], 256)


def test_out_views_round_trip(graphs):
    """The kernel's one output buffer (s, flags, n_walk, then the walks)
    read back through out_views gives the plain version's four outputs,
    as one copy of it does on the card."""
    g, es = graphs["g"][:2]
    gd, _ = gw.build_device_graph(g, es)
    J, wcap = 16, 64
    want = gw.gwfa_batch_ref(gd, *gw.pack_jobs(
        make_jobs(graphs["g"], 21, 256), 256, J))
    flat = torch.cat([want["s"], want["flags"], want["n_walk"],
                      want["walk"].reshape(-1)])
    got = gw.out_views(flat.clone(), J, wcap)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert torch.equal(got[key], want[key]), key
    empty = gw.out_views(torch.empty(0, dtype=torch.int32), 0, wcap)
    assert empty["walk"].shape == (0, wcap)


def test_launch_refuses_cpu(graphs):
    """gwfa_launch runs the kernel only: jobs on the CPU raise, as does
    a clock buffer given to gwfa_batch's plain route."""
    g, es = graphs["g"][:2]
    gd, _ = gw.build_device_graph(g, es)
    args = gw.pack_jobs(make_jobs(graphs["g"], 5, 256, 3), 256, 16)
    with pytest.raises(ValueError, match="on the card"):
        gw.gwfa_launch(gd, *args)
    with pytest.raises(ValueError, match="clock"):
        gw.gwfa_batch(gd, *args,
                      clock=torch.zeros((16, gw.CLK_N), dtype=torch.int64))


@pytest.mark.parametrize("tool", ["gwcompare", "btcompare"])
def test_compare_tool_needs_card(tool, capsys):
    """The compare tools exit non-zero, having run nothing, without a
    CUDA card."""
    import importlib
    mod = importlib.import_module(f"minigraph_tpu_torch.tools.{tool}")
    assert mod.main(["."]) == 1
    assert "no CUDA device" in capsys.readouterr().err
