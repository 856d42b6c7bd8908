"""The device front's CUDA-graph step (mapping/device_front.py): on the
card a bucket shape's first batch runs eagerly, then each stage is
captured into a graph of its own and later batches of the shape replay
them.

On the CPU (a stub in place of `capture_stages` whose graphs run their
stage eagerly again on each replay, on a CPU front that is let capture):
one capture per (shape, mode), a capture that raises leaves its shape
eager, the counters reach map_reads' stats, the words equal the eager
front's, and the CPU front as built never captures.

On the card (marked `cuda`, skipped without one): the replayed packed
words and gather_flat's blobs against an eager front's on the same
batches, bitwise, at the three default buckets, for the chained front
(hash join and flat join) and the seed-only front, with a short padded
last batch in every bucket, lanes flagged overflow and unsure, and
batches of one shape replayed back to back before any is gathered."""
import io

import numpy as np
import pytest
import torch

from minigraph_tpu_torch import kernels
from minigraph_tpu_torch.graph.gfa_io import read_gfa
from minigraph_tpu_torch.index.midx import build_index
from minigraph_tpu_torch.mapping import device_front as dfm
from minigraph_tpu_torch.mapping import mapper
from minigraph_tpu_torch.mapping.device_front import (DEFAULT_BUCKETS,
                                                      DeviceFront)
from minigraph_tpu_torch.mapping.split import ShareSplit
from minigraph_tpu_torch.options import IndexOptions, MapOptions, opt_set
from minigraph_tpu_torch.tools.synth import (_revcomp, make_reference,
                                             simulate_reads,
                                             write_bubble_rgfa, write_fasta)

torch.set_num_threads(1)

CPU_BUCKETS = ((1024, 4), (2048, 4))


def preset_opts(preset):
    io_, mo = IndexOptions(), MapOptions()
    if preset:
        opt_set(preset, io_, mo)
    return io_, mo


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A 150 kb graph, its index for lr and asm, and 22 reads of
    0.3-2 kb (both CPU buckets, several batches of each)."""
    d = tmp_path_factory.mktemp("frontgraph")
    ref = make_reference(150_000, seed=61)
    hap = write_bubble_rgfa(ref, 62, str(d / "g.gfa"), seg_len=20_000)
    recs = simulate_reads([hap, ref], 22, seed=63, mean_len=900,
                          min_len=300, max_len=2000)
    write_fasta(str(d / "r.fa"), recs)
    g = read_gfa(str(d / "g.gfa"))
    gis = {}
    for preset in (None, "asm"):
        io_, mo = preset_opts(preset)
        gis[preset] = build_index(g, io_.k, io_.w, mo)
    return {"gis": gis, "reads": [s for _, s in recs],
            "fa": str(d / "r.fa")}


def cpu_front(small, preset, capture):
    _, mo = preset_opts(preset)
    front = DeviceFront(small["gis"][preset], mo, device="cpu",
                        buckets=CPU_BUCKETS, chain_window=64)
    front._capture = capture
    return front


class StubGraph:
    """A captured stage that runs its stage eagerly on each replay."""

    def __init__(self, fn, st):
        self.fn, self.st = fn, st

    def replay(self):
        self.fn(self.st)


def stub_capture(calls, fail=False):
    """A stand-in for capture_stages: records (stages, codes shape)
    a call; as a kernel launch would, the capture counts one sketch
    launch, which the front must take back; raises RuntimeError where
    `fail`, after that count."""
    def capture(fns, st):
        calls.append((len(fns), tuple(st["codes"].shape)))
        kernels.launches["sketch"] += 1
        if fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        for fn in fns:
            fn(st)
        return [StubGraph(fn, st) for fn in fns]
    return capture


def words(handle):
    """Each bucket batch's packed words, plane by plane and vector by
    vector, without the word after each plane that takes the padding's
    scatter writes (its final value is any of them)."""
    out = []
    for chunk, host, layout, _ in handle[1]:
        out.append((list(chunk), {k: np.array(host[off: off + n])
                                  for k, (off, n) in layout.items()}))
    return out


def assert_same_words(a, b):
    assert len(a) == len(b)
    for (ca, wa), (cb, wb) in zip(a, b):
        assert ca == cb and wa.keys() == wb.keys()
        for k in wa:
            assert np.array_equal(wa[k], wb[k]), k


def assert_same_blobs(fa, fb):
    assert len(fa) == len(fb)
    for (pa, ba), (pb, bb) in zip(fa, fb):
        assert np.array_equal(pa, pb) and ba.keys() == bb.keys()
        for k in ba:
            assert ba[k].dtype == bb[k].dtype, k
            assert np.array_equal(ba[k], bb[k]), k


# ---- the capture bookkeeping, on the CPU ------------------------------
@pytest.mark.parametrize("preset", [None, "asm"], ids=["chained", "seed"])
def test_one_capture_per_shape_and_mode(small, monkeypatch, preset):
    calls = []
    monkeypatch.setattr(dfm, "capture_stages", stub_capture(calls))
    front = cpu_front(small, preset, capture=True)
    eager = cpu_front(small, preset, capture=False)
    reads = small["reads"]
    launches0 = kernels.launches["sketch"]
    got, want = [], []
    for rep in range(2):
        h, he = front.submit(reads), eager.submit(reads)
        assert front.last_submit_cold == (rep == 0)
        got.append(words(h))
        want.append(words(he))
        assert_same_blobs(front.gather_flat(h), eager.gather_flat(he))
    for a, b in zip(got, want):
        assert_same_words(a, b)
    n_stages = len(front.stage_names)
    assert n_stages == (3 if preset else 5)
    assert sorted(calls) == [(n_stages, (4, 1024)), (n_stages, (4, 2048))]
    chained = preset is None
    assert set(front._shapes) == {(1024, 4, chained), (2048, 4, chained)}
    assert all(sg is not None for sg in front._shapes.values())
    assert front.n_step_eager == 2
    assert front.n_step_replays == front.n_batches - 2 >= 6
    # the capture's launch was taken back; each replay adds it again
    assert kernels.launches["sketch"] - launches0 == front.n_step_replays
    assert eager.n_step_replays == eager.n_step_eager == 0


def test_failed_capture_stays_eager(small, monkeypatch):
    calls = []
    monkeypatch.setattr(dfm, "capture_stages", stub_capture(calls, True))
    front = cpu_front(small, None, capture=True)
    eager = cpu_front(small, None, capture=False)
    launches0 = dict(kernels.launches)
    for _ in range(2):
        h = front.submit(small["reads"])
        assert_same_words(words(h), words(eager.submit(small["reads"])))
        front.gather_flat(h)
    # one try a shape, never again
    assert len(calls) == 2
    assert list(front._shapes.values()) == [None, None]
    assert front.n_step_replays == 0
    assert front.n_step_eager == front.n_batches >= 8
    assert kernels.launches == launches0


def test_counters_reach_map_reads(small, monkeypatch):
    monkeypatch.setattr(dfm, "capture_stages", stub_capture([]))
    gaf = {}
    stats = {}
    for capture in (True, False):
        front = cpu_front(small, None, capture=capture)
        front._split_state = ShareSplit(share=0.0)
        out, st = io.StringIO(), {}
        mapper.map_reads(small["gis"][None], front.opt, [small["fa"]], out,
                         2, front, st)
        gaf[capture], stats[capture] = out.getvalue(), st
    st = stats[True]
    assert st["n_share_host"] == 0 and st["n_share_dev"] > 0
    assert st["n_step_replays"] > 0 and st["n_step_eager"] == 2
    assert st["n_step_replays"] + st["n_step_eager"] == st["n_batches"]
    assert (stats[False]["n_step_replays"],
            stats[False]["n_step_eager"]) == (0, 0)
    assert gaf[True] == gaf[False] and gaf[True].count("\n") >= 15


def test_cpu_front_never_captures(small, monkeypatch):
    def refuse(fns, st):
        raise AssertionError("the CPU front captured")
    monkeypatch.setattr(dfm, "capture_stages", refuse)
    _, mo = preset_opts(None)
    front = DeviceFront(small["gis"][None], mo, device="cpu",
                        buckets=CPU_BUCKETS, chain_window=64)
    assert front._capture is False
    for _ in range(2):
        front.gather_flat(front.submit(small["reads"]))
    assert front.n_batches >= 8
    assert front.n_step_replays == front.n_step_eager == 0
    assert set(front._shapes.values()) == {None}


# ---- the replayed step against the eager step, on the card ------------
def card_reads(ref, hap, rng, seed):
    """Reads for the three default buckets, each a full batch and a
    short padded one: simulated reads off the haplotype, and in the
    2 kb and 8 kb buckets reads of a segment twice (on one strand their
    anchors repeat an x: flagged overflow) and, in the 8 kb and 32 kb
    buckets, chimeras of short pieces that make more than UCAP chains
    (flagged unsure by the backtrack where they do not overflow)."""
    a = np.frombuffer(ref.encode("latin-1"), np.uint8)

    def piece(n):
        s = int(rng.integers(0, len(a) - n))
        return a[s: s + n]

    def text(parts):
        return np.concatenate(parts).tobytes().decode("latin-1")

    out = []
    for (lo, hi), (pad, bsz) in zip(((300, 2048), (2049, 8192),
                                     (8193, 32768)), DEFAULT_BUCKETS):
        n = bsz + 5
        # 5% inside the bucket's bounds: the indels move a length
        sim = simulate_reads([hap], n, seed=seed + pad, mean_len=(lo + hi)
                             // 2, min_len=lo + lo // 20,
                             max_len=hi - hi // 20)
        reads = [s for _, s in sim]
        if pad <= 8192:
            half = (lo + hi) // 4
            for i in range(0, 8):
                p = piece(half)
                reads[7 * i] = text([p, p if i % 2 else _revcomp(p)])
        if pad >= 8192:
            n_pc, ln = (66, 60) if pad == 8192 else (100, 300)
            for i in range(6):
                reads[7 * i + 3] = text([piece(ln) for _ in range(n_pc)])
        assert all(lo <= len(s) <= pad for s in reads)
        out += reads
    return out


@pytest.fixture(scope="module")
def card_data(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the front's graphs are CUDA "
                    "graphs)")
    d = tmp_path_factory.mktemp("frontgraph_card")
    data = {}
    for name, size, seed in (("big", 2_000_000, 71), ("small", 300_000,
                                                       81)):
        ref = make_reference(size, seed=seed)
        hap = write_bubble_rgfa(ref, seed + 1, str(d / f"{name}.gfa"),
                                seg_len=50_000)
        data[name] = (read_gfa(str(d / f"{name}.gfa")),
                      card_reads(ref, hap, np.random.default_rng(seed + 2),
                                 seed + 3))
    return data


@pytest.mark.cuda
@pytest.mark.parametrize("graph,preset,hashed", [
    ("big", None, True), ("small", None, False), ("big", "asm", True)],
    ids=["chained-hash", "chained-flat", "seed-only"])
def test_replayed_step_matches_eager_on_card(card_data, graph, preset,
                                             hashed):
    g, reads = card_data[graph]
    io_, mo = preset_opts(preset)
    gi = build_index(g, io_.k, io_.w, mo)
    fg = DeviceFront(gi, mo, device="cuda")
    fe = DeviceFront(gi, mo, device="cuda")
    fe._capture = False
    assert fg.hashed == hashed and fg.buckets == sorted(DEFAULT_BUCKETS)
    chained = preset is None
    # warm-up: one batch of each shape, eager; then the captures
    warm = [next(s for s in reads if len(s) > lo)
            for lo in (0, 2048, 8192)]
    for f in (fg, fe):
        f.gather_flat(f.submit(warm))
    assert fg.n_step_eager == 3 and fg.n_step_replays == 0
    assert set(fg._shapes) == {(p, b, chained) for p, b in DEFAULT_BUCKETS}
    assert all(sg is not None for sg in fg._shapes.values())
    kernels.reset_launches()
    # two handles, each with two batches a bucket (a full one and a short
    # padded one; the second handle's reads in the reverse order), every
    # batch of a shape replayed before any is gathered
    parts = (reads, reads[::-1])
    hg = [fg.submit(p) for p in parts]
    he = [fe.submit(p) for p in parts]
    n_rep = sum(len(h[1]) for h in hg)
    assert fg.n_step_replays == n_rep == 12 and fg.n_step_eager == 3
    for name in ("sketch",) + (("chain_exact", "backtrack") if chained
                               else ()):
        assert kernels.launches[name] == 2 * n_rep, name
    flat_g = [fg.gather_flat(h) for h in hg]
    flat_e = [fe.gather_flat(h) for h in he]
    n_ovf = n_unsure = n_short = 0
    for a, b in zip(hg, he):
        wa, wb = words(a), words(b)
        assert_same_words(wa, wb)
        for chunk, w in wa:
            nb = len(chunk)
            ovf = w["overflow"][:nb] != 0
            n_ovf += int(ovf.sum())
            n_short += nb < len(w["overflow"])
            if chained:
                n_unsure += int(((w["sure"][:nb] == 0) & ~ovf).sum())
    for a, b in zip(flat_g, flat_e):
        assert_same_blobs(a, b)
    assert n_short == 6
    assert n_ovf >= 4
    if chained and hashed:
        # the small graph's chimeras mostly overflow (their pieces
        # overlap), so only the 2 Mb graph is held to unsure lanes
        assert n_unsure >= 4
    assert (fg.n_device, fg.n_fallback, fg.n_chain_unsure) == \
        (fe.n_device, fe.n_fallback, fe.n_chain_unsure)
    assert fg.n_device >= len(reads) // 2
