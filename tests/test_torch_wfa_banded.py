"""The port's banded dual-affine score (minigraph_tpu_torch/ops/wfa_banded.py)
against the JAX package's: the plain PyTorch version bitwise against the
TPU kernel itself (ops/wfa_pallas.py banded_score in interpret mode) at
wa = 32 and 64 on short random pairs, diverged ~150 bp pairs, unrelated
pairs whose optimal paths leave the band, and an out-of-band length
skew; and against the exact WFA score (align/wfa.py wfa_exact) on the
pairs whose paths stay in the band.  Tolerance 0."""
import numpy as np
import pytest
import torch

from minigraph_tpu.align.wfa import WfOpt, wfa_exact
from minigraph_tpu.ops.wfa_pallas import banded_score as jax_banded_score
from minigraph_tpu_torch.ops.wfa_banded import (banded_score,
                                                banded_score_planes,
                                                banded_score_ref,
                                                encode_pairs)

# many small tensor ops: one intra-op thread per test process keeps the
# parallel test workers from oversubscribing the cores they share
torch.set_num_threads(1)


def rnd(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).tobytes()


def mutate(rng, t):
    """tests/test_device_wfa.py's ~150 bp pairs: 8 substitutions and
    three indels of 1-3 bp."""
    q = bytearray(t)
    for p in rng.integers(0, len(q), size=8):
        q[p] = int(rng.choice(np.frombuffer(b"ACGT", np.uint8)))
    for _ in range(3):
        p = int(rng.integers(0, len(q) - 4))
        if rng.random() < 0.5:
            del q[p: p + int(rng.integers(1, 4))]
        else:
            q[p:p] = rnd(rng, int(rng.integers(1, 4)))
    return bytes(q)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    short = [(rnd(rng, int(rng.integers(1, 17))),
              rnd(rng, int(rng.integers(1, 17)))) for _ in range(40)]
    diverged = []
    for _ in range(10):
        t = rnd(rng, 150)
        diverged.append((t, mutate(rng, t)))
    # unrelated sequences of near-equal length: the end cell is in the
    # band but the optimal path wanders off it
    unrelated = []
    for _ in range(6):
        n = int(rng.integers(100, 301))
        unrelated.append((rnd(rng, n), rnd(rng, n + int(rng.integers(-8, 9)))))
    skew = [(rnd(rng, 100), rnd(rng, 20))]
    return short, diverged, unrelated, skew


def port_scores(pairs, wa):
    return banded_score(pairs, wa=wa, device="cpu")


@pytest.mark.parametrize("wa", [32, 64])
def test_banded_ref_matches_pallas_interpret(pairs, wa):
    allp = [p for group in pairs for p in group]
    want = jax_banded_score(allp, wa=wa, interpret=True)
    got = port_scores(allp, wa)
    np.testing.assert_array_equal(want, got)
    assert got[-1] == -1                 # the (100, 20) skew
    assert (got[:-1] >= 0).all()


def test_banded_ref_matches_exact_wfa(pairs):
    short, diverged, unrelated, _ = pairs
    inband = short + diverged
    want = np.array([wfa_exact(WfOpt(max_iter=10 ** 8), t, q).s
                     for t, q in inband])
    np.testing.assert_array_equal(port_scores(inband, 32), want)
    # off-band paths: the banded optimum is an upper bound, not the score
    ex = np.array([wfa_exact(WfOpt(max_iter=10 ** 8), t, q).s
                   for t, q in unrelated])
    got = port_scores(unrelated, 32)
    assert (got >= ex).all() and (got > ex).any()


def test_banded_planes_raw_scores():
    """The raw score of an out-of-band pair stays >= 2^28; the wrapper
    dispatches CPU tensors to the plain version."""
    planes = encode_pairs([(b"ACGTACGT", b"ACGAACGT"), (b"A" * 60, b"A")])
    raw = banded_score_planes(*planes, wa=32)
    assert raw.dtype == torch.int32
    assert int(raw[0]) == 4 and int(raw[1]) >= 1 << 28
    assert torch.equal(raw, banded_score_ref(*planes, wa=32))


def test_banded_score_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        banded_score([(b"ACGT", b"ACGT")])
