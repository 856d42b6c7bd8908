"""The control of `correct` at a tiny size: the reference without the
long-join rescue reads above the limit, where the port reads 0."""
from __future__ import annotations

import pytest

from portbench import check
from portbench.control import control_reading


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_control_fails_the_limit(tiny_spec, seed):
    r = control_reading(tiny_spec.cell("t.lr"), seed)
    vals = {k: r[k] for k in check.LIMITS}
    assert r["gaf_reads_differ"] > check.LIMITS["gaf_reads_differ"]
    assert r["sample_reads_differ"] > check.LIMITS["sample_reads_differ"]
    assert not check.correct(vals)
