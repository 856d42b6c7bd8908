"""The independent engine (pyref) against the frozen reference at a
tiny size, and the sample a run draws."""
from __future__ import annotations

import pytest

from portbench import indep
from portbench.inputs import make_inputs
from portbench.ref.mapper import Reference, read_fasta


@pytest.mark.parametrize("wl", ["t.lr", "t.asm"])
def test_pyref_maps_as_the_frozen_reference(tiny_spec, tmp_path, wl):
    """Two engines that share no code give the same GAF for every query
    of a file."""
    cell = tiny_spec.cell(wl)
    inp = make_inputs(cell.config, cell.traffic, 2**31 + 3, tmp_path)
    preset = cell.config["preset"]
    want = dict(Reference(inp.gfa, preset, 2).map_file(inp.files[0]))
    recs = read_fasta(inp.files[0])
    got = indep.map_queries(inp.gfa, preset, recs, 2)
    assert set(got) == set(want)
    assert all(got[n] == (want[n] or "") for n in want)
    assert sum(bool(t) for t in got.values()) > len(recs) // 2


def test_draw_sample_from_the_seed():
    a = indep.draw_sample(2**33 + 1, [1, 2, 0, 1], [50, 60, 70], 40)
    assert a == indep.draw_sample(2**33 + 1, [1, 2, 0, 1], [50, 60, 70], 40)
    assert a != indep.draw_sample(2**33 + 2, [1, 2, 0, 1], [50, 60, 70], 40)
    assert len(set(a)) == 40
    sizes = {0: 60, 1: 70, 2: 50, 3: 60}
    assert all(0 <= i < sizes[p] for p, i in a)
    assert indep.draw_sample(5, [0], [10], 40) == [(0, i) for i in range(10)]


def test_queries_not_mapped_in_time_are_left_out(tiny_spec, tmp_path):
    cell = tiny_spec.cell("t.lr")
    inp = make_inputs(cell.config, cell.traffic, 9, tmp_path)
    recs = read_fasta(inp.files[0])[:4]
    assert indep.map_queries(inp.gfa, "lr", recs, 2, seconds=0.0) == {}
    sample = [(0, i) for i in range(4)]
    assert indep.check_sample(inp.gfa, "lr", sample, [""], [recs], 2,
                              seconds=0.0) == (0, 4, None)
