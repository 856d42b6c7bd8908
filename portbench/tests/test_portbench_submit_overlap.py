"""The reader of loop.submit_overlap_pct (the program's counter
submit_tail_overlap_ms over its span front.submit) on contexts written
by hand, its None where there is nothing to read (an older program
without the counter), and in a traced run at a tiny size."""
from __future__ import annotations

import pytest

from conftest import CPU_FRONT, PB
from portbench.harness import run_cell
from portbench.spec import load_reader

NAME = "loop.submit_overlap_pct"


def reader():
    return load_reader(PB / "metrics" / f"{NAME}.py")


def ctx(before, after):
    return {"stats_before": before, "stats_after": after, "bp": 1000,
            "reads": 10, "window_s": 1.0, "setup": {}, "trace": None}


BEFORE = {"n_share_dev": 1000, "submit_tail_overlap_ms": 20.0,
          "span_ms": {"front.submit": 100.0}}
AFTER = {"n_share_dev": 3000, "submit_tail_overlap_ms": 170.0,
         "span_ms": {"front.submit": 300.0}}


def test_value():
    # 150 of 200 ms of submit ran beside a tail call
    assert reader()(ctx(BEFORE, AFTER)) == pytest.approx(75)


def test_first_window_without_earlier_spans():
    """A span and a counter that first appear inside the window count
    whole."""
    assert reader()(ctx({"n_share_dev": 0}, AFTER)) == pytest.approx(
        100 * 170 / 300)


@pytest.mark.parametrize("later", [
    {"n_share_dev": 3000, "tail_ms": 90.0},
    {"n_share_dev": 3000, "span_ms": {"front.submit": 300.0}},
], ids=["no_spans", "span_without_counter"])
def test_none_without_the_counter(later):
    """An older program: no spans at all, or the span front.submit and
    no tail worker (the parent of the worker). Nothing to read, not 0."""
    plain = {"n_share_dev": 1000, "span_ms": {"front.submit": 100.0}}
    assert reader()(ctx(plain, later)) is None


def test_none_where_the_denominator_is_zero():
    """No submit in the window."""
    assert reader()(ctx(BEFORE, BEFORE)) is None


def test_zero_overlap_is_a_reading():
    after = dict(AFTER, submit_tail_overlap_ms=20.0)
    assert reader()(ctx(BEFORE, after)) == 0.0


def test_traced_tiny_run_reports_it(tiny_spec):
    """The traced run at a tiny size on the CPU reads a share."""
    res = run_cell(tiny_spec.cell("t.lr"), 2**31 + 83, 1.0, True,
                   device="cpu", front_kw=CPU_FRONT)
    assert res["correct"] is True
    m = res["metrics"]
    assert NAME in m, m
    assert 0 <= m[NAME]["value"] <= 100
    assert m[NAME]["unit"] == "%"
