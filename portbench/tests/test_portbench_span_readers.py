"""The readers of the program's own spans and counters (front.submit_host_
ms_per_kread, front.gather_host_ms_per_kread, setup.front_tables_s) on
contexts written by hand, their None where there is nothing to read (an
older program without the spans), and in a traced run at a tiny size."""
from __future__ import annotations

import pytest

from conftest import CPU_FRONT, PB
from portbench.harness import run_cell
from portbench.spec import load_reader

NEW = ("front.submit_host_ms_per_kread", "front.gather_host_ms_per_kread",
       "setup.front_tables_s")


def reader(name):
    return load_reader(PB / "metrics" / f"{name}.py")


def ctx(before, after):
    return {"stats_before": before, "stats_after": after, "bp": 1000,
            "reads": 10, "window_s": 1.0, "setup": {}, "trace": None}


BEFORE = {"n_share_dev": 1000,
          "span_ms": {"front.submit": 100.0, "front.gather": 40.0,
                      "tail.device_share": 500.0,
                      "setup.front.tables": 4450.0}}
AFTER = {"n_share_dev": 3000,
         "span_ms": {"front.submit": 300.0, "front.gather": 340.0,
                     "tail.device_share": 1500.0,
                     "setup.front.tables": 4450.0}}


def test_values():
    c = ctx(BEFORE, AFTER)
    # (300 - 100) ms over 2000 reads; (340 - 40) ms over 2000 reads
    assert reader("front.submit_host_ms_per_kread")(c) == pytest.approx(100)
    assert reader("front.gather_host_ms_per_kread")(c) == pytest.approx(150)
    assert reader("setup.front_tables_s")(c) == pytest.approx(4.45)


def test_first_window_without_earlier_spans():
    """Spans that first appear inside the window count whole."""
    before = {"n_share_dev": 0}
    c = ctx(before, AFTER)
    assert reader("front.submit_host_ms_per_kread")(c) == pytest.approx(100)
    assert reader("setup.front_tables_s")(c) is None


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_program_spans(name):
    """An older program without the spans: stats hold the counts but
    no span_ms."""
    plain = {"n_share_dev": 1000, "tail_ms": 10.0}
    later = {"n_share_dev": 3000, "tail_ms": 90.0}
    assert reader(name)(ctx(plain, later)) is None


@pytest.mark.parametrize("name", NEW[:2])
def test_none_where_the_denominator_is_zero(name):
    """No read sent to the device, no device-share tail in the window."""
    assert reader(name)(ctx(BEFORE, BEFORE)) is None


def test_traced_tiny_run_reports_them(tiny_spec):
    """The traced run at a tiny size on the CPU: the three readers find
    the program's spans."""
    res = run_cell(tiny_spec.cell("t.lr"), 2**31 + 79, 1.0, True,
                   device="cpu", front_kw=CPU_FRONT)
    assert res["correct"] is True
    m = res["metrics"]
    assert set(NEW) <= set(m), m
    assert m["front.submit_host_ms_per_kread"]["value"] > 0
    assert m["front.gather_host_ms_per_kread"]["value"] > 0
    assert m["setup.front_tables_s"]["value"] > 0
    assert m["setup.front_tables_s"]["unit"] == "s"
