"""The reader of front.graph_replay_pct (the program's counters
n_step_replays and n_step_eager) on contexts written by hand, its None
where there is nothing to read (an older program without the counters,
a window with no bucket batch on the card), and in a traced run at a
tiny size on the CPU, whose front runs no batch on the card."""
from __future__ import annotations

import pytest

from conftest import CPU_FRONT, PB
from portbench.harness import run_cell
from portbench.spec import load_reader

NAME = "front.graph_replay_pct"


def reader():
    return load_reader(PB / "metrics" / f"{NAME}.py")


def ctx(before, after):
    return {"stats_before": before, "stats_after": after, "bp": 1000,
            "reads": 10, "window_s": 1.0, "setup": {}, "trace": None}


BEFORE = {"n_batches": 40, "n_step_replays": 37, "n_step_eager": 3}
AFTER = {"n_batches": 440, "n_step_replays": 435, "n_step_eager": 5}


def test_value():
    # 398 of the window's 400 batches replayed
    assert reader()(ctx(BEFORE, AFTER)) == pytest.approx(99.5)


def test_first_window_without_earlier_counters():
    """Counters that first appear inside the window count whole."""
    assert reader()(ctx({"n_batches": 0}, AFTER)) == pytest.approx(
        100 * 435 / 440)


def test_every_batch_eager_is_a_reading():
    after = dict(AFTER, n_step_replays=37, n_step_eager=403)
    assert reader()(ctx(BEFORE, after)) == 0.0


@pytest.mark.parametrize("later", [
    {"n_batches": 440},
    {"n_batches": 440, "n_step_replays": 435},
], ids=["no_counters", "one_counter"])
def test_none_without_the_counters(later):
    """An older program (the parent of the graphs): nothing to read, not
    0."""
    assert reader()(ctx({"n_batches": 40}, later)) is None


@pytest.mark.parametrize("after", [
    BEFORE, {"n_batches": 40, "n_step_replays": 0, "n_step_eager": 0}],
    ids=["no_batch_in_window", "cpu_front"])
def test_none_with_zero_batches(after):
    """No bucket batch ran on the card in the window (none at all, or a
    front on the CPU, which never captures and counts neither)."""
    before = BEFORE if after is BEFORE else {}
    assert reader()(ctx(before, after)) is None


def test_traced_tiny_run_leaves_it_out(tiny_spec):
    """The traced run at a tiny size on the CPU: the reader runs and
    finds no batch on the card, so the line leaves the metric out."""
    res = run_cell(tiny_spec.cell("t.lr"), 2**31 + 89, 1.0, True,
                   device="cpu", front_kw=CPU_FRONT)
    assert res["correct"] is True
    assert NAME not in res["metrics"]
    assert "front.submit_host_ms_per_kread" in res["metrics"]
