"""The correctness check against a broken timed path. Each test drives a
whole run of the tiny cell on the CPU (the harness's look for a card
skipped) with one fault planted under it, and sees ``correct`` come out
false; the sound run comes out true. One chip: no exchange between chips
to leave out."""

import pytest

from benchmark.harness import faults
from conftest import run_tiny


def test_sound_run_is_correct(tiny):
    records = []
    line = run_tiny(tiny, seed=21, records=records)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 3 and line["failed"] == 0
    assert set(line["metrics"]) == {"fps", "frame_ms_p90", "setup_s"}
    assert list(line)[-1] == "checks"
    rec = records[0]
    assert len(rec.call_s) == line["attempted"]
    assert line["metrics"]["fps"]["value"] == pytest.approx(rec.frames / rec.window_s)


def test_fps_and_p90_take_the_closing_flush(tiny, monkeypatch):
    """The closing flush() is inside fps's time and the last call's."""
    from hyslam_tpu_torch.slam.system import System

    flush = System.flush
    calls = []

    def slow_flush(self):
        calls.append(1)
        flush(self)
        if len(calls) > 1:          # the warm frames' flush is set-up
            __import__("time").sleep(2.0)

    monkeypatch.setattr(System, "flush", slow_flush)
    records = []
    line = run_tiny(tiny, seed=22, seconds=4.0, records=records)
    rec = records[0]
    assert rec.call_s[-1] >= 2.0
    assert rec.window_s >= 4.0 + 2.0
    assert line["metrics"]["fps"]["value"] <= line["attempted"] / 6.0
    assert len(rec.call_s) == line["attempted"]       # every call of the window
    assert line["metrics"]["frame_ms_p90"]["value"] > 1e3 * sorted(rec.call_s)[-2] - 1e-6


@pytest.mark.parametrize("fault,number", [
    ("state_unchanged", "k1_cost_gap_2nd"),  # a step that returns its state unchanged
    ("pose_altered", "k1_cost_gap_2nd"),     # an answer altered where it is produced
    ("half_batch", "fe_mismatch"),           # half of the batch left out
    ("ba_unchanged", "ba_cost_gap"),         # local BA returns its state unchanged
])
def test_a_planted_fault_is_not_correct(tiny, monkeypatch, fault, number):
    faults.plant(fault, monkeypatch.setattr)
    line = run_tiny(tiny, seed=23)
    assert not line["correct"]
    assert line["checks"][number]["value"] > line["checks"][number]["limit"]
