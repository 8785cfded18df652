"""``benchmark/program_spans.py``: idle stretches put down to the port's
spans on synthetic intervals, the clock's checks, the host's split, and
window (a) on a small round on the CPU."""

import pytest
import torch

from benchmark import harness, program_spans as ps

# Host clock (ns) and trace clock (us) of one synthetic window (b), two
# marks a bracket: the trace reads the host's time + offset (-500,000 ns),
# one mark of each bracket starting late (20 and 50 us). Two steady rounds
# (each holds a driver.stage) with 200 us between them, then a last round
# that stages nothing and lies outside the interval read, [1500, 9500] us.
HOST_MARKS = ([880_000, 1_000_000], [11_000_000, 11_250_000])
MARKS = ([(400.0, 410.0), (500.0, 510.0)], [(10_500.0, 10_510.0), (10_800.0, 10_810.0)])


def _span(span, parent, name, start_us, end_us):
    return {"span": span, "parent": parent, "name": name, "start_ns": int(start_us * 1e3 + 500_000),
            "end_ns": int(end_us * 1e3 + 500_000)}


SPANS = [_span(1, None, "driver.round", 1500, 5800), _span(2, 1, "mesh.slot", 2000, 5500),
         _span(3, 2, "train.forward", 2500, 3500), _span(4, 1, "driver.stage", 5500, 5700),
         _span(5, None, "driver.round", 6000, 9500), _span(6, 5, "driver.stage", 6100, 6400),
         _span(7, None, "driver.round", 9600, 10_400), _span(8, 7, "train.forward", 9650, 9700)]
DEVICE = [("spin_kernel", *m) for bracket in MARKS for m in bracket] + [
    ("conv", 1000.0, 2200.0), ("bce_sums_kernel", 3000.0, 3010.0), ("conv", 3600.0, 5000.0),
    ("bce_sums_kernel", 9800.0, 9810.0)]
WINDOW = 9500.0 - 1500.0


def test_the_innermost_span_takes_an_idle_stretch():
    segs = ps.label_segments([(0, 10, "driver.round"), (2, 8, "mesh.slot"), (3, 5, "train.forward")], 0, 10)
    assert segs == [("driver.round", 0, 2), ("mesh.slot", 2, 3), ("train.forward", 3, 5), ("mesh.slot", 5, 8),
                    ("driver.round", 8, 10)]
    assert ps.attribute_idle([(3.5, 4.5)], segs) == {"train.forward": 1.0}


def test_a_stretch_crossing_a_boundary_is_split_at_it():
    segs = ps.label_segments([(0, 10, "driver.round"), (2, 8, "mesh.slot")], 0, 10)
    assert ps.attribute_idle([(1, 3), (7, 9)], segs) == {"driver.round": 2.0, "mesh.slot": 2.0}


def test_idle_under_no_span_is_unspanned_and_siblings_stay_apart():
    segs = ps.label_segments([(2, 4, "driver.stage"), (4, 6, "driver.round")], 0, 10)
    assert segs == [(None, 0, 2), ("driver.stage", 2, 4), ("driver.round", 4, 6), (None, 6, 10)]
    assert ps.attribute_idle([(1, 3), (5, 7)], segs) == {None: 2.0, "driver.stage": 1.0, "driver.round": 1.0}


def test_idle_gaps_are_the_window_less_the_union_of_records():
    assert ps.idle_gaps([(2, 4), (3, 5), (7, 8), (9, 12)], 0, 10) == [(0, 2), (5, 7), (8, 9)]
    assert ps.idle_gaps([], 0, 10) == [(0, 10)]


def test_the_shares_split_the_windows_idle_share():
    out = ps.device_split(DEVICE, MARKS, SPANS, HOST_MARKS)
    busy = 700.0 + 10.0 + 1400.0
    assert out["rounds"] == 2
    assert out["idle_share"] == pytest.approx(100.0 * (WINDOW - busy) / WINDOW)
    assert sum(out["idle_by_span"].values()) == pytest.approx(out["idle_share"])
    assert out["idle_by_span"] == pytest.approx({"driver.round": 100 * 3300 / WINDOW, "(none)": 100 * 200 / WINDOW,
                                                 "train.forward": 100 * 990 / WINDOW, "mesh.slot": 100 * 900 / WINDOW,
                                                 "driver.stage": 100 * 500 / WINDOW})
    assert out["idle_dispatch_share"] == pytest.approx(100 * 990 / WINDOW)
    assert out["idle_unspanned_share"] == pytest.approx(100 * (200 + 3300) / WINDOW)
    assert out["offsets_ns"] == [-500_000.0, -500_000.0]
    assert out["clock_violations"] == 0 and out["kernels_checked"] == 1
    assert out["window_ms"] == pytest.approx(WINDOW * 1e-3)


def test_only_the_steady_rounds_are_read():
    """The rounds that stage the next one, with every span nested in them
    by parent; the last round, which stages nothing, is left out."""
    steady = ps.steady_rounds(SPANS)
    assert [rnd["span"] for rnd, _ in steady] == [1, 5]
    assert sorted(r["span"] for r in steady[0][1]) == [2, 3, 4]
    assert [r["span"] for r in steady[1][1]] == [6]
    assert ps.steady_rounds([r for r in SPANS if r["name"] != "driver.stage"]) == []
    assert "no round that stages" in ps.device_split(DEVICE, MARKS, SPANS[6:], HOST_MARKS)["retake"]


def test_each_brackets_offset_is_its_least():
    assert ps.clock_offset(MARKS[0], HOST_MARKS[0]) == (-500_000.0, 1_000_000, 20_000.0)
    assert ps.clock_offset(MARKS[1], HOST_MARKS[1]) == (-500_000.0, 11_000_000, 50_000.0)


def test_a_bracket_whose_marks_disagree_is_retaken():
    late = (MARKS[0], [MARKS[1][0], (10_900.0, 10_910.0)])
    assert "marks disagree by 150000 ns" in ps.device_split(DEVICE, late, SPANS, HOST_MARKS)["retake"]


def test_the_host_clock_maps_linearly_through_both_brackets():
    us = ps.host_to_trace((-500_000.0, 1_000_000), (-300_000.0, 11_000_000))
    assert us(1_000_000) == pytest.approx(500.0)
    assert us(11_000_000) == pytest.approx(10_700.0)
    assert us(6_000_000) == pytest.approx(5_600.0)


def test_a_window_whose_clock_drifts_too_far_is_retaken():
    def shifted(us):
        return (MARKS[0], [(a + us, b + us) for a, b in MARKS[1]])

    # The brackets' host reads are 10 ms apart: 5% of it is 500 us.
    assert "drifted" in ps.device_split(DEVICE, shifted(500.5), SPANS, HOST_MARKS)["retake"]
    out = ps.device_split(DEVICE, shifted(-400.0), SPANS, HOST_MARKS)
    assert out["drift_ns"] == pytest.approx(-400_000.0) and out["clock_violations"] == 0


def test_a_kernel_before_its_steps_forward_is_retaken():
    early = [d if d[1] != 3000.0 else ("bce_sums_kernel", 2400.0, 2410.0) for d in DEVICE]
    assert "start before" in ps.device_split(early, MARKS, SPANS, HOST_MARKS)["retake"]
    lost = [d for d in DEVICE if d[0] != "bce_sums_kernel"]
    assert "0 bce_sums_kernel records against 1" in ps.device_split(lost, MARKS, SPANS, HOST_MARKS)["retake"]


def test_brackets_are_the_short_spin_kernels():
    lead = [("spin_kernel", 10.0 * i, 10.0 * i + 9.0) for i in range(5, 30)]  # the first records dropped
    opening = [("spin_kernel", 400.0 + i, 400.5 + i) for i in range(ps.MARKS)]
    closing = [("spin_kernel", 9000.0 + i, 9000.5 + i) for i in range(ps.MARKS)]
    tail = [("spin_kernel", 9100.0 + 10 * i, 9109.0 + 10 * i) for i in range(3)]  # the last records dropped
    device = lead + opening + [("conv", 500.0, 900.0)] + closing + tail
    assert ps.brackets(device) == ([m[1:] for m in opening], [m[1:] for m in closing])
    assert ps.brackets(closing + device) is None
    assert ps.brackets(lead + opening + closing[1:]) is None
    assert ps.brackets(opening + closing) is None


def test_host_split_per_round_and_per_step():
    ms = 1_000_000

    def rnd(i, t, step_ms, pin_ms, last=False):
        """Round i from t ms: a slot of one step, its staging unless
        ``last``, and the barrier."""
        base = 10 * i
        out = [
            {"span": base + 1, "parent": None, "name": "driver.round", "start_ns": t * ms, "end_ns": (t + 50) * ms},
            {"span": base + 2, "parent": base + 1, "name": "mesh.slot", "start_ns": (t + 1) * ms,
             "end_ns": (t + 35) * ms},
            {"span": base + 3, "parent": base + 2, "name": "mesh.slot_init", "start_ns": (t + 1) * ms,
             "end_ns": (t + 4) * ms},
            {"span": base + 4, "parent": base + 2, "name": "train.forward", "start_ns": (t + 5) * ms,
             "end_ns": (t + 5 + step_ms) * ms},
            {"span": base + 5, "parent": base + 2, "name": "mesh.fold", "start_ns": (t + 31) * ms,
             "end_ns": (t + 33) * ms},
            {"span": base + 8, "parent": base + 1, "name": "driver.barrier", "start_ns": (t + 45) * ms,
             "end_ns": (t + 49) * ms},
        ]
        if not last:
            out += [{"span": base + 6, "parent": base + 1, "name": "driver.stage", "start_ns": (t + 36) * ms,
                     "end_ns": (t + 44) * ms},
                    {"span": base + 7, "parent": base + 6, "name": "data.pin", "start_ns": (t + 37) * ms,
                     "end_ns": (t + 37 + pin_ms) * ms}]
        return out

    # Three steady rounds of 20, 24 and 22 ms a step, then the last round.
    records = rnd(0, 0, 20, 2) + rnd(1, 60, 24, 4) + rnd(2, 120, 22, 3) + rnd(3, 180, 5, 0, last=True)
    out = ps.host_split(records)
    assert out["rounds"] == 3 and out["steps_per_round"] == 1
    assert out["per_round"]["step_dispatch_ms"] == pytest.approx([20.0, 24.0, 22.0])
    assert out["step_dispatch_ms"] == pytest.approx(22.0)
    assert out["slot_ms"] == pytest.approx(5.0)
    assert out["staging_ms"] == pytest.approx(8.0)
    assert out["pin_ms"] == pytest.approx(3.0)
    assert out["barrier_wait_ms"] == pytest.approx(4.0)
    assert out["round_wall_ms"] == pytest.approx(50.0)
    assert out["spread"]["step_dispatch_ms"] == pytest.approx((24.0 - 20.0) / 22.0)
    assert out["spread"]["slot_ms"] == 0.0
    assert out["by_name"]["mesh.slot"]["self_ms"] == pytest.approx(34.0 - 3 - 22 - 2)
    assert out["by_name"]["driver.round"]["self_ms"] == pytest.approx(50.0 - 34 - 8 - 4)
    assert out["by_name"]["driver.stage"]["self_ms"] == pytest.approx(8.0 - 3)
    assert out["by_name"]["driver.round"]["count"] == 1
    with pytest.raises(RuntimeError, match="no round that stages"):
        ps.host_split(rnd(3, 180, 5, 0, last=True))


def test_the_seed_comes_from_the_command_line():
    assert ps._seed(["--workload", "fed8-round-256", "--seed", "3000000019", "--trace", "1"]) == 3000000019
    assert ps._seed([]) == 0


def test_window_a_on_a_small_round(small_root):
    """The spans-only window on the CPU at the small size: two clients of
    two steps, two steady rounds (three driven), every figure read from the
    port's own spans."""
    from benchmark.drivers import rounds

    assert ps.supported()
    ctx = harness.context(small_root, "fed8-round-256", 7, torch.device("cpu"))
    ctx.traffic["check_rounds"] = 1
    state = rounds.setup(ctx)
    out = ps.spans_window(state, 2)
    assert state["next_round"] == 1 + 3
    assert out["rounds"] == 2 and out["steps_per_round"] == 2 * 2
    assert out["by_name"]["mesh.slot"]["count"] == 2 and out["by_name"]["driver.barrier"]["count"] == 1
    assert out["by_name"]["driver.stage"]["count"] == 1 and out["by_name"]["data.copy"]["count"] == 2
    for key in ("step_dispatch_ms", "slot_ms", "staging_ms", "barrier_wait_ms", "round_wall_ms"):
        assert out[key] > 0.0, key
        assert len(out["per_round"][key]) == 2, key
    # The CPU copies without pinning.
    assert out["pin_ms"] == 0.0
