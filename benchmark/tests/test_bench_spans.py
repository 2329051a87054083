"""The readers of the program's own spans and counters, on synthetic runs:
host_serial_ms leaves out traced steps and the step after each,
moe_block_ms and moe_drop_share read the untraced steps' parts,
rollout_capture_ms sums the capture spans of a traced rollout; each reads
nothing where the program (the parent commit's) keeps no such part."""

import pytest

import harness


def reader(name):
    return harness.load_module(harness.reader_path(name)).read


def run(units, traces=()):
    return harness.Run({}, {}, units, list(traces), {}, {}, 0, 0)


def step(traced=False, **parts):
    return {"traced": traced, "parts_ms": parts}


def test_host_serial_leaves_out_traced_steps_and_their_successors():
    units = [step(), step(host_serial=10.0), step(True, host_serial=50.0), step(host_serial=90.0),
             step(host_serial=14.0), step(host_serial=12.0)]
    assert reader("host_serial_ms")(run(units)) == pytest.approx((10.0 + 14.0 + 12.0) / 3)


def test_moe_block_and_drop_share_read_untraced_steps():
    units = [step(moe=100.0, **{"moe.pairs": 1000, "moe.dropped": 500}),
             step(True, moe=300.0, **{"moe.pairs": 1000, "moe.dropped": 1000}),
             step(moe=120.0, **{"moe.pairs": 3000, "moe.dropped": 1000})]
    assert reader("moe_block_ms")(run(units)) == pytest.approx(110.0)
    assert reader("moe_drop_share")(run(units)) == pytest.approx(100 * 1500 / 4000)


def test_rollout_capture_sums_the_spans_of_each_traced_rollout():
    events = [(harness.UNIT_SPAN, 0, 10_000_000, False), ("kernel", 1, 2, True),
              ("generate.prefill", 0, 2_000_000, False), ("generate.capture", 2_000_000, 3_500_000, False),
              ("generate.capture", 3_600_000, 4_000_000, False), ("generate.decode", 4_000_000, 9_000_000, False)]
    tr = harness.collect(events)
    assert reader("rollout_capture_ms")(run([], [tr])) == pytest.approx(1.9)


def test_nothing_to_read_where_the_program_keeps_nothing():
    """The parent commit's runs: parts without the new names, traces
    without the capture span."""
    units = [step(engine=600.0, clip=2.0, adamw=20.0) for _ in range(4)]
    tr = harness.collect([(harness.UNIT_SPAN, 0, 10, False), ("kernel", 1, 2, True), ("aten::cat", 2, 3, False)])
    for name in ("host_serial_ms", "moe_block_ms", "moe_drop_share", "rollout_capture_ms"):
        assert reader(name)(run(units, [tr])) is None
        assert reader(name)(run([])) is None
