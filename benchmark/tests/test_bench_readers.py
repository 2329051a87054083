"""The trace readers on synthetic intervals: overlapping device operations
count once, a trace without a device operation is an error, a reader with
nothing to read returns nothing."""

import pytest

import harness


def trace(device, window=(0, 100), unit=None):
    events = [(n, s, e, True) for n, s, e in device] + [(harness.UNIT_SPAN, *window, False), ("aten::mm", 10, 40, False)]
    tr = harness.collect(events)
    tr.unit = unit or {}
    return tr


def test_overlap_counts_once():
    tr = trace([("a", 10, 30), ("b", 20, 40), ("c", 60, 70), ("d", 90, 120)])
    assert tr.busy_ns() == 30 + 10 + 10  # [10, 40), [60, 70), [90, 100) inside the window
    assert harness.idle_gaps([(s, e) for _, s, e in tr.device], tr.window) == [(0, 10), (40, 60), (70, 90)]


def test_no_device_event_is_an_error():
    with pytest.raises(RuntimeError, match="device time not measured"):
        harness.collect([(harness.UNIT_SPAN, 0, 10, False), ("aten::mm", 1, 2, False)])
    with pytest.raises(RuntimeError):
        harness.collect([("kernel", 0, 10, True)])


def test_idle_share_and_breakdown():
    twins = [{"work": w, "wall_s": s * 1e-9} for w, s in (("a", 100), ("a", 130), ("a", 110), ("b", 60))]
    traced = [trace([("k1", 0, 50)], unit={"work": "a", "traced": True}),
              trace([("k2", 0, 25)], unit={"work": "b", "traced": True})]
    run = harness.Run({}, {}, twins + [t.unit for t in traced], traced, {}, {}, 0, 0)
    # busy over the median untraced wall of the same work, not over the traced (stretched) window
    assert run.idle_share() == pytest.approx(100 * (1 - 75 / (110 + 60)))
    assert harness.Run({}, {}, twins[:1] + [traced[1].unit], traced[1:], {}, {}, 0, 0).idle_share() is None
    b = harness.breakdown(run.traces)
    assert b["device_ops"] == [["k1", 50e-9], ["k2", 25e-9]]
    assert b["idle_gaps"][0][0] in ("aten::mm", "(no host event)")


def test_kernel_share_and_empty_readers():
    run = harness.Run({}, {}, [], [trace([("tree_attn_fwd_kernel", 0, 40), ("tree_attn_fwd_kernel", 50, 90)])],
                      {}, {}, 0, 0)
    assert run.kernel_share(("tree_attn_fwd",), lambda tr: 40e-9) == pytest.approx(50.0)
    assert run.kernel_share(("decode_attn_kernel",), lambda tr: 1.0) is None
    empty = harness.Run({}, {}, [], [], {}, {}, 0, 0)
    for name in ("prepare_ms", "engine_ms", "optimizer_ms", "mfu.train", "mfu.rollout", "device_idle_share.train",
                 "device_idle_share.rollout"):
        assert harness.load_module(harness.reader_path(name)).read(empty) is None
