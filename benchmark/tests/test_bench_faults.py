"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (``faults.py``), and a sound run comes out
correct: the drivers at a tiny size on the CPU, past the harness's look for
a card."""

import pytest

import faults
import harness
import tiny


def drive(entry, mix, limits, seed=5):
    drv = harness.load_module(harness.BENCH / "drivers" / f"{entry}.py")
    cell = tiny.cell(mix, limits)
    run = drv.run(tiny.ctx(cell, seed=seed))
    out = harness.result_line(cell, run, False, harness.device_info("cpu", 1), {})
    return out, run


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_sound_train_run_is_correct(seed):
    out, run = drive("train", tiny.TRAIN, tiny.TRAIN_LIMITS, seed)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and run.attempted >= 1 and run.e2e["train_tokens_per_s"] > 0


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_fault_is_caught(fault):
    with faults.TRAIN[fault]():
        out, _ = drive("train", tiny.TRAIN, tiny.TRAIN_LIMITS)
    assert not out["correct"], out["checks"]


def test_sound_rollout_run_is_correct():
    out, run = drive("rollout", tiny.ROLLOUT, tiny.ROLLOUT_LIMITS)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"greedy_gap", "sample_z"} and run.e2e["rollout_tokens_per_s"] > 0


@pytest.mark.parametrize("fault", sorted(faults.ROLLOUT))
def test_rollout_fault_is_caught(fault):
    with faults.ROLLOUT[fault]():
        out, _ = drive("rollout", tiny.ROLLOUT, tiny.ROLLOUT_LIMITS)
    assert not out["correct"], out["checks"]
