"""The control, the reference one precision down (fp8 e4m3 products, the
configurations state bf16) put in the program's place, comes out not
correct where the program comes out correct: at a small size on the CPU.
At the cells' own sizes the same readings come from ``calibrate.py`` on
the card."""

import pytest
import torch

import check
import generator
import harness
import tiny


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_train_control_fails(seed):
    drv = harness.load_module(harness.BENCH / "drivers" / "train.py")
    ctx = tiny.ctx(tiny.cell(tiny.TRAIN, tiny.TRAIN_LIMITS), seed=seed)
    pool = generator.train_pool(ctx.mix, ctx.cfg["vocab_size"], seed)
    control = drv.reference(ctx, pool, "fp8", keep_first=True)
    numbers = check.train_numbers(control, drv.reference(ctx, pool, against={"control": control}), "control")
    assert any(numbers[k] > tiny.TRAIN_LIMITS[k] for k in numbers), numbers


@pytest.mark.parametrize("seed", [5, 6])
def test_rollout_control_fails(seed):
    drv = harness.load_module(harness.BENCH / "drivers" / "rollout.py")
    ctx = tiny.ctx(tiny.cell(tiny.ROLLOUT, tiny.ROLLOUT_LIMITS), seed=seed)
    rollout, pool, _ = drv.start(ctx)
    greedy = [drv.unit_of(pool, b, ctx.mix, rollout(b, True)) for b in range(len(pool))]
    sampled = [drv.unit_of(pool, b, ctx.mix, rollout(b, False)) for b in range(len(pool))]
    got = drv.readings(ctx, greedy, sampled, pool, control=True)
    assert got["greedy_gap"] <= tiny.ROLLOUT_LIMITS["greedy_gap"] < got["control.greedy_gap"], got
    assert got["sample_z"] <= tiny.ROLLOUT_LIMITS["sample_z"], got


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    """One short run of each cell through the command line, on a card."""
    import json
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]:
        out = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", w["name"], "--seed", "3",
                              "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
