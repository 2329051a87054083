"""``cli.train`` starting its own ranks: with no launcher environment
(``RANK`` unset) ``--dp 2`` spawns two fresh processes over gloo on the CPU,
which rendezvous through a file store; rank 0 alone writes the records, and
step 1's loss equals ``--dp 1``'s (fp32, rtol 1e-6: the same sum in
another order)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dynamictreeattn_tpu_torch.cli import train as cli_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["--device", "cpu", "--model", "qwen3-tiny", "--dtype", "fp32", "--attn-backend", "reference",
       "--block-q", "32", "--block-kv", "32", "--lr", "1e-3", "--steps", "2",
       "--data", "synthetic:n_prompts=2,samples=4,prompt_lo=8,prompt_hi=12,completion_lo=4,completion_hi=8"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_cli_train_spawns_its_ranks(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "dynamictreeattn_tpu_torch.cli.train", *CLI, "--dp", "2",
                          "--stats-out", str(tmp_path / "dp2.jsonl")], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 2  # rank 0's records only
    mesh = _records(tmp_path / "dp2.jsonl")
    cli_train.main(CLI + ["--stats-out", str(tmp_path / "dp1.jsonl")])
    one = _records(tmp_path / "dp1.jsonl")
    assert len(mesh) == len(one) == 2
    np.testing.assert_allclose(mesh[0]["loss"], one[0]["loss"], rtol=1e-6)
    assert [r["n_tokens"] for r in mesh] == [r["n_tokens"] for r in one]
    assert not [f for f in os.listdir(tmp_path) if f.startswith("cli_train_")]  # the store's directory is gone
