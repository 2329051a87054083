"""The cost model, the load balancers and their CLIs against the JAX package.

Host numpy/scipy on both sides, so every comparison is exact: the
TreeTimeModel's coefficients, predictions and error on the same records
(cold start, the 16-point refit, the 1024-point window), the three
balancers' bins and ``eval_bins`` on random tries, and the four CLIs'
output files and text on the same inputs.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from dynamictreeattn_tpu import parallel as jax_parallel
from dynamictreeattn_tpu.cli import calc_time as jax_calc_time
from dynamictreeattn_tpu.cli import data_parallel as jax_data_parallel
from dynamictreeattn_tpu.cli import remark as jax_remark
from dynamictreeattn_tpu.cli import time_model as jax_time_model_cli
from dynamictreeattn_tpu.parallel.time_model import TreeTimeModel as JaxTreeTimeModel
from dynamictreeattn_tpu_torch import parallel
from dynamictreeattn_tpu_torch.cli import calc_time, data_parallel, remark
from dynamictreeattn_tpu_torch.cli import time_model as time_model_cli
from dynamictreeattn_tpu_torch.data.io import save_sequences
from dynamictreeattn_tpu_torch.parallel import FEATURES, TreeTimeModel
from dynamictreeattn_tpu_torch.tries import TokenTrie, trie_stats

from helpers import random_trie_batch


def _records(n: int, seed: int = 0) -> list[dict]:
    """Stats records of random tries, time linear in the features plus noise."""
    rng = np.random.default_rng(seed)
    coef = np.array([2e-4, 3e-5, 1e-5, 1e-6, 2e-8])
    out = []
    for _ in range(n):
        seqs, _ = random_trie_batch(rng, n_seqs=int(rng.integers(2, 12)), vocab=5, max_len=60)
        trie = TokenTrie(seqs, [{} for _ in seqs])
        trie.backward_permute()
        st = trie_stats(trie.lens, trie.lcp_lens, mode="backward", block_size=16)
        st["time"] = float(np.dot(coef, [st[f] for f in FEATURES]) * (1 + 0.05 * rng.standard_normal()))
        out.append(st)
    return out


def _same_model(a, b) -> None:
    assert (a.coef is None) == (b.coef is None)
    if a.coef is not None:
        np.testing.assert_array_equal(a.coef, b.coef)
    assert a._X == b._X and a._y == b._y
    assert np.array_equal(a.avg_rel_error(), b.avg_rel_error(), equal_nan=True)


@pytest.mark.parametrize("n", [0, 10, 16, 40, 1100])
def test_time_model_matches_jax(n):
    """Cold start (< 16 points: n_tree_tokens), the first refit at 16, and
    the window of the last 1024 of 1100 points: the same coefficients,
    predictions and average relative error as JAX's, added one by one and
    in one list."""
    recs = _records(n)
    probe = _records(5, seed=1)
    ours, theirs = TreeTimeModel(), JaxTreeTimeModel()
    for r in recs[: n // 2]:
        ours.add_data(r)
        theirs.add_data(r)
    ours.add_data(recs[n // 2:])
    theirs.add_data(recs[n // 2:])
    _same_model(ours, theirs)
    assert len(ours._y) == min(n, 1024)
    assert (ours.coef is None) == (n < 16)
    for st in probe:
        assert ours.pred(st) == theirs.pred(st)
        if n < 16:
            assert ours.pred(st) == st["n_tree_tokens"]


def _fitted(seed: int = 0):
    recs = _records(40, seed)
    ours, theirs = TreeTimeModel(), JaxTreeTimeModel()
    ours.add_data(recs)
    theirs.add_data(recs)
    return ours, theirs


@pytest.mark.parametrize("K", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_balancers_match_jax(seed, K):
    """LB_by_n_tokens, LB_by_TM and LB_by_DFS_and_TM give JAX's bins exactly
    on random tries (fitted and cold-start time models), and eval_bins JAX's
    predicted times."""
    rng = np.random.default_rng(100 + seed)
    seqs, _ = random_trie_batch(rng, n_seqs=14, vocab=4, max_len=50)
    assert parallel.LB_by_n_tokens(seqs, K) == jax_parallel.LB_by_n_tokens(seqs, K)
    for ours, theirs in (_fitted(seed), (TreeTimeModel(), JaxTreeTimeModel())):
        for name in ("LB_by_TM", "LB_by_DFS_and_TM"):
            got = getattr(parallel, name)(seqs, ours, K, block_size=16)
            want = getattr(jax_parallel, name)(seqs, theirs, K, block_size=16)
            assert got == want, name
            assert sorted(i for b in got for i in b) == list(range(len(seqs)))
            assert (parallel.eval_bins(seqs, got, ours, block_size=16)
                    == jax_parallel.eval_bins(seqs, want, theirs, block_size=16))


@pytest.fixture
def stats_and_data(tmp_path):
    """A data folder of three .npz batches and a stats JSONL with a record
    per file and bin (times, token counts), plus records without files."""
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(7)
    recs = _records(20, seed=3)
    for i in range(3):
        seqs, _ = random_trie_batch(rng, n_seqs=10, vocab=6, max_len=40)
        save_sequences(str(data / f"call{i}.npz"), seqs)
        for k in range(2):
            recs.append({"file": f"call{i}_bin{k}.npz", "run": "tree_backward", "time": 0.1 * (i + k + 1),
                         "n_tokens": 100 * (i + 1) + k, "block_size": 16})
        recs.append({"file": f"call{i}.npz", "run": "tree_forward", "time": 0.05 * (i + 1),
                     "n_tokens": 10})
    stats = tmp_path / "stats.jsonl"
    stats.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return stats, data


def _out(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("min_points", ["16", "100"])
def test_time_model_cli_matches_jax(stats_and_data, min_points):
    stats, _ = stats_and_data
    argv = ["--stats", str(stats), "--min-points", min_points]
    assert _out(time_model_cli.main, argv) == _out(jax_time_model_cli.main, argv)


def test_remark_cli_matches_jax(stats_and_data, tmp_path):
    stats, data = stats_and_data
    outs = {}
    for name, main in (("ours", remark.main), ("theirs", jax_remark.main)):
        path = tmp_path / f"{name}.jsonl"
        text = _out(main, ["--stats", str(stats), "--data-dir", str(data), "--out", str(path)])
        outs[name] = (text.replace(str(path), "OUT"), path.read_text())
    assert outs["ours"] == outs["theirs"]
    assert "n_tree_tokens" in outs["ours"][1]


def test_calc_time_cli_matches_jax(stats_and_data):
    stats, _ = stats_and_data
    argv = ["--stats", str(stats)]
    text = _out(calc_time.main, argv)
    assert text == _out(jax_calc_time.main, argv)
    assert json.loads(text.splitlines()[-1])["aggregate"]


@pytest.mark.parametrize("method", ["LB_by_n_tokens", "LB_by_TM", "LB_by_DFS_and_TM"])
def test_data_parallel_cli_matches_jax(stats_and_data, tmp_path, method):
    """The same bin files (names and sequences) and the same text."""
    stats, data = stats_and_data
    outs = {}
    for name, main in (("ours", data_parallel.main), ("theirs", jax_data_parallel.main)):
        out_dir = tmp_path / name
        text = _out(main, ["--data-dir", str(data), "--glob", "*.npz", "--K", "3", "--method", method,
                           "--block-size", "16", "--stats", str(stats), "--out-dir", str(out_dir), "--eval"])
        files = {}
        for f in sorted(os.listdir(out_dir)):
            with np.load(out_dir / f) as z:
                files[f] = [z[k].tolist() for k in sorted(z.files)]
        outs[name] = (text, files)
    assert outs["ours"] == outs["theirs"]
    assert len(outs["ours"][1]) == 9
