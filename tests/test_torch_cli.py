"""The port's command lines against the JAX package's (cli/run.py,
cli/run_all.py, cli/compare_grads.py; the counterparts of
tests/test_cli.py's grad-parity, forward/synthetic and run_all cases).

CPU, fp32 qwen3-tiny, the reference backend, the JAX tests' flags plus
``--device cpu``. The two packages draw their random weights from different
generators, so losses are compared within each package, and across the
packages only what the weights do not decide: each record's keys, the trie
statistics (exactly), the grad files' keys and shapes, and the text of the
grad-parity table on the same two files (exactly). Inside the port: tree ==
dense loss (rtol 1e-4) and grads (max rel < 1e-3), the JAX suite's bars.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.cli import compare_grads as jax_compare_cli
from dynamictreeattn_tpu.cli import run as jax_run
from dynamictreeattn_tpu.cli import run_all as jax_run_all
from dynamictreeattn_tpu.utils.compare_grads import format_grad_table as jax_format_grad_table
from dynamictreeattn_tpu_torch.cli import common, run, run_all
from dynamictreeattn_tpu_torch.cli import compare_grads as compare_cli
from dynamictreeattn_tpu_torch.data.io import save_sequences
from dynamictreeattn_tpu_torch.utils import compare_grads, format_grad_table

from helpers import random_trie_batch

JAX_COMMON = ["--model", "qwen3-tiny", "--dtype", "fp32", "--attn-backend", "reference",
              "--block-q", "32", "--block-kv", "32", "--loss-chunk", "32", "--no-remat", "--iters", "1"]
COMMON = JAX_COMMON + ["--device", "cpu"]
STAT_KEYS = ("run", "model", "dtype", "attn_backend", "permute", "n_sequences", "n_tokens", "block_size",
             "n_leaf_sequences", "n_tree_tokens", "n_f1_tokens", "sum_prefix_len", "sum_depth",
             "n_padded_tokens")
RUNS = ["tree_forward", "tree_backward", "dense_forward", "dense_backward"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    for i in range(2):
        seqs, _ = random_trie_batch(rng, n_seqs=6, vocab=128, max_len=20)
        save_sequences(str(d / f"call{i}.npz"), seqs)
    return d


@pytest.fixture(scope="module")
def runs(data_dir):
    """{(package, run): record}, and the grad files of the backward runs
    under data_dir/grads/<package>_<run>.npz."""
    out_dir = data_dir.parent / "grads"
    out_dir.mkdir(exist_ok=True)
    records = {}
    for pkg, main, common_args in (("jax", jax_run.main, JAX_COMMON), ("port", run.main, COMMON)):
        for r in RUNS:
            extra = ["--grad-out", str(out_dir / f"{pkg}_{r}.npz")] if r.endswith("backward") else []
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                main(common_args + ["--data", str(data_dir / "call0.npz"), "--run", r] + extra)
            [records[pkg, r]] = _json_lines(out.getvalue())
    return records, out_dir


@pytest.mark.parametrize("which", RUNS)
def test_run_record_matches_jax(runs, which):
    records, _ = runs
    jax_rec, rec = records["jax", which], records["port", which]
    assert list(rec) == list(jax_rec)  # same keys, same order; no peak_mem_gb on the CPU
    assert {k: rec[k] for k in STAT_KEYS} == {k: jax_rec[k] for k in STAT_KEYS}
    assert rec["time"] > 0 and rec["tokens_per_s"] > 0
    assert np.isfinite(rec["loss" if which.endswith("backward") else "sum_logprobs"])


def test_grad_files_match_jax_keys_and_shapes(runs):
    _, out_dir = runs
    for r in ("tree_backward", "dense_backward"):
        want = common.load_grads_npz(str(out_dir / f"jax_{r}.npz"))
        got = common.load_grads_npz(str(out_dir / f"port_{r}.npz"))
        assert sorted(got) == sorted(want)
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == {k: (v.shape, v.dtype) for k, v in want.items()}


@pytest.mark.parametrize("pair,top", [(("jax_dense_backward", "jax_tree_backward"), None),
                                      (("port_dense_backward", "port_tree_backward"), None),
                                      (("jax_tree_backward", "port_tree_backward"), 5)])
def test_compare_grads_text_matches_jax(runs, capsys, pair, top):
    _, out_dir = runs
    argv = ["--baseline-grad", str(out_dir / f"{pair[0]}.npz"), "--exp-grad", str(out_dir / f"{pair[1]}.npz")]
    argv += [] if top is None else ["--top", str(top)]
    jax_compare_cli.main(argv + ["--out", str(out_dir / "jax_table.txt")])
    want = capsys.readouterr().out
    compare_cli.main(argv + ["--out", str(out_dir / "port_table.txt")])
    assert capsys.readouterr().out == want
    assert (out_dir / "port_table.txt").read_text() == (out_dir / "jax_table.txt").read_text()


def test_cli_tree_dense_grad_parity(runs, data_dir, capsys):
    """The protocol inside the port: tree and dense backward runs agree."""
    records, out_dir = runs
    np.testing.assert_allclose(records["port", "tree_backward"]["loss"],
                               records["port", "dense_backward"]["loss"], rtol=1e-4)
    compare_cli.main(["--baseline-grad", str(out_dir / "port_dense_backward.npz"),
                      "--exp-grad", str(out_dir / "port_tree_backward.npz")])
    tail = capsys.readouterr().out.strip().splitlines()[-1]
    assert float(tail.split("max")[1].split()[0]) < 1e-3, tail
    stats = data_dir.parent / "stats.jsonl"
    run.main(COMMON + ["--data", str(data_dir / "call1.npz"), "--run", "tree_backward",
                       "--stats-out", str(stats)])
    [rec] = [json.loads(line) for line in stats.read_text().splitlines()]
    assert "grad_norm" in rec and rec["grad_norm"] > 0 and "ts" in rec


def test_run_forward_and_synthetic_spec(capsys):
    run.main(COMMON + ["--data", "synthetic:n_prompts=1,samples=3,prompt_lo=8,prompt_hi=12,"
                       "completion_lo=4,completion_hi=8", "--run", "tree_forward"])
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["tokens_per_s"] > 0 and "sum_logprobs" in rec and rec["n_sequences"] == 3


@pytest.mark.parametrize("which", ["tree_backward", "dense_forward"])
def test_run_all_matches_jax(data_dir, tmp_path, capsys, which):
    argv = ["--data-dir", str(data_dir), "--glob", "*.npz", "--run", which]
    jax_run_all.main(JAX_COMMON + argv + ["--stats-out", str(tmp_path / "jax.jsonl")])
    want = _json_lines(capsys.readouterr().out)
    run_all.main(COMMON + argv + ["--stats-out", str(tmp_path / "port.jsonl")])
    got = _json_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 3 and got[-1]["aggregate"] and got[-1]["tokens_per_s"] > 0
    assert list(got[-1]) == list(want[-1])
    for g, w in zip(got[:-1], want[:-1]):
        assert list(g) == list(w)
        assert {k: g[k] for k in STAT_KEYS if k in w} == {k: w[k] for k in STAT_KEYS if k in w}
        assert (g["loss"] is None) == (w["loss"] is None)
    saved = [json.loads(line) for line in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert [r["file"] for r in saved] == ["call0.npz", "call1.npz"]


@pytest.mark.parametrize("flags,item", [(["--ckpt", "some/dir"], "item 11")])
def test_unported_flags_raise(data_dir, flags, item):
    """A flag whose ROADMAP item has been ported no longer raises naming the
    item: --ckpt (item 11, HF checkpoints) loads through
    models/hf_compat.py, which refuses a directory without safetensors
    shards (tests/test_torch_hf_compat.py loads real ones)."""
    with pytest.raises(FileNotFoundError, match="no safetensors under some/dir") as err:
        run.main(COMMON + flags + ["--data", str(data_dir / "call0.npz"), "--run", "tree_forward"])
    assert item not in str(err.value)


@pytest.mark.parametrize("flags", [["--remat-policy", "attn"], ["--remat-segments", "2"]])
def test_remat_flags_reach_the_engine(data_dir, capsys, flags):
    """--remat-policy / --remat-segments reach EngineConfig, and the tree
    backward under them gives the loss of the run without remat."""
    argv = ["--data", str(data_dir / "call0.npz"), "--run", "tree_backward"]
    run.main(COMMON + argv)
    want = _json_lines(capsys.readouterr().out)[-1]["loss"]
    run.main([a for a in COMMON if a != "--no-remat"] + flags + argv)
    got = _json_lines(capsys.readouterr().out)[-1]["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    p = __import__("argparse").ArgumentParser()
    common.add_model_args(p)
    common.add_engine_args(p)
    ec = common.build_engine(common.MODEL_CONFIGS["qwen3-tiny"], p.parse_args(flags + ["--device", "cpu"]))[1]
    assert (ec.remat_policy, ec.remat_segments) == (("attn", 0) if "attn" in flags else (None, 2))


def test_pallas_backend_is_the_kernel_backend():
    import argparse

    p = argparse.ArgumentParser()
    common.add_model_args(p)
    common.add_engine_args(p)
    args = p.parse_args(["--model", "qwen3-tiny", "--attn-backend", "pallas", "--loss-chunk", "7",
                         "--device", "cpu"])
    engine, ec = common.build_engine(common.build_model(args)[0], args)
    assert ec.attn_backend == "kernel" and engine.device == torch.device("cpu")
    defaults = p.parse_args([])
    assert defaults.device == "cuda" and defaults.attn_backend == "kernel"


@pytest.mark.parametrize("top", [None, 3])
def test_format_grad_table_matches_jax(top):
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params

    mc = MODEL_CONFIGS["qwen3-tiny"]
    base, exp = (init_params(mc, torch.Generator().manual_seed(seed), torch.float32) for seed in (0, 1))
    rows = compare_grads(base, exp)
    assert format_grad_table(rows, top) == jax_format_grad_table(rows, top)
    assert len(format_grad_table(rows, top).splitlines()) == 1 + (len(rows) if top is None else top)
