"""The host pieces the command lines read, against the JAX package: sequence
IO and data specs (data/io.py), the trie cost features (tries/stats.py),
the TokenTrie methods of the data-parallel balancers and permutes, and the
device memory statistics (utils/profiling.py).

Everything here is host numpy and must equal the JAX package exactly, on
random tries and on the committed ``data/synthetic-tau2/call{0..3}.npz``
(including the JAX package's backward-mode ``sum_prefix_len`` /
``n_f1_tokens``, which differ from the upstream prototype's formulas:
matched, not fixed).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.data.io import load_sequences as jax_load_sequences
from dynamictreeattn_tpu.data.io import parse_data_spec as jax_parse_data_spec
from dynamictreeattn_tpu.data.io import save_sequences as jax_save_sequences
from dynamictreeattn_tpu.tries import TokenTrie as JaxTokenTrie
from dynamictreeattn_tpu.tries import trie_stats as jax_trie_stats
from dynamictreeattn_tpu_torch.data import load_sequences, parse_data_spec, save_sequences
from dynamictreeattn_tpu_torch.tries import TokenTrie, trie_stats
from dynamictreeattn_tpu_torch.utils import device_memory_stats

from helpers import random_trie_batch

TAU2 = sorted((Path(__file__).resolve().parent.parent / "data" / "synthetic-tau2").glob("call*.npz"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as every port test file: leaves the cores to the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tries(seed):
    """The same random sequences as a port and a JAX TokenTrie."""
    seqs, attachs = random_trie_batch(np.random.default_rng(seed), n_seqs=30, vocab=5, max_len=40)
    return TokenTrie(seqs, attachs), JaxTokenTrie(seqs, attachs)


@pytest.mark.parametrize("fmt", [".pt", ".npz"])
def test_roundtrip_and_cross_package(tmp_path, fmt):
    seqs = [np.arange(i + 1, dtype=np.int32) * 7 for i in range(12)] + [np.array([151935], np.int32)]
    save_sequences(str(tmp_path / f"port{fmt}"), seqs)
    jax_save_sequences(str(tmp_path / f"jax{fmt}"), seqs)
    for name in ("port", "jax"):
        for load in (load_sequences, jax_load_sequences):
            got = load(str(tmp_path / f"{name}{fmt}"))
            assert len(got) == len(seqs)
            assert all(g.dtype == np.int32 and np.array_equal(g, s) for g, s in zip(got, seqs))


def test_unsupported_extension_raises(tmp_path):
    with pytest.raises(ValueError):
        save_sequences(str(tmp_path / "x.txt"), [np.zeros(2, np.int32)])
    with pytest.raises(ValueError):
        load_sequences(str(tmp_path / "x.txt"))


@pytest.mark.parametrize("spec", [
    "synthetic:",
    "synthetic:n_prompts=2,samples=6,prompt_lo=32,prompt_hi=64,completion_lo=8,completion_hi=16,"
    "branch_prob=0.9,seed=3",
    "synthetic:n_prompts=1,samples=3,prompt_lo=8,prompt_hi=12,completion_lo=4,completion_hi=8",
    "synthetic:seed=5,branch_prob=0.0,samples=4",
] + [str(p) for p in TAU2])
def test_parse_data_spec_matches_jax(spec):
    seqs, attachs = parse_data_spec(spec, vocab_size=1000)
    want_seqs, want_attachs = jax_parse_data_spec(spec, vocab_size=1000)
    assert attachs == want_attachs and len(seqs) == len(want_seqs) > 0
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(seqs, want_seqs))


def test_tau2_files_are_the_protocol_data():
    seqs, _ = parse_data_spec(str(TAU2[0]), vocab_size=151936)
    assert len(TAU2) == 4 and len(seqs) == 16 and sum(len(s) for s in seqs) == 30831


@pytest.mark.parametrize("mode", ["forward", "backward"])
@pytest.mark.parametrize("block_size", [0, 16, 128, 2048])
def test_trie_stats_match_jax(mode, block_size):
    for seed in range(3):
        trie, jtrie = _tries(seed)
        trie.forward_permute()
        jtrie.forward_permute()
        want = jax_trie_stats(jtrie.lens, jtrie.lcp_lens, mode=mode, block_size=block_size)
        assert trie_stats(trie.lens, trie.lcp_lens, mode=mode, block_size=block_size) == want
        assert trie.get_stats(mode=mode, block_size=block_size) == jtrie.get_stats(mode=mode,
                                                                                  block_size=block_size)


@pytest.mark.parametrize("path", TAU2, ids=[p.name for p in TAU2])
@pytest.mark.parametrize("permute", ["forward_permute", "backward_permute"])
def test_tau2_stats_match_jax(path, permute):
    seqs = load_sequences(str(path))
    trie, jtrie = TokenTrie(seqs), JaxTokenTrie(seqs)
    getattr(trie, permute)()
    getattr(jtrie, permute)()
    assert trie.n_sequences == jtrie.n_sequences == len(seqs)
    for mode in ("forward", "backward"):
        for block in (128, 512):
            assert trie.get_stats(mode, block) == jtrie.get_stats(mode, block)


def test_trie_stats_rejects_bad_lcp():
    with pytest.raises(ValueError):
        trie_stats([3, 4], [1, 2])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_permute_matches_jax(seed):
    trie, jtrie = _tries(seed)
    trie.random_permute(seed=seed)
    jtrie.random_permute(seed=seed)
    assert all(np.array_equal(a, b) for a, b in zip(trie.inputs, jtrie.inputs))
    np.testing.assert_array_equal(trie.lcp_lens, jtrie.lcp_lens)
    assert trie.attach_lists == jtrie.attach_lists


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lcp_range_min_and_subset_lens_match_jax(seed):
    trie, jtrie = _tries(seed)
    trie.backward_permute()
    jtrie.backward_permute()
    n = trie.n_leaves
    for lo in range(n - 1):
        for hi in range(lo + 1, n):
            got = trie.lcp_range_min(lo, hi)
            assert got == jtrie.lcp_range_min(lo, hi) == int(trie.lcp_lens[lo:hi].min())
    with pytest.raises(ValueError):
        trie.lcp_range_min(3, 3)
    rng = np.random.default_rng(seed)
    for _ in range(10):
        ids = rng.choice(n, size=rng.integers(1, n + 1), replace=False)
        lens, lcps = trie.subset_lens(ids)
        want_lens, want_lcps = jtrie.subset_lens(ids)
        np.testing.assert_array_equal(lens, want_lens)
        np.testing.assert_array_equal(lcps, want_lcps)
        assert lcps.dtype == np.int64
    trie.permute(list(range(n))[::-1])  # a permute drops the sparse table
    assert trie.lcp_range_min(0, n - 1) == int(trie.lcp_lens.min())


def test_device_memory_stats_on_the_cpu():
    assert device_memory_stats("cpu") == {}
    assert device_memory_stats(torch.device("cpu")) == {}
