"""The work arithmetic: visible pairs counted from the sequences equal a
brute-force count and the port's mask over the real rows, whatever the
port pads to."""

import numpy as np
import pytest

import generator
import work


def brute(seqs):
    prefixes = {tuple(s[:t + 1]) for s in seqs for t in range(len(s))}
    return len(prefixes), sum(len(p) for p in prefixes)


def small_batches():
    mix = {"prompts_per_step": 3, "samples_per_prompt": 5, "prompt_len": [4, 9], "completion_len": [1, 6],
           "branch_prob": 0.7, "w_logprobs": -1.0, "w_entropy": 0.1, "pool": 6, "shape_seed": 3}
    yield from (s for s, _ in generator.train_pool(mix, 7, seed=11))
    yield [np.array([1, 2, 3]), np.array([1, 2, 3]), np.array([1, 2]), np.array([1, 2, 3, 4]), np.array([5])]


@pytest.mark.parametrize("i", range(7))
def test_pairs_equal_brute_force(i):
    seqs = list(small_batches())[i]
    assert work.trie_work(seqs) == brute(seqs)


@pytest.mark.parametrize("extra", [0, 1, 64, 200])
def test_pairs_equal_the_ports_mask(extra):
    from dynamictreeattn_tpu_torch.tries import TokenTrie, flatten_trie

    for seqs in small_batches():
        trie = TokenTrie(list(seqs), [{} for _ in seqs])
        packed = flatten_trie(trie, pad_to=flatten_trie(trie).n_tokens + extra)
        n = packed.n_tokens
        seen = int((packed.last_desc[:n].astype(np.int64) - np.arange(n) + 1).sum())
        assert work.trie_work(seqs) == (n, seen)


def test_bounds_are_positive_and_bound_by_one_side():
    cfg = {"hidden_size": 1024, "head_dim": 128, "num_attention_heads": 16, "num_key_value_heads": 8,
           "num_hidden_layers": 28, "vocab_size": 151936, "intermediate_size": 3072}
    f, b = work.attn_fwd_work(cfg, 27000, 27000 * 1650)
    assert work.bound_s(f, b) == f / work.PEAK_BF16_FLOPS  # long tries: operations bound
    f, b = work.decode_work(cfg, [1024, 2048], 16, 0)
    assert work.bound_s(f, b) == b / work.PEAK_HBM_BYTES  # decode: bytes bound
    assert work.rollout_bound_s(cfg, [1024, 2048], 16, 8) > 0
