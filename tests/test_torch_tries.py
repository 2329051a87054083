"""The port's host trie layer and data generator against the JAX package's.

Integer and structural outputs must be exactly equal (same numpy semantics);
float loss weights are compared at fp32 bit equality, since both sides do
the same float64 sums in the same order before the fp32 cast.
"""

import glob
import os

import numpy as np
import pytest

from dynamictreeattn_tpu.data import synthetic as jax_synth
from dynamictreeattn_tpu.engine import pack_sequences_dense as jax_pack_dense
from dynamictreeattn_tpu import tries as jt
from dynamictreeattn_tpu_torch import tries as pt
from dynamictreeattn_tpu_torch.data import sharing_ratio, synthetic_rollout_batch
from dynamictreeattn_tpu_torch.engine import pack_sequences_dense

from helpers import random_trie_batch

_NPZ = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "data",
                                     "synthetic-tau2", "call*.npz")))

PACKED_FIELDS = ("tokens", "depth", "parent", "last_desc", "w_logprob", "w_entropy",
                 "valid", "seq_batch_ids", "seq_end_pos", "seq_lens")
META_FIELDS = ("kv_ids", "kv_counts", "kv_types", "q_ids", "q_counts", "q_types")


def _npz_seqs(path):
    z = np.load(path)
    keys = sorted(z.files, key=lambda s: int(s.split("_")[1]))
    return [z[k] for k in keys]


def _assert_packed_equal(p, j):
    assert p.n_tokens == j.n_tokens and p.n_padded == j.n_padded
    for f in PACKED_FIELDS:
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(p.seq_paths_matrix(), j.seq_paths_matrix())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("leafization", [True, False])
def test_token_trie_and_orders_match(seed, leafization):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=14, vocab=5, max_len=20)
    p, j = pt.TokenTrie(seqs, attachs, leafization), jt.TokenTrie(seqs, attachs, leafization)
    for step in (None, "forward_permute", "backward_permute"):
        if step:
            getattr(p, step)()
            getattr(j, step)()
        assert len(p.inputs) == len(j.inputs)
        for a, b in zip(p.inputs, j.inputs):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(p.lcp_lens, j.lcp_lens)
        assert p.attach_lists == j.attach_lists
        assert (p.n_tree_tokens, p.n_dense_tokens) == (j.n_tree_tokens, j.n_dense_tokens)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("pad_to", [None, 256])
def test_flatten_trie_matches(seed, pad_to):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=16, vocab=7, max_len=24)
    p = pt.flatten_trie(pt.TokenTrie(seqs, attachs), pad_to=pad_to)
    j = jt.flatten_trie(jt.TokenTrie(seqs, attachs), pad_to=pad_to)
    _assert_packed_equal(p, j)
    for s in range(len(p.seq_lens)):
        np.testing.assert_array_equal(p.seq_path(s), j.seq_path(s))


@pytest.mark.parametrize("path", _NPZ, ids=os.path.basename)
def test_flatten_trie_matches_on_tau2_calls(path):
    seqs = _npz_seqs(path)
    p = pt.flatten_trie(pt.TokenTrie(seqs))
    j = jt.flatten_trie(jt.TokenTrie(seqs))
    _assert_packed_equal(p, j)


def _meta_pair(last_desc, bq, bkv, min_kv=0, min_q=0):
    p = pt.build_block_meta(last_desc, bq, bkv, min_kv, min_q)
    j = jt.build_block_meta(last_desc, bq, bkv, min_kv, min_q)
    assert (p.block_q, p.block_kv) == (j.block_q, j.block_kv)
    for f in META_FIELDS:
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    return p


@pytest.mark.parametrize("blocks", [(16, 16), (32, 64)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_meta_matches_random(seed, blocks):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=20, vocab=5, max_len=40)
    packed = pt.flatten_trie(pt.TokenTrie(seqs, attachs), pad_to=512)
    meta = _meta_pair(packed.last_desc, *blocks)
    _meta_pair(packed.last_desc, *blocks, min_kv=meta.kv_ids.shape[1] + 3, min_q=7)


@pytest.mark.parametrize("blocks", [(64, 64), (128, 256)])
@pytest.mark.parametrize("path", _NPZ, ids=os.path.basename)
def test_block_meta_matches_tau2_calls(path, blocks):
    packed = pt.flatten_trie(pt.TokenTrie(_npz_seqs(path)))
    n_pad = -(-packed.n_padded // 256) * 256
    ld = pt.flatten_trie(pt.TokenTrie(_npz_seqs(path)), pad_to=n_pad).last_desc
    meta = _meta_pair(ld, *blocks)
    assert set(np.unique(meta.kv_types[meta.kv_types > 0])) == {1, 2}


def test_pack_forest_matches():
    rng = np.random.default_rng(5)
    parts_p, parts_j = [], []
    for _ in range(3):
        seqs, attachs = random_trie_batch(rng, n_seqs=6, vocab=5, max_len=16)
        parts_p.append(pt.flatten_trie(pt.TokenTrie(seqs, attachs), pad_to=64))
        parts_j.append(jt.flatten_trie(jt.TokenTrie(seqs, attachs), pad_to=64))
    _assert_packed_equal(pt.pack_forest(parts_p, pad_to=256), jt.pack_forest(parts_j, pad_to=256))


@pytest.mark.parametrize("pad_multiple", [16, 128])
def test_pack_sequences_dense_matches(pad_multiple):
    rng = np.random.default_rng(7)
    seqs, attachs = random_trie_batch(rng, n_seqs=12, vocab=5, max_len=30)
    _assert_packed_equal(pack_sequences_dense(seqs, attachs, pad_multiple),
                         jax_pack_dense(seqs, attachs, pad_multiple))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_rollout_batch_matches(seed):
    kw = dict(seed=seed, n_prompts=2, samples_per_prompt=5, prompt_len=(20, 40),
              completion_len=(5, 30), branch_prob=0.8, vocab_size=1000)
    seqs_p, att_p = synthetic_rollout_batch(**kw)
    seqs_j, att_j = jax_synth.synthetic_rollout_batch(**kw)
    assert att_p == att_j
    for a, b in zip(seqs_p, seqs_j, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert sharing_ratio(seqs_p) == jax_synth.sharing_ratio(seqs_j)
    again, _ = synthetic_rollout_batch(**kw)
    for a, b in zip(seqs_p, again, strict=True):
        np.testing.assert_array_equal(a, b)
