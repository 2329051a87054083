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


def _sched_pair(meta_p, meta_j, n_slots):
    p = pt.build_bwd_cache_sched(meta_p, n_slots)
    j = jt.build_bwd_cache_sched(meta_j, n_slots)
    assert p.n_slots == j.n_slots == max(1, n_slots)
    for f in ("actions", "flush"):
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype == np.int32, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    return p


@pytest.mark.parametrize("n_slots", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bwd_cache_sched_matches_random(seed, n_slots):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=20, vocab=5, max_len=40)
    ld = pt.flatten_trie(pt.TokenTrie(seqs, attachs), pad_to=512).last_desc
    _sched_pair(pt.build_block_meta(ld, 32, 32), jt.build_block_meta(ld, 32, 32), n_slots)


@pytest.mark.parametrize("n_slots", [1, 2, 3, 8])
@pytest.mark.parametrize("path", _NPZ, ids=os.path.basename)
def test_bwd_cache_sched_matches_tau2_calls(path, n_slots):
    packed = pt.flatten_trie(pt.TokenTrie(_npz_seqs(path)))
    n_pad = -(-packed.n_padded // 128) * 128
    ld = pt.flatten_trie(pt.TokenTrie(_npz_seqs(path)), pad_to=n_pad).last_desc
    sched = _sched_pair(pt.build_block_meta(ld, 128, 128), jt.build_block_meta(ld, 128, 128), n_slots)
    if n_slots == 1:
        assert (sched.actions[..., 3] >= 0).any()


@pytest.mark.parametrize("n_slots", [1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bwd_cache_sched_oracle(seed, n_slots):
    """The port's schedule replayed as the cached kernel would — per-block
    scalar accumulators through slots, evictions, reloads and the flush —
    reproduces direct per-visit accumulation exactly, for any slot count
    (R = 1 evicts on every block change). The JAX suite's oracle
    (tests/test_tree_attention.py) on the port's schedule."""
    rng = np.random.default_rng(seed)
    block, n = 32, 256
    while True:  # a random trie that fits n, as tests/helpers.py random_packed
        seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=31, max_len=40)
        trie = pt.TokenTrie(seqs, attachs)
        if trie.n_tree_tokens <= n:
            break
    packed = pt.flatten_trie(trie, pad_to=n)
    meta = pt.build_block_meta(packed.last_desc, block, block, n // block, n // block)
    nk = n // block
    sched = pt.build_bwd_cache_sched(meta, n_slots)
    R = sched.n_slots
    assert R == max(1, n_slots)

    hbm = np.full(nk, np.nan)  # uninitialized output, like device memory
    cache = np.full(R, np.nan)
    cache_block = np.full(R, -1)
    want = np.zeros(nk)
    for i in range(meta.kv_ids.shape[0]):
        for s in range(meta.kv_ids.shape[1]):
            if meta.kv_types[i, s] <= 0:
                assert tuple(sched.actions[i, s]) == (0, 0, 0, -1)  # padding slots: no action
                continue
            b = int(meta.kv_ids[i, s])
            contrib = rng.standard_normal()
            want[b] += contrib
            slot, fresh, load, evict_id = (int(x) for x in sched.actions[i, s])
            assert 0 <= slot < R
            if evict_id >= 0:
                assert cache_block[slot] == evict_id, "evicting wrong block"
                hbm[evict_id] = cache[slot]
                cache_block[slot] = -1
            if fresh:
                cache[slot] = contrib
            elif load:
                cache[slot] = hbm[b] + contrib
            else:
                assert cache_block[slot] == b, "revisit without load/fresh on another block's slot"
                cache[slot] += contrib
            cache_block[slot] = b
    for r in np.nonzero(sched.flush[:, 1] == 1)[0]:
        assert cache_block[r] == sched.flush[r, 0]
        hbm[sched.flush[r, 0]] = cache[r]
    assert not np.isnan(hbm).any(), "some kv block never written"
    np.testing.assert_allclose(hbm, want, rtol=1e-12)
