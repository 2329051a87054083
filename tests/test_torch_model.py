"""The port's Qwen3 forward against the JAX package's, on the same weights.

JAX parameters go through ``jax.tree.map(np.asarray, ...)`` and
``params_from_numpy``; both models run the dense reference attention at fp32
on the CPU. Tolerance on final hidden states: 1e-4 absolute + 1e-4 relative
(two fp32 layers; RMS-normed outputs of magnitude ~1, matmuls summed in
another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.models import qwen3 as jq
from dynamictreeattn_tpu.ops.tree_attention_ref import tree_attention_reference as jax_ref
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, forward_hidden, init_params, params_from_numpy
from dynamictreeattn_tpu_torch.models import qwen3 as pq
from dynamictreeattn_tpu_torch.ops.tree_attention_ref import tree_attention_reference
from dynamictreeattn_tpu_torch.tries import TokenTrie, flatten_trie

from helpers import random_trie_batch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(config, seed=0, n_pad=96):
    rng = np.random.default_rng(seed)
    seqs, attachs = random_trie_batch(rng, n_seqs=8, vocab=config.vocab_size, max_len=30)
    return flatten_trie(TokenTrie(seqs, attachs), pad_to=n_pad)


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_configs_match_jax(name):
    mine, theirs = MODEL_CONFIGS[name], jq.MODEL_CONFIGS[name]
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert mine.rope_scaling_tuple == theirs.rope_scaling_tuple


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_numpy_roundtrip(dtype):
    config = MODEL_CONFIGS["qwen3-tiny"]
    jp = jq.init_params(jq.MODEL_CONFIGS["qwen3-tiny"], jax.random.key(1), dtype=dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    want_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, a in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == want_dtype and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(a, np.float32))
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    cast = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu", dtype=torch.float32)
    assert cast["embed"].dtype == torch.float32
    assert pq.lm_head_weight(tp, config).shape == (config.hidden_size, config.vocab_size)


@pytest.mark.parametrize("source", ["init_params", "params_from_numpy"])
def test_untied_head_is_stored_transposed(source):
    """An untied head keeps the [d, V] shape and values, on [V, d] storage,
    so the LM-stats kernel's wT = w_lm.t() needs no copy."""
    config = dataclasses.replace(MODEL_CONFIGS["qwen3-tiny"], tie_word_embeddings=False)
    if source == "init_params":
        tp = init_params(config, torch.Generator().manual_seed(0), torch.float32)
    else:
        theirs = dataclasses.replace(jq.MODEL_CONFIGS["qwen3-tiny"], tie_word_embeddings=False)
        jp = jq.init_params(theirs, jax.random.key(3), dtype=jnp.bfloat16)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        np.testing.assert_array_equal(tp["lm_head"].float().numpy(),
                                      np.asarray(jp["lm_head"], np.float32))
    w = pq.lm_head_weight(tp, config)
    assert w.shape == (config.hidden_size, config.vocab_size)
    assert w.t().is_contiguous() and not w.is_contiguous()


@pytest.mark.parametrize("variant", [{}, {"tie_word_embeddings": False, "attention_bias": True}])
def test_init_params_shapes_match_jax(variant):
    mine = dataclasses.replace(MODEL_CONFIGS["qwen3-tiny"], **variant)
    theirs = dataclasses.replace(jq.MODEL_CONFIGS["qwen3-tiny"], **variant)
    tp = init_params(mine, torch.Generator().manual_seed(0), torch.float32)
    jp = jax.eval_shape(lambda: jq.init_params(theirs, jax.random.key(0), dtype=jnp.float32))
    shapes_t = jax.tree.map(lambda t: tuple(t.shape), tp)
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert shapes_t == shapes_j
    again = init_params(mine, torch.Generator().manual_seed(0), torch.float32)
    torch.testing.assert_close(tp["embed"], again["embed"], rtol=0, atol=0)


@pytest.mark.parametrize("scaling", [None, "llama3", "yarn"])
def test_rope_tables_match_jax(scaling):
    name = {None: "qwen3-tiny", "llama3": "llama-tiny", "yarn": "qwen3-tiny-yarn"}[scaling]
    c = MODEL_CONFIGS[name]
    pos = np.arange(0, 300, 3, dtype=np.int32)
    cos, sin = pq.rope_tables(torch.from_numpy(pos), c.head_dim, c.rope_theta, c.rope_scaling_tuple)
    jcos, jsin = jq.rope_tables(jnp.asarray(pos), c.head_dim, c.rope_theta, c.rope_scaling_tuple)
    # fp32 angles up to 300 rad: a 1-ulp difference in inv_freq moves them ~3e-5
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=5e-5, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=5e-5, rtol=0)


@pytest.mark.parametrize("name", ["qwen3-tiny", "qwen3-tiny-yarn", "llama-tiny"])
def test_forward_hidden_matches_jax(name):
    config = MODEL_CONFIGS[name]
    jp = jq.init_params(jq.MODEL_CONFIGS[name], jax.random.key(2), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    packed = _tree(config)
    ld_j = jnp.asarray(packed.last_desc)
    want = jq.forward_hidden(jp, jq.MODEL_CONFIGS[name], jnp.asarray(packed.tokens),
                             jnp.asarray(packed.depth), lambda q, k, v: jax_ref(q, k, v, ld_j))
    ld_t = torch.from_numpy(packed.last_desc)
    got = forward_hidden(tp, config, torch.from_numpy(packed.tokens), torch.from_numpy(packed.depth),
                         lambda q, k, v: tree_attention_reference(q, k, v, ld_t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_rms_norm_and_rope_keep_dtype():
    x = torch.randn(5, 3, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    w = torch.ones(16, dtype=torch.bfloat16)
    assert pq.rms_norm(x, w, 1e-6).dtype == torch.bfloat16
    cos, sin = pq.rope_tables(torch.arange(5), 16, 1e4)
    assert pq.apply_rope(x, cos, sin).dtype == torch.bfloat16
    # position 0 is the identity rotation
    torch.testing.assert_close(pq.apply_rope(x, cos, sin)[0], x[0], rtol=0, atol=0)
