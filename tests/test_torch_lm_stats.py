"""The port's LM-head statistics (plain K8 version, both loss modes, per-edge
log-probs) against the JAX package's vocab-chunked path.

fp32 on the CPU, inputs from seeded numpy, a ragged vocabulary (not a
multiple of the chunk) and temperature != 1. Tolerance 2e-5 absolute: the
same fp32 online fold in another summation order, values of magnitude <= ~10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.ops import losses as jax_losses
from dynamictreeattn_tpu_torch.ops import losses
from dynamictreeattn_tpu_torch.ops.lm_stats import lm_stats, lm_stats_plain
from dynamictreeattn_tpu_torch.tries import TokenTrie, flatten_trie

from helpers import random_trie_batch

ATOL = 2e-5


def _inputs(seed, n=96, d=32, V=100):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((n, d)).astype(np.float32)
    w_lm = (rng.standard_normal((d, V)) * d**-0.5 * 3).astype(np.float32)
    return hidden, w_lm


def _jax_stats(hidden, w_lm, temperature, vocab_chunk_width=None):
    lse, ent = jax_losses.position_stats_from_hidden(
        jnp.asarray(hidden), jnp.asarray(w_lm), temperature, mode="vocab",
        vocab_chunk_width=vocab_chunk_width)
    return np.asarray(lse), np.asarray(ent)


@pytest.mark.parametrize("chunks", [(32, 16), (100, 96), (7, 40)])
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_plain_k8_matches_jax_vocab(temperature, chunks):
    vocab_chunk, row_chunk = chunks
    hidden, w_lm = _inputs(0)
    lse, mean_x = lm_stats_plain(torch.from_numpy(hidden), torch.from_numpy(w_lm),
                                 1.0 / temperature, vocab_chunk=vocab_chunk, row_chunk=row_chunk)
    want_lse, want_ent = _jax_stats(hidden, w_lm, temperature)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=0)
    np.testing.assert_allclose((lse - mean_x).numpy(), want_ent, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["kernel", "vocab"])
@pytest.mark.parametrize("seed", [1, 2])
def test_position_stats_modes_match_jax(seed, mode):
    hidden, w_lm = _inputs(seed, n=64, V=130)
    lse, ent = losses.position_stats_from_hidden(
        torch.from_numpy(hidden), torch.from_numpy(w_lm), 0.7, mode=mode,
        vocab_chunk_width=48)
    want_lse, want_ent = _jax_stats(hidden, w_lm, 0.7, vocab_chunk_width=48)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ent.numpy(), want_ent, atol=ATOL, rtol=0)


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    hidden, w_lm = (torch.from_numpy(a) for a in _inputs(3))
    for a, b in zip(lm_stats(hidden, w_lm, 1.3), lm_stats_plain(hidden, w_lm, 1.3)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("V,n", [(151936, 6656), (151936, 37888), (128256, 1000), (100, 96),
                                 (50000, 300000)])
def test_vocab_chunk_width_matches_jax(V, n):
    assert losses._vocab_chunk_width(V, n) == jax_losses._vocab_chunk_width(V, n)


@pytest.mark.parametrize("mode", ["kernel", "vocab"])
def test_logprob_entropy_matches_jax(mode):
    rng = np.random.default_rng(4)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=100, max_len=20)
    packed = flatten_trie(TokenTrie(seqs, attachs), pad_to=128)
    hidden, w_lm = _inputs(5, n=128, V=100)
    lp, ent = losses.logprob_entropy_from_hidden(
        torch.from_numpy(hidden), torch.from_numpy(w_lm), torch.from_numpy(packed.tokens),
        torch.from_numpy(packed.parent), 0.7, mode=mode)
    want_lp, want_ent = jax_losses.logprob_entropy_from_hidden(
        jnp.asarray(hidden), jnp.asarray(w_lm), jnp.asarray(packed.tokens),
        jnp.asarray(packed.parent), 0.7, mode="vocab")
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ent.numpy(), np.asarray(want_ent), atol=ATOL, rtol=0)
    assert (lp.numpy()[packed.parent < 0] == 0).all()


def test_unknown_loss_mode_raises():
    hidden, w_lm = (torch.from_numpy(a) for a in _inputs(0))
    with pytest.raises(ValueError, match="loss mode"):
        losses.position_stats_from_hidden(hidden, w_lm, mode="rows")
