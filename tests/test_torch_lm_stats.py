"""The port's LM-head statistics (plain K8 and K9 versions, both loss modes
forward and backward, per-edge log-probs, the trie loss) against the JAX
package's vocab-chunked path and its K9 kernel in interpret mode.

fp32 on the CPU, inputs from seeded numpy, a ragged vocabulary (not a
multiple of the chunk) and temperature != 1. Tolerance 2e-5 absolute: the
same fp32 online fold in another summation order, values of magnitude <= ~10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamictreeattn_tpu.ops import losses as jax_losses
from dynamictreeattn_tpu.ops.lm_stats import lm_stats_bwd as jax_lm_stats_bwd
from dynamictreeattn_tpu_torch.ops import losses
from dynamictreeattn_tpu_torch.ops.lm_stats import (
    lm_stats, lm_stats_bwd, lm_stats_bwd_plain, lm_stats_plain,
)
from dynamictreeattn_tpu_torch.tries import TokenTrie, flatten_trie

from helpers import random_trie_batch

ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain loops run many tiny ops: one intra-op thread each is as fast
    and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        losses.position_stats_from_hidden(hidden, w_lm, mode="columns")


# ------------------------------------------------------------------ backward


def _cotangents(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32), rng.standard_normal(n).astype(np.float32))


def test_plain_k9_matches_jax_k9_interpret():
    """The plain K9 against the JAX kernel in interpret mode, at the JAX
    suite's own shape (tests/test_lm_stats.py: n=64, d=32, V=160, one full
    and one masked 128-column block)."""
    rng = np.random.default_rng(0)
    n, d, V, it = 64, 32, 160, 1.25
    hidden = rng.standard_normal((n, d)).astype(np.float32)
    w_lm = (rng.standard_normal((d, V)) * 0.3).astype(np.float32)
    g_lse, g_ent = _cotangents(1, n)
    lse, mean_x = lm_stats_plain(torch.from_numpy(hidden), torch.from_numpy(w_lm), it)
    dh, dwT = lm_stats_bwd_plain(torch.from_numpy(hidden), torch.from_numpy(w_lm), lse, mean_x,
                                 torch.from_numpy(g_lse), torch.from_numpy(g_ent), it)
    want_dh, want_dwT = jax_lm_stats_bwd(
        jnp.asarray(hidden), jnp.asarray(w_lm), jnp.asarray(lse.numpy()), jnp.asarray(mean_x.numpy()),
        jnp.asarray(g_lse), jnp.asarray(g_ent), it, block_v=128, interpret=True)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dwT.numpy(), np.asarray(want_dwT), atol=ATOL, rtol=0)


def _jax_stats_grads(hidden, w_lm, g_lse, g_ent, temperature, vocab_chunk_width=None):
    """jax.grad of <g_lse, lse> + <g_ent, entropy> through the JAX vocab path."""
    def f(h, w):
        lse, ent = jax_losses.position_stats_from_hidden(
            h, w, temperature, mode="vocab", vocab_chunk_width=vocab_chunk_width)
        return jnp.sum(g_lse * lse) + jnp.sum(g_ent * ent)
    dh, dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(w_lm))
    return np.asarray(dh), np.asarray(dw)


@pytest.mark.parametrize("vocab_chunk", [16384, 48, 7])
def test_plain_k9_matches_jax_vocab_grad(vocab_chunk):
    hidden, w_lm = _inputs(6, n=80, V=130)
    g_lse, g_ent = _cotangents(7, 80)
    lse, mean_x = lm_stats_plain(torch.from_numpy(hidden), torch.from_numpy(w_lm), 1 / 0.7)
    dh, dwT = lm_stats_bwd_plain(torch.from_numpy(hidden), torch.from_numpy(w_lm), lse, mean_x,
                                 torch.from_numpy(g_lse), torch.from_numpy(g_ent), 1 / 0.7,
                                 vocab_chunk=vocab_chunk)
    want_dh, want_dw = _jax_stats_grads(hidden, w_lm, g_lse, g_ent, 0.7)
    np.testing.assert_allclose(dh.numpy(), want_dh, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dwT.t().numpy(), want_dw, atol=ATOL, rtol=0)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("mode", ["kernel", "vocab"])
def test_position_stats_grads_match_jax(mode, tied):
    """Autograd through ``_PositionStats`` in both modes: the head as a
    transposed [V, d] embedding (tied) or a contiguous [d, V] tensor."""
    hidden, w_lm = _inputs(8, n=64, V=130)
    g_lse, g_ent = _cotangents(9, 64)
    h = torch.from_numpy(hidden).requires_grad_()
    w = (torch.from_numpy(np.ascontiguousarray(w_lm.T)).t() if tied
         else torch.from_numpy(w_lm)).requires_grad_()
    lse, ent = losses.position_stats_from_hidden(h, w, 0.7, mode=mode, vocab_chunk_width=48)
    dh, dw = torch.autograd.grad((torch.from_numpy(g_lse) * lse).sum()
                                 + (torch.from_numpy(g_ent) * ent).sum(), (h, w))
    want_dh, want_dw = _jax_stats_grads(hidden, w_lm, g_lse, g_ent, 0.7, vocab_chunk_width=48)
    np.testing.assert_allclose(dh.numpy(), want_dh, atol=ATOL, rtol=0)
    np.testing.assert_allclose(dw.numpy(), want_dw, atol=ATOL, rtol=0)


def test_k9_wrapper_on_cpu_is_the_plain_version():
    hidden, w_lm = (torch.from_numpy(a) for a in _inputs(3))
    lse, mean_x = lm_stats_plain(hidden, w_lm, 1.3)
    g_lse, g_ent = (torch.from_numpy(a) for a in _cotangents(4, hidden.shape[0]))
    for a, b in zip(lm_stats_bwd(hidden, w_lm, lse, mean_x, g_lse, g_ent, 1.3),
                    lm_stats_bwd_plain(hidden, w_lm, lse, mean_x, g_lse, g_ent, 1.3)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["kernel", "vocab"])
def test_tree_loss_matches_jax(mode):
    """Loss, aux and grads of ``tree_loss_from_hidden`` (label-logit gather
    under autograd beside ``_PositionStats``) against the JAX package's."""
    rng = np.random.default_rng(10)
    seqs, attachs = random_trie_batch(rng, n_seqs=10, vocab=100, max_len=20)
    packed = flatten_trie(TokenTrie(seqs, attachs), pad_to=128)
    hidden, w_lm = _inputs(11, n=128, V=100)
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(w_lm).requires_grad_()
    arrays = [torch.from_numpy(a) for a in (packed.tokens, packed.parent, packed.w_logprob,
                                            packed.w_entropy)]
    loss, aux = losses.tree_loss_from_hidden(h, w, *arrays, 0.7, mode=mode)
    dh, dw = torch.autograd.grad(loss, (h, w))

    def f(hh, ww):
        return jax_losses.tree_loss_from_hidden(
            hh, ww, *(jnp.asarray(a) for a in (packed.tokens, packed.parent, packed.w_logprob,
                                               packed.w_entropy)), 0.7, mode="vocab")
    (want_loss, want_aux), (want_dh, want_dw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(hidden), jnp.asarray(w_lm))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for key in ("sum_logprob", "sum_entropy"):
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]), rtol=1e-5)
    np.testing.assert_allclose(aux["lp_edge"].detach().numpy(), np.asarray(want_aux["lp_edge"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=ATOL, rtol=0)
