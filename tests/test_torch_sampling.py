"""The port's logit filters and categorical sampling (ops/sampling.py)
against the JAX package's ``filter_logits`` and HuggingFace's TopK / TopP /
MinP logits warpers.

Keep sets must be equal; masked positions differ only in the fill value
(-1e30 here and in JAX, -inf in HF), which sampling cannot tell apart.
Random fp32 logits from seeded numpy, as in tests/test_sampling.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers as tfm
from scipy import stats

from dynamictreeattn_tpu.ops.sampling import filter_logits as jax_filter_logits
from dynamictreeattn_tpu_torch.ops.sampling import categorical, filter_logits


def _logits(seed, shape=(4, 257), scale=3.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _kept(x) -> np.ndarray:
    return np.asarray(x) > -1e29


def _check_keep_sets(lg, port_kwargs, hf_warper):
    ours = filter_logits(torch.from_numpy(lg), **port_kwargs)
    theirs = jax_filter_logits(jnp.asarray(lg), **port_kwargs)
    hf = hf_warper(None, torch.from_numpy(lg))
    np.testing.assert_array_equal(_kept(ours), _kept(theirs))
    np.testing.assert_array_equal(_kept(ours), _kept(hf.numpy()))
    # kept logits pass through unchanged
    np.testing.assert_array_equal(ours.numpy()[_kept(ours)], lg[_kept(ours)])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 5, 50])
def test_top_k_keep_set_matches_jax_and_hf(seed, k):
    _check_keep_sets(_logits(seed), {"top_k": k},
                     tfm.TopKLogitsWarper(top_k=k, filter_value=-float("inf")))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.99])
def test_top_p_keep_set_matches_jax_and_hf(seed, p):
    _check_keep_sets(_logits(seed), {"top_p": p},
                     tfm.TopPLogitsWarper(top_p=p, filter_value=-float("inf"), min_tokens_to_keep=1))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mp", [0.02, 0.1, 0.5])
def test_min_p_keep_set_matches_jax_and_hf(seed, mp):
    _check_keep_sets(_logits(seed), {"min_p": mp},
                     tfm.MinPLogitsWarper(min_p=mp, filter_value=-float("inf")))


def test_chained_filters_keep_a_token_and_sampling_draws_only_kept():
    """k → p → min_p keeps >= 1 token per row, the same set as JAX's chain,
    and categorical sampling never draws a filtered token."""
    lg = _logits(3, (8, 101), 5.0)
    out = filter_logits(torch.from_numpy(lg), top_k=20, top_p=0.8, min_p=0.05)
    kept = _kept(out)
    assert kept.sum(axis=-1).min() >= 1
    np.testing.assert_array_equal(
        kept, _kept(jax_filter_logits(jnp.asarray(lg), top_k=20, top_p=0.8, min_p=0.05)))
    gen = torch.Generator().manual_seed(0)
    toks = categorical(out.expand(512, *out.shape), gen).numpy()  # [512, 8]
    for r in range(lg.shape[0]):
        assert kept[r, np.unique(toks[:, r])].all()


def test_categorical_frequencies_follow_softmax():
    """Chi-square goodness of fit of 20000 draws against softmax(logits) on a
    vocabulary of 8: the Gumbel-max draw is categorical sampling."""
    lg = torch.tensor([1.0, 0.5, 0.0, -0.5, -1.0, 2.0, 0.25, -2.0])
    n = 20000
    toks = categorical(lg.expand(n, -1), torch.Generator().manual_seed(1))
    observed = np.bincount(toks.numpy(), minlength=8)
    expected = torch.softmax(lg.double(), -1).numpy() * n
    _, p_value = stats.chisquare(observed, expected)
    assert p_value > 1e-3, (observed, expected)


def test_same_generator_seed_gives_same_tokens():
    lg = torch.from_numpy(_logits(4, (16, 300)))
    draw = [categorical(lg, torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(draw[0], draw[1])
    assert not torch.equal(draw[0], draw[2])
    assert draw[0].dtype == torch.int64 and draw[0].shape == (16,)
