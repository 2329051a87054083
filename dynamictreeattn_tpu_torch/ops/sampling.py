"""Logit filtering and categorical sampling: top-k / top-p (nucleus) / min-p.

Counterpart of ``dynamictreeattn_tpu/ops/sampling.py``. Semantics match
HuggingFace's logits processors (TopKLogitsWarper / TopPLogitsWarper /
MinPLogitsWarper); the tests hold the keep sets against both.

Disallowed logits become a large negative number (-1e30, not -inf): the
filters always keep at least one token, and a finite fill keeps the
arithmetic of a fully masked row free of NaN. No filter sorts the vocabulary:
min-p is one compare (prob < min_p·p_max ⇔ logit < logit_max + log(min_p));
top-k and top-p find their cutoff by bisecting on the threshold, 40 fp32
iterations of one compare-and-sum pass over [..., V] each, as in the JAX
package.

Tie semantics: the threshold keeps every token tied with the cutoff value,
where HF's sort-based warpers break ties by sort order.

``categorical`` draws one token per row by the Gumbel-max trick, as
``jax.random.categorical`` does, from an explicit ``torch.Generator``: the
same seed gives the same tokens, but not JAX's tokens.
"""

from __future__ import annotations

import math

import torch

__all__ = ["categorical", "filter_logits"]

_NEG = -1e30
_BISECT_ITERS = 40  # halves a fp32 exponent range well past ulp precision


def _bisect_threshold(count_ge, lo: torch.Tensor, hi: torch.Tensor, want) -> torch.Tensor:
    """Largest t with count_ge(t) >= want, by bisection on [lo, hi].

    `count_ge(t)` must be non-increasing in t ([...] -> [...]); lo must
    satisfy the predicate. Returns [..., 1]."""
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = count_ge(mid) >= want
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo[..., None]


def _top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    # cutoff = k-th largest logit: bisect t so that #{logit >= t} >= k
    thr = _bisect_threshold(
        lambda t: torch.sum(logits >= t[..., None], dim=-1),
        torch.amin(logits, dim=-1), torch.amax(logits, dim=-1), k,
    )
    return logits.masked_fill(logits < thr, _NEG)


def _top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    # the largest t whose kept-set mass reaches p: the smallest set with
    # cumulative probability >= p, always holding the top token
    probs = torch.softmax(logits, dim=-1)
    thr = _bisect_threshold(
        lambda t: torch.sum(torch.where(probs >= t[..., None], probs, 0.0), dim=-1),
        torch.zeros(logits.shape[:-1], dtype=logits.dtype, device=logits.device),
        torch.amax(probs, dim=-1), p,
    )
    return logits.masked_fill(probs < thr, _NEG)


def _min_p(logits: torch.Tensor, mp: float) -> torch.Tensor:
    thr = torch.amax(logits, dim=-1, keepdim=True) + math.log(mp)
    return logits.masked_fill(logits < thr, _NEG)


def filter_logits(logits: torch.Tensor, top_k: int = 0, top_p: float | None = None,
                  min_p: float | None = None) -> torch.Tensor:
    """Top-k → top-p → min-p filtering (HF processor order) of fp32 `logits`
    [..., V]; 0 / None turns a filter off. Temperature scaling is the
    caller's job (apply it before filtering, as HF does)."""
    if top_k:
        logits = _top_k(logits, int(top_k))
    if top_p is not None:
        logits = _top_p(logits, float(top_p))
    if min_p is not None:
        logits = _min_p(logits, float(min_p))
    return logits


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """int64 [...]: one draw from softmax(logits) per row of `logits`
    [..., V], argmax(logits + Gumbel noise) with uniforms from `generator`
    (which must live on the logits' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)
