"""Per-position LM statistics and per-edge log-probs over the packed trie.

Counterpart of the forward of ``dynamictreeattn_tpu/ops/losses.py``:

* statistics (logsumexp, entropy) come from the LM head without the [n, V]
  logits matrix, through ``_PositionStats`` (the counterpart of the JAX
  package's ``_position_stats_pallas`` / ``_position_stats_vc`` custom_vjps):
  mode "kernel" runs ``ops.lm_stats.lm_stats`` forward and ``lm_stats_bwd``
  backward (the K8 / K9 CUDA kernels on CUDA tensors, their plain versions on
  CPU tensors); mode "vocab" runs the plain vocab-chunked fold forward
  (``_vc_forward``) and the plain vocab-chunked backward (``_vc_bwd_rule``);
  mode "rows" (``position_stats_rowchunked``) forms the fp32 [C, V] logits
  of one row chunk at a time, each chunk under ``torch.utils.checkpoint``,
  and lets autograd differentiate them (the JAX package's row-chunked
  ``jax.checkpoint`` + ``lax.map`` reference path);
* per-edge label log-probs need only the label *column* of the LM head:
  ``lp[j] = <h[parent[j]], W[:, token[j]]>/T − lse[parent[j]]`` (plain
  PyTorch under autograd, as in JAX).

Entropy = lse − E_softmax[x]. Temperature divides logits before everything.
The trie training loss is ``Σ_j w_logprob[j]·lp[j] + Σ_p w_entropy[p]·H[p]``
(``tree_loss_from_hidden``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from dynamictreeattn_tpu_torch.ops.lm_stats import (
    lm_stats, lm_stats_bwd, lm_stats_bwd_plain, lm_stats_plain,
)

__all__ = ["logprob_entropy_from_hidden", "position_stats_from_hidden", "position_stats_rowchunked",
           "tree_loss_from_hidden"]


def _chunk_stats(h_chunk: torch.Tensor, w_lm: torch.Tensor, inv_temp: float):
    """(lse, entropy) fp32 of softmax(h @ W * inv_temp) for one row chunk:
    the [C, V] logits in fp32, as the JAX ``preferred_element_type``."""
    logits = torch.matmul(h_chunk.float(), w_lm.float()) * inv_temp
    m = torch.amax(logits, dim=-1, keepdim=True)
    ex = torch.exp(logits - m)
    se = torch.sum(ex, dim=-1, keepdim=True)
    lse = (m + torch.log(se))[..., 0]
    mean_x = torch.sum(ex * logits, dim=-1) / se[..., 0]
    return lse, lse - mean_x


def _best_chunk(n: int, preferred: int) -> int:
    """The largest chunk size <= `preferred` that divides n."""
    for c in range(min(preferred, n), 0, -1):
        if n % c == 0:
            return c
    return n


def position_stats_rowchunked(hidden: torch.Tensor, w_lm: torch.Tensor, temperature: float = 1.0,
                              chunk_size: int = 1024):
    """Row-chunked (lse, entropy): the logits are formed chunk by chunk, each
    chunk checkpointed, so [n, V] never exists at once (the backward
    recomputes one chunk's logits at a time). A chunk size that does not
    divide n is replaced by the largest one that does (``_best_chunk``)."""
    n = hidden.shape[0]
    if n % chunk_size:
        chunk_size = _best_chunk(n, chunk_size)
    inv_temp = 1.0 / temperature
    stats = [checkpoint(_chunk_stats, h, w_lm, inv_temp, use_reentrant=False) if torch.is_grad_enabled()
             else _chunk_stats(h, w_lm, inv_temp) for h in hidden.split(chunk_size)]
    return torch.cat([s[0] for s in stats]), torch.cat([s[1] for s in stats])


def _vocab_chunk_width(V: int, n_rows: int) -> int:
    """Chunk width Vc: the [n_rows, Vc] fp32 logits transient stays under
    ~512 MB, a multiple of 128 in [512, 16384]; exact divisors of V are
    preferred (same rule as the JAX package)."""
    budget = 512 * 1024 * 1024
    w = budget // max(n_rows * 4, 1)
    w = max(512, min(16384, (w // 128) * 128))
    if V <= w:
        return V
    for c in range(1, V // 512 + 1):
        if V % c == 0 and V // c <= w:
            return V // c
    return w


class _PositionStats(torch.autograd.Function):
    """(lse, entropy) fp32 [n] of softmax(hidden @ w_lm * inv_temp), with the
    analytic backward from the saved (hidden, w_lm, lse, mean_x). `vc` is the
    vocab chunk width of mode "vocab" (unused by mode "kernel")."""

    @staticmethod
    def forward(ctx, hidden, w_lm, inv_temp, mode, vc):
        if mode == "kernel":
            lse, mean_x = lm_stats(hidden, w_lm, inv_temp)
        else:
            lse, mean_x = lm_stats_plain(hidden, w_lm, inv_temp, vocab_chunk=vc,
                                         row_chunk=max(hidden.shape[0], 1))
        ctx.save_for_backward(hidden, w_lm, lse, mean_x)
        ctx.inv_temp, ctx.mode, ctx.vc = inv_temp, mode, vc
        return lse, lse - mean_x

    @staticmethod
    def backward(ctx, g_lse, g_ent):
        hidden, w_lm, lse, mean_x = ctx.saved_tensors
        if ctx.mode == "kernel":
            dh, dwT = lm_stats_bwd(hidden, w_lm, lse, mean_x, g_lse, g_ent, ctx.inv_temp)
        else:
            dh, dwT = lm_stats_bwd_plain(hidden, w_lm, lse, mean_x, g_lse, g_ent,
                                         ctx.inv_temp, vocab_chunk=ctx.vc)
        # the [d, V] cotangent is a view of the [V, d] dWT: for a tied head
        # it lands on the embedding contiguous
        return dh, dwT.t(), None, None, None


def position_stats_from_hidden(
    hidden: torch.Tensor,  # [n, d]
    w_lm: torch.Tensor,  # [d, V]
    temperature: float = 1.0,
    mode: str = "kernel",
    vocab_chunk_width: int | None = None,
    chunk_size: int = 1024,  # row-chunk size, mode "rows" only
):
    """Per-position (logsumexp, entropy) in fp32, never materializing [n, V];
    differentiable in hidden and w_lm."""
    if mode == "rows":
        return position_stats_rowchunked(hidden, w_lm, temperature, chunk_size)
    if mode not in ("kernel", "vocab"):
        raise ValueError(f"unknown loss mode {mode!r}")
    n, V = hidden.shape[0], w_lm.shape[1]
    vc = min(vocab_chunk_width or _vocab_chunk_width(V, n), V)
    return _PositionStats.apply(hidden, w_lm, 1.0 / temperature, mode, vc)


def logprob_entropy_from_hidden(
    hidden: torch.Tensor,  # [n, d] — model output after final norm
    w_lm: torch.Tensor,  # [d, V] — LM head (transposed embedding if tied)
    tokens: torch.Tensor,  # [n] packed trie tokens
    parent: torch.Tensor,  # [n] -1 for roots
    temperature: float = 1.0,
    mode: str = "kernel",
    chunk_size: int = 1024,  # row-chunk size, mode "rows" only
):
    """(lp_edge [n], entropy [n]) fp32: ``lp_edge[j]`` = log P(token[j] |
    ancestors of j); roots get 0 (no incoming edge)."""
    lse, entropy = position_stats_from_hidden(hidden, w_lm, temperature, mode=mode, chunk_size=chunk_size)
    par = torch.clamp(parent.long(), min=0)
    # advanced indexing, not index_select: on the card its backward sums
    # repeated rows (a parent's children) in a fixed order, where
    # index_select's backward adds them with atomics in no fixed order
    h_par = hidden[par]  # [n, d]
    w_cols = w_lm.t()[tokens.long()]  # [n, d]
    label_logit = torch.sum(h_par.float() * w_cols.float(), dim=-1) / temperature
    lp_edge = label_logit - lse[par]
    lp_edge = torch.where(parent >= 0, lp_edge, 0.0)
    return lp_edge, entropy


def tree_loss_from_hidden(
    hidden: torch.Tensor,
    w_lm: torch.Tensor,
    tokens: torch.Tensor,
    parent: torch.Tensor,
    w_logprob: torch.Tensor,  # [n] f32 per-edge weights (tries/flatten.py)
    w_entropy: torch.Tensor,  # [n] f32 per-position weights
    temperature: float = 1.0,
    mode: str = "kernel",
    chunk_size: int = 1024,  # row-chunk size, mode "rows" only
):
    """Scalar trie loss + aux stats. Gradients flow into hidden and w_lm."""
    lp_edge, entropy = logprob_entropy_from_hidden(hidden, w_lm, tokens, parent, temperature,
                                                   mode=mode, chunk_size=chunk_size)
    sum_lp = torch.sum(w_logprob * lp_edge)
    sum_ent = torch.sum(w_entropy * entropy)
    aux = {"lp_edge": lp_edge, "entropy": entropy, "sum_logprob": sum_lp, "sum_entropy": sum_ent}
    return sum_lp + sum_ent, aux
