"""Per-position LM statistics and per-edge log-probs over the packed trie.

Counterpart of the forward of ``dynamictreeattn_tpu/ops/losses.py``:

* statistics (logsumexp, entropy) come from the LM head without the [n, V]
  logits matrix: mode "kernel" runs ``ops.lm_stats.lm_stats`` (the K8 CUDA
  kernel on a CUDA tensor, its plain version on a CPU tensor); mode "vocab"
  runs the plain vocab-chunked fold (the JAX package's ``_vc_forward``);
* per-edge label log-probs need only the label *column* of the LM head:
  ``lp[j] = <h[parent[j]], W[:, token[j]]>/T − lse[parent[j]]``.

Entropy = lse − E_softmax[x]. Temperature divides logits before everything.
The backward (custom autograd) and the "rows" mode come with the training
slice.
"""

from __future__ import annotations

import torch

from dynamictreeattn_tpu_torch.ops.lm_stats import lm_stats, lm_stats_plain

__all__ = ["logprob_entropy_from_hidden", "position_stats_from_hidden"]


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


def position_stats_from_hidden(
    hidden: torch.Tensor,  # [n, d]
    w_lm: torch.Tensor,  # [d, V]
    temperature: float = 1.0,
    mode: str = "kernel",
    vocab_chunk_width: int | None = None,
):
    """Per-position (logsumexp, entropy) in fp32, never materializing [n, V]."""
    inv_temp = 1.0 / temperature
    if mode == "kernel":
        lse, mean_x = lm_stats(hidden, w_lm, inv_temp)
    elif mode == "vocab":
        n, V = hidden.shape[0], w_lm.shape[1]
        vc = min(vocab_chunk_width or _vocab_chunk_width(V, n), V)
        lse, mean_x = lm_stats_plain(hidden, w_lm, inv_temp, vocab_chunk=vc,
                                     row_chunk=max(n, 1))
    else:
        raise ValueError(f"unknown loss mode {mode!r}")
    return lse, lse - mean_x


def logprob_entropy_from_hidden(
    hidden: torch.Tensor,  # [n, d] — model output after final norm
    w_lm: torch.Tensor,  # [d, V] — LM head (transposed embedding if tied)
    tokens: torch.Tensor,  # [n] packed trie tokens
    parent: torch.Tensor,  # [n] -1 for roots
    temperature: float = 1.0,
    mode: str = "kernel",
):
    """(lp_edge [n], entropy [n]) fp32: ``lp_edge[j]`` = log P(token[j] |
    ancestors of j); roots get 0 (no incoming edge)."""
    lse, entropy = position_stats_from_hidden(hidden, w_lm, temperature, mode=mode)
    par = torch.clamp(parent.long(), min=0)
    h_par = hidden.index_select(0, par)  # [n, d]
    w_cols = w_lm.t().index_select(0, tokens.long())  # [n, d]
    label_logit = torch.sum(h_par.float() * w_cols.float(), dim=-1) / temperature
    lp_edge = label_logit - lse.index_select(0, par)
    lp_edge = torch.where(parent >= 0, lp_edge, 0.0)
    return lp_edge, entropy
