"""Per-trie cost features, the inputs of the execution-time model.

Counterpart of ``dynamictreeattn_tpu/tries/stats.py``, computed the same way
(its backward-mode ``sum_prefix_len`` and ``n_f1_tokens`` included, which
differ from the upstream prototype's formulas: the JAX package's values are
the ones kept). Per ordered trie (after a permute):

* ``n_leaf_sequences`` — number of leaves;
* ``n_tree_tokens``    — Σ lens − Σ lcp_lens, the packed tokens forwarded once;
* ``sum_prefix_len``   — Σ lcp_i, the prefix KV re-read proxy;
* ``sum_depth``        — Σ_j depth(j) over packed tokens, the attention
  work proxy;
* ``n_f1_tokens``      — 0 in mode "forward"; in mode "backward" the tokens of
  each pushed suffix past its first block;
* ``n_padded_tokens``  — the packed length rounded up to the block size.
"""

from __future__ import annotations

import numpy as np

__all__ = ["trie_stats"]


def _tri(x: np.ndarray) -> np.ndarray:
    return x * (x - 1) // 2


def trie_stats(lens, lcp_lens, mode: str = "forward", block_size: int = 2048) -> dict:
    lens = np.asarray(lens, dtype=np.int64)
    lcp = np.asarray(lcp_lens, dtype=np.int64)
    if len(lcp) != len(lens) - 1:
        raise ValueError("lcp_lens must have len(lens)-1 entries")
    starts = np.concatenate([[0], lcp])  # first new-token depth per leaf

    n_tree_tokens = int(lens.sum() - lcp.sum())
    n_f1_tokens = int(np.maximum(lens - starts - block_size, 0).sum()) if mode == "backward" else 0
    n_padded = -(-n_tree_tokens // block_size) * block_size if block_size else n_tree_tokens
    return {
        "n_leaf_sequences": int(len(lens)),
        "n_tree_tokens": n_tree_tokens,
        "n_f1_tokens": n_f1_tokens,
        "sum_prefix_len": int(starts.sum()),
        "sum_depth": int((_tri(lens) - _tri(starts)).sum()),
        "n_padded_tokens": int(n_padded),
    }
