"""Rollout batching helpers: accumulate sequences to a token budget.

Counterpart of ``dynamictreeattn_tpu/training/batching.py`` (host numpy,
the same batches). Rollout streams deliver variable-size groups; the engine
wants batches near a target packed size. The batcher accumulates rollouts
until the TREE token count reaches the budget (prefix sharing means dense
tokens overestimate the packed size badly).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from dynamictreeattn_tpu_torch.tries import TokenTrie

__all__ = ["TokenBudgetBatcher"]


class TokenBudgetBatcher:
    """Groups (seqs, attachs) rollout items into trie-token-budget batches.

    Emits a batch when adding the next group would exceed `budget` tree
    tokens (always emits at least one group per batch). Groups are kept whole
    — splitting a GRPO group across batches would break its prefix sharing.
    """

    def __init__(self, budget: int):
        self.budget = int(budget)

    def __call__(self, stream: Iterable) -> Iterator[tuple[list, list]]:
        cur_seqs: list = []
        cur_attachs: list = []
        for seqs, attachs in stream:
            if cur_seqs and self._tree_tokens(cur_seqs + list(seqs)) > self.budget:
                yield cur_seqs, cur_attachs
                cur_seqs, cur_attachs = [], []
            cur_seqs.extend(np.asarray(s, np.int32) for s in seqs)
            cur_attachs.extend(attachs)
        if cur_seqs:
            yield cur_seqs, cur_attachs

    @staticmethod
    def _tree_tokens(seqs) -> int:
        return TokenTrie(list(seqs), [{} for _ in seqs]).n_tree_tokens
