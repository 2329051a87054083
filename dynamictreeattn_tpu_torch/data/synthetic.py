"""Synthetic RL-rollout trie generation (host numpy).

Counterpart of ``dynamictreeattn_tpu/data/synthetic.py``: the same seed gives
the same sequences. G samples per prompt share the prompt prefix; completions
branch off earlier samples' completions at random depths (tool-call retries,
beam forks).
"""

from __future__ import annotations

import numpy as np

from dynamictreeattn_tpu_torch.tries import TokenTrie

__all__ = ["synthetic_rollout_batch", "sharing_ratio"]


def synthetic_rollout_batch(
    seed: int = 0,
    n_prompts: int = 4,
    samples_per_prompt: int = 8,
    prompt_len: tuple[int, int] = (512, 1024),
    completion_len: tuple[int, int] = (256, 1024),
    branch_prob: float = 0.7,
    vocab_size: int = 151936,
    w_logprobs: float = -1.0,
    w_entropy: float = 0.1,
):
    """Returns (seqs, attachs): List[np.ndarray int32], List[dict].

    * every sample of a prompt shares the prompt tokens;
    * with `branch_prob`, a new sample branches off a uniformly random
      position of a previously sampled completion of the same prompt,
      else it extends the bare prompt.
    """
    rng = np.random.default_rng(seed)
    seqs: list[np.ndarray] = []
    attachs: list[dict] = []
    for p in range(n_prompts):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
        group: list[np.ndarray] = []
        for g in range(samples_per_prompt):
            if group and rng.random() < branch_prob:
                base = group[rng.integers(len(group))]
                cut = int(rng.integers(plen, len(base) + 1))
                stem = base[:cut]
            else:
                stem = prompt
            clen = int(rng.integers(completion_len[0], completion_len[1] + 1))
            completion = rng.integers(0, vocab_size, size=clen).astype(np.int32)
            seq = np.concatenate([stem, completion])
            group.append(seq)
            seqs.append(seq)
            attachs.append(
                {"w_logprobs": w_logprobs, "w_entropy": w_entropy,
                 "prompt_id": p, "sample_id": g, "prompt_len": plen}
            )
    return seqs, attachs


def sharing_ratio(seqs) -> float:
    """1 − (trie tokens / dense tokens): the fraction of dense work the tree
    engine avoids."""
    trie = TokenTrie(list(seqs), [{} for _ in seqs])
    dense = sum(len(s) for s in seqs)
    return 1.0 - trie.n_tree_tokens / dense
