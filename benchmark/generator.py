"""The benchmark's one traffic generator, driven by a mix's data file.

Rollout batches follow the port's ``data/synthetic.py`` generator (copied,
not imported): G samples per prompt share the prompt; with ``branch_prob``
a new sample branches off a uniformly random position of an earlier
sample's completion (tool-call retries, tree-search forks), else it extends
the bare prompt. Two generators split what the copy draws from one: the
shapes (lengths, branch points) come from the mix's fixed ``shape_seed``,
so every run does the same work, and the token ids and the order in which
a run takes the batches come from the run's ``--seed``.
"""

from __future__ import annotations

import numpy as np

MAX_SEED = 2**64


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for (`seed`, `stream`): any whole
    seed, negative or beyond 64 bits included."""
    return np.random.default_rng([int(seed) % MAX_SEED, stream])


def rollout_batch(shapes: np.random.Generator, tokens: np.random.Generator, n_prompts: int,
                  samples_per_prompt: int, prompt_len, completion_len, branch_prob: float, vocab_size: int,
                  w_logprobs: float, w_entropy: float):
    """(seqs, attachs): List[np.ndarray int32], List[dict], as the port's
    ``synthetic_rollout_batch``."""
    seqs, attachs = [], []
    for p in range(n_prompts):
        plen = int(shapes.integers(prompt_len[0], prompt_len[1] + 1))
        prompt = tokens.integers(0, vocab_size, size=plen).astype(np.int32)
        group: list[np.ndarray] = []
        for g in range(samples_per_prompt):
            if group and shapes.random() < branch_prob:
                base = group[shapes.integers(len(group))]
                stem = base[:int(shapes.integers(plen, len(base) + 1))]
            else:
                stem = prompt
            clen = int(shapes.integers(completion_len[0], completion_len[1] + 1))
            seq = np.concatenate([stem, tokens.integers(0, vocab_size, size=clen).astype(np.int32)])
            group.append(seq)
            seqs.append(seq)
            attachs.append({"w_logprobs": w_logprobs, "w_entropy": w_entropy,
                            "prompt_id": p, "sample_id": g, "prompt_len": plen})
    return seqs, attachs


def train_pool(mix: dict, vocab_size: int, seed: int) -> list:
    """The run's training batches, in the order the run takes them: the
    mix's ``pool`` batches, their shapes from ``shape_seed``, their tokens
    and order from `seed`."""
    shapes, tokens = rng(mix["shape_seed"], 0), rng(seed, 1)
    pool = [rollout_batch(shapes, tokens, mix["prompts_per_step"], mix["samples_per_prompt"], mix["prompt_len"],
                          mix["completion_len"], mix["branch_prob"], vocab_size, mix["w_logprobs"],
                          mix["w_entropy"]) for _ in range(mix["pool"])]
    return [pool[i] for i in rng(seed, 2).permutation(len(pool))]


def prompt_pool(mix: dict, vocab_size: int, seed: int) -> list:
    """The run's rollouts' prompts, in the order the run takes them:
    ``pool`` sets of ``prompts`` prompts (right-padded [P, Lp] int32,
    lengths [P]). Every set has the same lengths, drawn once from
    ``shape_seed``, one from each P-th of ``prompt_len``, so every rollout does the same work and meets the same
    cache shapes; their order within a set and the tokens come from
    `seed`."""
    shapes, tokens = rng(mix["shape_seed"], 0), rng(seed, 1)
    lo, hi = mix["prompt_len"]
    P = mix["prompts"]  # one length from each P-th of the range
    lens = (lo + (np.arange(P) + shapes.random(P)) * (hi - lo + 1) / P).astype(np.int32)
    pool = []
    for _ in range(mix["pool"]):
        order = tokens.permutation(lens)
        prompts = np.zeros((len(order), int(lens.max())), np.int32)
        for i, n in enumerate(order):
            prompts[i, :n] = tokens.integers(0, vocab_size, size=int(n))
        pool.append((prompts, order))
    return pool
