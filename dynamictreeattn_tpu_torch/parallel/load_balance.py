"""Data-parallel load balancing: partition a sequence batch into K tries.

Counterpart of ``dynamictreeattn_tpu/parallel/load_balance.py`` (host numpy,
the same bins from the same inputs):

* ``LB_by_n_tokens`` — greedy first-fit-decreasing by token count;
* ``LB_by_TM`` — greedy first-fit-decreasing by predicted tree-execution
  time, re-predicting the receiving bin's subtrie after each insertion;
* ``LB_by_DFS_and_TM`` — contiguous segments of the DFS(backward)-ordered
  leaf list, minimax-partitioned by binary search on the makespan with
  greedy maximal segments (contiguous DFS segments are dense subtries, so
  the bins stay efficient tree-engine inputs).

Bins are lists of ORIGINAL ``_sequence_batch_id``s (leaf bins are mapped
back through the attach lists).
"""

from __future__ import annotations

import numpy as np

from dynamictreeattn_tpu_torch.tries import TokenTrie, trie_stats
from dynamictreeattn_tpu_torch.parallel.time_model import TreeTimeModel

__all__ = ["LB_by_n_tokens", "LB_by_TM", "LB_by_DFS_and_TM", "pred_time", "eval_bins"]


def _leaf_bins_to_seq_bins(trie: TokenTrie, leaf_bins) -> list[list[int]]:
    out = []
    for bin_leaves in leaf_bins:
        ids = []
        for leaf in bin_leaves:
            ids.extend(
                int(att["_sequence_batch_id"]) for att, _ in trie.attach_lists[leaf]
            )
        out.append(sorted(ids))
    return out


def pred_time(
    trie: TokenTrie,
    leaf_ids,
    time_model: TreeTimeModel,
    mode: str = "backward",
    block_size: int = 2048,
) -> float:
    """Predicted execution time of the subtrie induced by `leaf_ids`."""
    if not leaf_ids:
        return 0.0
    lens, lcps = trie.subset_lens(leaf_ids)
    return time_model.pred(trie_stats(lens, lcps, mode=mode, block_size=block_size))


def LB_by_n_tokens(seqs, K: int) -> list[list[int]]:
    """FFD greedy by token count."""
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    loads = [0] * K
    bins: list[list[int]] = [[] for _ in range(K)]
    for i in order:
        b = int(np.argmin(loads))
        bins[b].append(i)
        loads[b] += len(seqs[i])
    return [sorted(b) for b in bins]


def LB_by_TM(
    seqs,
    time_model: TreeTimeModel,
    K: int,
    mode: str = "backward",
    block_size: int = 2048,
) -> list[list[int]]:
    """Greedy FFD by predicted subtrie time.

    Leaves are inserted longest-first; each goes to the bin whose predicted
    time after insertion is smallest."""
    trie = TokenTrie(list(seqs), [{} for _ in seqs])
    lens = trie.lens
    order = sorted(range(trie.n_leaves), key=lambda l: -int(lens[l]))
    bins: list[list[int]] = [[] for _ in range(K)]
    times = [0.0] * K
    for leaf in order:
        best, best_t = 0, None
        for b in range(K):
            t = pred_time(trie, sorted(bins[b] + [leaf]), time_model, mode, block_size)
            if best_t is None or t < best_t:
                best, best_t = b, t
        bins[best].append(leaf)
        times[best] = best_t
    return _leaf_bins_to_seq_bins(trie, [sorted(b) for b in bins])


def LB_by_DFS_and_TM(
    seqs,
    time_model: TreeTimeModel,
    K: int,
    mode: str = "backward",
    block_size: int = 2048,
    iters: int = 48,
) -> list[list[int]]:
    """Contiguous-DFS minimax partition.

    Binary search on the makespan limit; feasibility check = greedy maximal
    contiguous segments (each extended by inner binary search — predicted
    time is monotone in segment extension for NNLS-nonneg coefficients)."""
    trie = TokenTrie(list(seqs), [{} for _ in seqs])
    trie.backward_permute()
    n = trie.n_leaves

    def seg_time(lo: int, hi: int) -> float:
        return pred_time(trie, list(range(lo, hi)), time_model, mode, block_size)

    def greedy_segments(limit: float) -> list[tuple[int, int]] | None:
        segs = []
        lo = 0
        while lo < n:
            if seg_time(lo, lo + 1) > limit:
                return None  # single leaf exceeds limit
            # maximal hi with seg_time(lo, hi) <= limit
            a, b = lo + 1, n
            while a < b:
                mid = (a + b + 1) // 2
                if seg_time(lo, mid) <= limit:
                    a = mid
                else:
                    b = mid - 1
            segs.append((lo, a))
            lo = a
            if len(segs) > K:
                return None
        return segs

    lo_t = max(seg_time(i, i + 1) for i in range(n))
    hi_t = seg_time(0, n)
    segs = greedy_segments(hi_t) or [(0, n)]
    for _ in range(iters):
        mid = (lo_t + hi_t) / 2
        got = greedy_segments(mid)
        if got is not None:
            hi_t, segs = mid, got
        else:
            lo_t = mid
    leaf_bins = [list(range(lo, hi)) for lo, hi in segs]
    leaf_bins += [[] for _ in range(K - len(leaf_bins))]
    return _leaf_bins_to_seq_bins(trie, leaf_bins)


def eval_bins(
    seqs,
    bins,
    time_model: TreeTimeModel,
    mode: str = "backward",
    block_size: int = 2048,
) -> dict:
    """Predicted per-bin times + makespan."""
    times = []
    for ids in bins:
        if not ids:
            times.append(0.0)
            continue
        sub = [seqs[i] for i in ids]
        t = TokenTrie(sub, [{} for _ in sub])
        times.append(
            time_model.pred(
                trie_stats(t.lens, t.lcp_lens, mode=mode, block_size=block_size)
            )
        )
    return {"bin_times": times, "makespan": max(times), "mean": float(np.mean(times))}
