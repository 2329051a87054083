"""Flatten a TokenTrie into a packed DFS layout + tree-attention mask metadata.

Counterpart of ``dynamictreeattn_tpu/tries/flatten.py`` (its numpy paths; the
native treekit bridge is not ported). The trie is flattened ONCE into a single
packed sequence in DFS order, where:

* each trie token occupies exactly one packed position ``j``;
* ``depth[j]`` is its distance from the root (the RoPE position id);
* ``parent[j]`` is the packed position of its trie parent (−1 for roots);
* ``last_desc[j]`` is the largest packed position in j's subtree.

Because DFS assigns each subtree a contiguous interval, the tree-attention
mask is the O(1) interval test::

    attend(q, k)  ⇔  k <= q <= last_desc[k]

``build_block_meta`` turns ``last_desc`` into block-sparse metadata: for each
query block, the list of key/value blocks holding any ancestor, each tagged
full (type 2) or partial (type 1). The attention kernels visit only those.

Loss weighting: each packed position gets a scalar weight — position j's
logprob edge (entropy) contributes to every sequence whose path contains j,
weighted per the default linear loss ``w_logprobs·mean(logprobs[:L−1]) +
w_entropy·mean(entropy[:L])``, accumulated up the parent chain in O(n).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dynamictreeattn_tpu_torch.tries.token_trie import TokenTrie

__all__ = ["PackedTrie", "BlockMeta", "flatten_trie", "build_block_meta", "pack_forest"]


def _default_weight_fn(attachment: dict, length: int) -> tuple[float, float]:
    """(total logprob weight, total entropy weight) for one sequence endpoint."""
    return (
        float(attachment.get("w_logprobs", -1.0)),
        float(attachment.get("w_entropy", 0.1)),
    )


@dataclasses.dataclass
class PackedTrie:
    """A trie (or forest of tries) in packed DFS layout, padded to a bucket."""

    tokens: np.ndarray  # [n_padded] int32
    depth: np.ndarray  # [n_padded] int32 — RoPE position ids
    parent: np.ndarray  # [n_padded] int32, -1 for roots and padding
    last_desc: np.ndarray  # [n_padded] int32, == own index for padding
    w_logprob: np.ndarray  # [n_padded] float32 — weight of edge parent[j]→j
    w_entropy: np.ndarray  # [n_padded] float32 — weight of entropy at j
    valid: np.ndarray  # [n_padded] float32 — 1.0 real token, 0.0 padding
    n_tokens: int  # valid (un-padded) token count
    # one row per original sequence endpoint:
    seq_batch_ids: np.ndarray  # [n_seqs] int32 — _sequence_batch_id
    seq_end_pos: np.ndarray  # [n_seqs] int32 — packed pos of last token
    seq_lens: np.ndarray  # [n_seqs] int32

    @property
    def n_padded(self) -> int:
        return len(self.tokens)

    def seq_path(self, which: int) -> np.ndarray:
        """Packed positions of sequence `which`'s tokens, root → endpoint."""
        length = int(self.seq_lens[which])
        return self.seq_paths_matrix()[which, :length]

    def seq_paths_matrix(self) -> np.ndarray:
        """[n_seqs, Lmax] packed root→endpoint paths, -1 padded; computed
        once per PackedTrie by a vectorized parent-chain walk and cached."""
        cached = getattr(self, "_paths_cache", None)
        if cached is not None:
            return cached
        S = len(self.seq_lens)
        lmax = int(self.seq_lens.max()) if S else 0
        paths = np.full((S, max(lmax, 1)), -1, np.int32)
        pos = self.seq_end_pos.astype(np.int64).copy()
        d = self.seq_lens.astype(np.int64) - 1
        for _ in range(lmax):
            act = d >= 0
            if not act.any():
                break
            rows = np.nonzero(act)[0]
            paths[rows, d[act]] = pos[act]
            pos[act] = self.parent[pos[act]]
            d -= 1
        self._paths_cache = paths
        return paths


def flatten_trie(
    trie: TokenTrie,
    pad_to: int | None = None,
    weight_fn=_default_weight_fn,
) -> PackedTrie:
    """Flatten a TokenTrie into a PackedTrie.

    `pad_to` pads the packed length (padding tokens are isolated roots with
    zero loss weight: they attend only to themselves, so they never NaN and
    never contribute).
    """
    lens = trie.lens
    lcps = np.concatenate([[0], trie.lcp_lens]) if trie.n_leaves > 1 else np.array([0])
    n = int(lens.sum() - lcps[1:].sum()) if trie.n_leaves > 1 else int(lens[0])

    q_leaf: list[int] = []
    q_len: list[int] = []
    q_wlp: list[float] = []
    q_went: list[float] = []
    seq_batch_ids: list[int] = []
    for i in range(trie.n_leaves):
        for attachment, length in trie.attach_lists[i]:
            w_lp, w_ent = weight_fn(attachment, length)
            q_leaf.append(i)
            q_len.append(length)
            q_wlp.append(w_lp)
            q_went.append(w_ent)
            seq_batch_ids.append(int(attachment["_sequence_batch_id"]))
    q_len_a = np.asarray(q_len, np.int64)
    q_wlp_a = np.asarray(q_wlp, np.float64)
    q_went_a = np.asarray(q_went, np.float64)

    tokens = np.zeros(n, dtype=np.int32)
    depth = np.zeros(n, dtype=np.int32)
    parent = np.full(n, -1, dtype=np.int32)
    end_a = np.empty(len(q_leaf), np.int64)
    stack_pos = np.full(int(lens.max()) + 1, -1, dtype=np.int64)
    cursor = 0
    qi = 0
    for i in range(trie.n_leaves):
        seq = trie.inputs[i]
        start = int(lcps[i])
        new = len(seq) - start
        if new > 0:
            sl = slice(cursor, cursor + new)
            tokens[sl] = seq[start:]
            depth[sl] = np.arange(start, len(seq), dtype=np.int32)
            parent[sl] = np.concatenate(
                [
                    [stack_pos[start - 1] if start > 0 else -1],
                    np.arange(cursor, cursor + new - 1, dtype=np.int64),
                ]
            )
            stack_pos[start : len(seq)] = np.arange(cursor, cursor + new)
            cursor += new
        while qi < len(q_leaf) and q_leaf[qi] == i:
            end_a[qi] = stack_pos[q_len[qi] - 1]
            qi += 1
    if cursor != n:
        raise AssertionError(f"flatten placed {cursor} tokens, expected {n}")

    acc_lp = np.zeros(n, dtype=np.float64)
    acc_ent = np.zeros(n, dtype=np.float64)
    multi = q_len_a > 1
    np.add.at(acc_lp, end_a[multi], q_wlp_a[multi] / (q_len_a[multi] - 1))
    np.add.at(acc_ent, end_a, q_went_a / q_len_a)

    # last_desc via monotone depth stack (DFS layout property).
    last_desc = np.empty(n, dtype=np.int32)
    dstack: list[int] = []
    for j in range(n):
        while dstack and depth[dstack[-1]] >= depth[j]:
            last_desc[dstack.pop()] = j - 1
        dstack.append(j)
    for j in dstack:
        last_desc[j] = n - 1

    # Propagate endpoint weights up the parent chain: parent[j] < j in DFS
    # order, so a single reverse sweep suffices.
    for j in range(n - 1, -1, -1):
        p = parent[j]
        if p >= 0:
            acc_lp[p] += acc_lp[j]
            acc_ent[p] += acc_ent[j]
    w_logprob = acc_lp.astype(np.float32)
    w_logprob[depth == 0] = 0.0  # roots have no incoming edge
    w_entropy = acc_ent.astype(np.float32)

    packed = PackedTrie(
        tokens=tokens,
        depth=depth,
        parent=parent,
        last_desc=last_desc,
        w_logprob=w_logprob,
        w_entropy=w_entropy,
        valid=np.ones(n, dtype=np.float32),
        n_tokens=n,
        seq_batch_ids=np.asarray(seq_batch_ids, dtype=np.int32),
        seq_end_pos=np.asarray(end_a, dtype=np.int32),
        seq_lens=np.asarray(q_len_a, dtype=np.int32),
    )
    if pad_to is not None:
        packed = _pad_packed(packed, pad_to)
    return packed


def _pad_packed(p: PackedTrie, pad_to: int) -> PackedTrie:
    n = p.n_padded
    if pad_to < n:
        raise ValueError(f"pad_to={pad_to} < packed length {n}")
    extra = pad_to - n
    if extra == 0:
        return p
    pad_idx = np.arange(n, pad_to, dtype=np.int32)
    return dataclasses.replace(
        p,
        tokens=np.concatenate([p.tokens, np.zeros(extra, np.int32)]),
        depth=np.concatenate([p.depth, np.zeros(extra, np.int32)]),
        parent=np.concatenate([p.parent, np.full(extra, -1, np.int32)]),
        last_desc=np.concatenate([p.last_desc, pad_idx]),
        w_logprob=np.concatenate([p.w_logprob, np.zeros(extra, np.float32)]),
        w_entropy=np.concatenate([p.w_entropy, np.zeros(extra, np.float32)]),
        valid=np.concatenate([p.valid, np.zeros(extra, np.float32)]),
    )


def pack_forest(packed_tries: list[PackedTrie], pad_to: int | None = None) -> PackedTrie:
    """Concatenate several PackedTries into one forest buffer.

    DFS intervals never span tries, so the interval mask stays exact — no
    segment ids needed. Sequence endpoints keep their original batch ids, so
    callers must ensure ids are disjoint (or re-key afterwards).
    """
    offsets = np.cumsum([0] + [p.n_padded for p in packed_tries])

    def _shift_parent(off, p):
        a = p.parent.copy()
        a[a >= 0] += off
        return a

    merged = PackedTrie(
        tokens=np.concatenate([p.tokens for p in packed_tries]),
        depth=np.concatenate([p.depth for p in packed_tries]),
        parent=np.concatenate(
            [_shift_parent(off, p) for off, p in zip(offsets, packed_tries)]
        ),
        last_desc=np.concatenate(
            [p.last_desc + off for off, p in zip(offsets, packed_tries)]
        ),
        w_logprob=np.concatenate([p.w_logprob for p in packed_tries]),
        w_entropy=np.concatenate([p.w_entropy for p in packed_tries]),
        valid=np.concatenate([p.valid for p in packed_tries]),
        n_tokens=int(offsets[-1]),
        seq_batch_ids=np.concatenate([p.seq_batch_ids for p in packed_tries]),
        seq_end_pos=np.concatenate(
            [p.seq_end_pos + off for off, p in zip(offsets, packed_tries)]
        ),
        seq_lens=np.concatenate([p.seq_lens for p in packed_tries]),
    )
    if pad_to is not None:
        merged = _pad_packed(merged, pad_to)
    return merged


@dataclasses.dataclass
class BlockMeta:
    """Block-sparse tree-mask metadata for the attention kernels.

    Query-major: for query block i, the kernel visits kv blocks
    ``kv_ids[i, s]`` for s < ``kv_counts[i]``; ``kv_types[i, s]`` is 2 when
    every (q, k) pair in the tile is unmasked (no mask applied in-kernel) and
    1 when the interval test must run elementwise. Slots past the count
    repeat the last valid id with type 0. ``q_ids/q_counts/q_types`` hold the
    key-major transpose (read by the backward kernels of a later slice).
    """

    block_q: int
    block_kv: int
    kv_ids: np.ndarray  # [n_q_blocks, max_kv_slots] int32
    kv_counts: np.ndarray  # [n_q_blocks] int32
    kv_types: np.ndarray  # [n_q_blocks, max_kv_slots] int32 (1 partial, 2 full)
    q_ids: np.ndarray  # [n_kv_blocks, max_q_slots] int32
    q_counts: np.ndarray  # [n_kv_blocks] int32
    q_types: np.ndarray  # [n_kv_blocks, max_q_slots] int32


def build_block_meta(
    last_desc: np.ndarray,
    block_q: int,
    block_kv: int,
    min_kv_slots: int = 0,
    min_q_slots: int = 0,
) -> BlockMeta:
    """Compute block-sparse metadata from `last_desc` (padded length).

    Query block i covers rows [i·Bq, (i+1)·Bq); kv block j covers columns
    [j·Bk, (j+1)·Bk). With q ∈ Q, k ∈ K, mask = k ≤ q ≤ last_desc[k] and
    last_desc[k] ≥ k:

    * K active for Q   ⇔ ks < qe  and  max(last_desc[K]) ≥ qs
    * K full for Q     ⇔ ke ≤ qs+1 and min(last_desc[K]) ≥ qe−1
    """
    n = len(last_desc)
    if n % block_q or n % block_kv:
        raise ValueError("padded length must divide both block sizes")
    nq, nk = n // block_q, n // block_kv
    ld = np.asarray(last_desc, dtype=np.int64).reshape(nk, block_kv)
    ld_max = ld.max(axis=1)
    ld_min = ld.min(axis=1)

    qs = np.arange(nq, dtype=np.int64)[:, None] * block_q
    qe = qs + block_q
    ks = np.arange(nk, dtype=np.int64)[None, :] * block_kv
    ke = ks + block_kv

    active = (ks < qe) & (ld_max[None, :] >= qs)  # [nq, nk]
    full = (ke - 1 <= qs) & (ld_min[None, :] >= qe - 1)

    kv_ids, kv_counts, kv_types = _compact(active, full, min_kv_slots)
    q_ids, q_counts, q_types = _compact(active.T, full.T, min_q_slots)
    return BlockMeta(
        block_q=block_q,
        block_kv=block_kv,
        kv_ids=kv_ids,
        kv_counts=kv_counts,
        kv_types=kv_types,
        q_ids=q_ids,
        q_counts=q_counts,
        q_types=q_types,
    )


def _compact(active: np.ndarray, full: np.ndarray, min_slots: int):
    """Row-compact a boolean activity matrix into (ids, counts, types)."""
    nrows, _ = active.shape
    counts = active.sum(axis=1).astype(np.int32)
    # Every row has ≥1 active block (its diagonal block), so the repeat-
    # padding has something to repeat.
    if counts.min() < 1:
        raise ValueError("every block row must have at least one active block")
    width = max(int(counts.max()), min_slots, 1)
    ids = np.zeros((nrows, width), dtype=np.int32)
    types = np.zeros((nrows, width), dtype=np.int32)
    for r in range(nrows):
        cols = np.nonzero(active[r])[0]
        c = len(cols)
        ids[r, :c] = cols
        types[r, :c] = np.where(full[r, cols], 2, 1)
        ids[r, c:] = cols[-1]
    return ids, counts, types
