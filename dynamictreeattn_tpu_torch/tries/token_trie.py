"""TokenTrie: lexicographically sorted, leafized token sequences + attachments.

Counterpart of ``dynamictreeattn_tpu/tries/token_trie.py``; same contract:

* every attachment is tagged with ``_sequence_batch_id`` = its original batch
  index, which is how per-sequence results are routed back to the caller;
* sequences are sorted lexicographically so adjacent LCPs describe the full
  trie;
* *leafization* merges sequences that are full prefixes of other sequences,
  keeping only leaf sequences and recording ``(attachment, length)`` pairs per
  leaf so losses still fire at interior endpoints.

Host-side numpy only; tensors appear at the device boundary (engine/).
"""

from __future__ import annotations

import numpy as np

from dynamictreeattn_tpu_torch.tries.compressed_trie import CompressedTrie
from dynamictreeattn_tpu_torch.tries.stats import trie_stats

__all__ = ["TokenTrie", "lcp_arrays", "lcp_pair"]


def _as_1d_int_array(seq) -> np.ndarray:
    arr = np.asarray(seq)
    if arr.ndim != 1:
        raise ValueError(f"token sequence must be 1-D, got shape {arr.shape}")
    return arr.astype(np.int32, copy=False)


def lcp_pair(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the longest common prefix of two 1-D token arrays."""
    m = min(len(a), len(b))
    if m == 0:
        return 0
    neq = np.nonzero(a[:m] != b[:m])[0]
    return int(neq[0]) if len(neq) else m


def lcp_arrays(seqs: list[np.ndarray]) -> np.ndarray:
    """Adjacent LCP lengths: lcp[i] = LCP(seqs[i], seqs[i+1]). Shape [len-1]."""
    return np.array(
        [lcp_pair(seqs[i], seqs[i + 1]) for i in range(len(seqs) - 1)],
        dtype=np.int64,
    )


def _sort_key(seq: np.ndarray) -> bytes:
    # Big-endian uint32 bytes compare like elementwise int comparison for
    # non-negative token ids, so bytes sorting == lexicographic sequence
    # sorting (and shorter prefixes sort first).
    return seq.astype(">u4").tobytes()


class TokenTrie:
    """A batch of token sequences organized as a token trie.

    Attributes
    ----------
    inputs : list[np.ndarray]
        Leaf token sequences in the current DFS order.
    attach_lists : list[list[tuple[dict, int]]]
        Per leaf: ``(attachment, length)`` pairs. Each pair is a loss endpoint:
        `length` tokens of this leaf form one original sequence.
    lcp_lens : np.ndarray
        Adjacent LCP lengths, shape [n_leaves - 1].
    """

    def __init__(self, inputs, attachs=None, leafization: bool = True):
        seqs = [_as_1d_int_array(s) for s in inputs]
        if attachs is None:
            attachs = [{} for _ in seqs]
        if len(attachs) != len(seqs):
            raise ValueError("inputs and attachs must have equal length")
        attachs = [dict(a, _sequence_batch_id=i) for i, a in enumerate(attachs)]

        order = sorted(range(len(seqs)), key=lambda i: _sort_key(seqs[i]))
        seqs = [seqs[i] for i in order]
        attach_lists = [[(attachs[i], len(seqs[j]))] for j, i in enumerate(order)]

        if leafization and len(seqs) > 1:
            seqs, attach_lists = _leafize(seqs, attach_lists)

        self.inputs: list[np.ndarray] = seqs
        self.attach_lists: list[list[tuple[dict, int]]] = attach_lists
        self.lcp_lens: np.ndarray = lcp_arrays(seqs)
        self._lcp_sparse_table: list[np.ndarray] | None = None

    @property
    def n_leaves(self) -> int:
        return len(self.inputs)

    @property
    def n_sequences(self) -> int:
        return sum(len(al) for al in self.attach_lists)

    @property
    def lens(self) -> np.ndarray:
        return np.array([len(s) for s in self.inputs], dtype=np.int64)

    @property
    def n_tree_tokens(self) -> int:
        return int(self.lens.sum() - self.lcp_lens.sum())

    @property
    def n_dense_tokens(self) -> int:
        """Token count the dense replay baseline would process."""
        return int(sum(length for al in self.attach_lists for _, length in al))

    def permute(self, order) -> None:
        """Re-order leaves by `order` (a valid DFS order of this trie) and
        recompute adjacent LCPs."""
        order = list(order)
        if sorted(order) != list(range(self.n_leaves)):
            raise ValueError("order must be a permutation of leaves")
        self.inputs = [self.inputs[i] for i in order]
        self.attach_lists = [self.attach_lists[i] for i in order]
        self.lcp_lens = lcp_arrays(self.inputs)
        self._lcp_sparse_table = None

    def forward_permute(self) -> None:
        self.permute(CompressedTrie(self.lens, self.lcp_lens).get_order_forward())

    def backward_permute(self) -> None:
        self.permute(CompressedTrie(self.lens, self.lcp_lens).get_order_backward())

    def random_permute(self, seed: int = 0) -> None:
        self.permute(CompressedTrie(self.lens, self.lcp_lens).get_order_random(seed=seed))

    def get_stats(self, mode: str = "forward", block_size: int = 2048) -> dict:
        return trie_stats(self.lens, self.lcp_lens, mode=mode, block_size=block_size)

    def lcp_range_min(self, lo: int, hi: int) -> int:
        """min(lcp_lens[lo:hi]) in O(1) via a sparse table: for leaves i < j
        in the current order, LCP(leaf_i, leaf_j) = min(lcp_lens[i:j]), so
        subtrie shapes of leaf subsets need no rebuild."""
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            raise ValueError("empty range")
        if self._lcp_sparse_table is None:
            self._lcp_sparse_table = _sparse_table(self.lcp_lens)
        k = (hi - lo).bit_length() - 1
        t = self._lcp_sparse_table[k]
        return int(min(t[lo], t[hi - (1 << k)]))

    def subset_lens(self, leaf_ids) -> tuple[np.ndarray, np.ndarray]:
        """(lens, lcp_lens) of the subtrie induced by `leaf_ids` (indices into
        the current leaf order), as the data-parallel load balancers read it."""
        ids = sorted(leaf_ids)
        lcps = np.array([self.lcp_range_min(ids[j - 1], ids[j]) for j in range(1, len(ids))],
                        dtype=np.int64)
        return self.lens[ids], lcps


def _sparse_table(a: np.ndarray) -> list[np.ndarray]:
    """Level k holds min(a[i:i + 2**k]) at i."""
    tables = [a.astype(np.int64)]
    while (2 << (len(tables) - 1)) <= len(a):
        half = 1 << (len(tables) - 1)
        tables.append(np.minimum(tables[-1][:-half], tables[-1][half:]))
    return tables


def _leafize(seqs, attach_lists):
    """Merge sequences that are full prefixes of their successor. In sorted
    order, seq[i] is a prefix of seq[i+1] iff LCP(i, i+1) == len(seq[i]);
    chains fold transitively."""
    out_seqs: list[np.ndarray] = []
    out_attach: list[list[tuple[dict, int]]] = []
    carry: list[tuple[dict, int]] = []
    for i, seq in enumerate(seqs):
        merged = carry + attach_lists[i]
        carry = []
        if i + 1 < len(seqs) and lcp_pair(seq, seqs[i + 1]) == len(seq):
            carry = merged  # fold into the extension leaf
        else:
            out_seqs.append(seq)
            out_attach.append(merged)
    if carry:
        raise AssertionError("leafization left an unmerged prefix")
    return out_seqs, out_attach
