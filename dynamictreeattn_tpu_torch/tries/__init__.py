"""Token tries, DFS flattening, and tree-attention mask metadata (host numpy).

Counterpart of ``dynamictreeattn_tpu/tries``: the trie is flattened once
into a packed DFS layout in which the tree-attention mask is the interval
test ``k <= q <= last_desc[k]``.
"""

from dynamictreeattn_tpu_torch.tries.compressed_trie import CompressedTrie
from dynamictreeattn_tpu_torch.tries.flatten import (
    BlockMeta,
    BwdCacheSched,
    KMajorWork,
    PackedTrie,
    QMajorWork,
    RingBlockMeta,
    build_block_meta,
    build_bwd_cache_sched,
    build_kmajor_work,
    build_qmajor_work,
    build_ring_block_meta,
    flatten_trie,
    kmajor_chunk_table,
    pack_forest,
)
from dynamictreeattn_tpu_torch.tries.stats import trie_stats
from dynamictreeattn_tpu_torch.tries.token_trie import TokenTrie, lcp_arrays

__all__ = [
    "TokenTrie",
    "CompressedTrie",
    "lcp_arrays",
    "PackedTrie",
    "BlockMeta",
    "BwdCacheSched",
    "KMajorWork",
    "QMajorWork",
    "RingBlockMeta",
    "flatten_trie",
    "build_block_meta",
    "build_bwd_cache_sched",
    "build_kmajor_work",
    "build_qmajor_work",
    "build_ring_block_meta",
    "kmajor_chunk_table",
    "pack_forest",
    "trie_stats",
]
