"""Token tries, DFS flattening, and tree-attention mask metadata (host numpy).

Counterpart of ``dynamictreeattn_tpu/tries``: the trie is flattened once
into a packed DFS layout in which the tree-attention mask is the interval
test ``k <= q <= last_desc[k]``.
"""

from dynamictreeattn_tpu_torch.tries.compressed_trie import CompressedTrie
from dynamictreeattn_tpu_torch.tries.flatten import (
    BlockMeta,
    BwdCacheSched,
    PackedTrie,
    build_block_meta,
    build_bwd_cache_sched,
    flatten_trie,
    pack_forest,
)
from dynamictreeattn_tpu_torch.tries.token_trie import TokenTrie, lcp_arrays

__all__ = [
    "TokenTrie",
    "CompressedTrie",
    "lcp_arrays",
    "PackedTrie",
    "BlockMeta",
    "BwdCacheSched",
    "flatten_trie",
    "build_block_meta",
    "build_bwd_cache_sched",
    "pack_forest",
]
