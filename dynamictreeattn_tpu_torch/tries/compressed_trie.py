"""CompressedTrie: radix-trie structure built from (lens, lcp_lens) alone.

Counterpart of ``dynamictreeattn_tpu/tries/compressed_trie.py``. The trie
*shape* is determined by sorted leaf lengths plus adjacent-LCP lengths, built
with the classic suffix-tree stack sweep. Leaf order only affects the block
locality of the mask metadata; any DFS order is correct. Two orders:

* forward  — children visited ascending by subtree max depth (shallow first);
* backward — leaf children before internal children, ascending by max depth,
  whole traversal reversed;
* random — children shuffled at every node by a seeded numpy generator (the
  same seed gives JAX's order).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CTNode", "CompressedTrie"]


@dataclasses.dataclass
class CTNode:
    depth: int  # string depth (token count from the root)
    children: list["CTNode"] = dataclasses.field(default_factory=list)
    leaf_id: int | None = None
    max_depth: int = 0  # filled by _annotate


class CompressedTrie:
    def __init__(self, lens, lcp_lens):
        lens = np.asarray(lens, dtype=np.int64)
        lcp_lens = np.asarray(lcp_lens, dtype=np.int64)
        if len(lens) == 0:
            raise ValueError("empty trie")
        if len(lcp_lens) != len(lens) - 1:
            raise ValueError("lcp_lens must have len(lens) - 1 entries")
        self.lens = lens
        self.lcp_lens = lcp_lens
        self.root = self._build(lens, lcp_lens)
        self._annotate(self.root)

    @staticmethod
    def _build(lens, lcp_lens) -> CTNode:
        root = CTNode(depth=0)
        first = CTNode(depth=int(lens[0]), leaf_id=0)
        root.children.append(first)
        stack = [root, first]
        for i in range(1, len(lens)):
            l = int(lcp_lens[i - 1])
            last_popped = None
            while stack[-1].depth > l:
                last_popped = stack.pop()
            if stack[-1].depth == l:
                parent = stack[-1]
            else:
                # Split the edge to `last_popped` with a new internal node.
                mid = CTNode(depth=l)
                top = stack[-1]
                top.children[-1] = mid
                mid.children.append(last_popped)
                stack.append(mid)
                parent = mid
            leaf = CTNode(depth=int(lens[i]), leaf_id=i)
            parent.children.append(leaf)
            stack.append(leaf)
        return root

    @staticmethod
    def _annotate(node: CTNode) -> None:
        # Iterative post-order to avoid recursion limits on deep tries.
        order: list[CTNode] = []
        todo = [node]
        while todo:
            n = todo.pop()
            order.append(n)
            todo.extend(n.children)
        for n in reversed(order):
            n.max_depth = max(c.max_depth for c in n.children) if n.children else n.depth

    def _dfs_leaves(self, child_key) -> list[int]:
        out: list[int] = []
        todo = [self.root]
        while todo:
            n = todo.pop()
            if n.leaf_id is not None:
                out.append(n.leaf_id)
            # Reversed so the first-sorted child is visited first (LIFO stack).
            todo.extend(sorted(n.children, key=child_key, reverse=True))
        return out

    def get_order_forward(self) -> list[int]:
        return self._dfs_leaves(lambda c: (c.max_depth, c.leaf_id is None))

    def get_order_backward(self) -> list[int]:
        # Leaf children first, then ascending max depth; reverse whole walk.
        order = self._dfs_leaves(lambda c: (c.leaf_id is None, c.max_depth))
        return order[::-1]

    def get_order_random(self, seed: int = 0) -> list[int]:
        rng = np.random.default_rng(seed)
        out: list[int] = []
        todo = [self.root]
        while todo:
            n = todo.pop()
            if n.leaf_id is not None:
                out.append(n.leaf_id)
            kids = list(n.children)
            rng.shuffle(kids)
            todo.extend(kids)
        return out
