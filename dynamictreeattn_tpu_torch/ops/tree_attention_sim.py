"""The blocked walk of the tree-attention forward as a module of its own.

Counterpart of ``dynamictreeattn_tpu/ops/tree_attention_sim.py``:
``tree_attention_blocked_sim`` takes JAX's arguments (q [Hq, n, dh], k, v
[Hkv, n, dh], host ``last_desc`` and ``tries.BlockMeta``) and walks the same
block-sparse metadata with the same masking and softmax updates as the
forward kernels (K1 "bound", K2 "online"), in plain PyTorch: the walk of
``tree_attention.tree_attn_fwd_plain``, which the kernels' wrappers run on
CPU tensors. Not differentiable through the kernels' backward; a test oracle
and a CPU fallback, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamictreeattn_tpu_torch.ops.tree_attention import _score_bound, tree_attn_fwd_plain

__all__ = ["tree_attention_blocked_sim"]


def tree_attention_blocked_sim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, last_desc, meta,
                               scale: float | None = None, softmax_mode: str = "online") -> torch.Tensor:
    """o [Hq, n, dh] in q's dtype of the blocked walk over `meta` (host
    numpy metadata; `last_desc` host numpy or a tensor)."""
    hq, n, dh = q.shape
    hkv = k.shape[0]
    if scale is None:
        scale = dh**-0.5
    if softmax_mode not in ("online", "bound"):
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}")
    dev = q.device
    q4 = q.reshape(hkv, hq // hkv, n, dh)
    c = _score_bound(q4, k, scale) if softmax_mode == "bound" else None
    ld = torch.as_tensor(np.asarray(last_desc), dtype=torch.int32, device=dev)
    ids, counts, types = (torch.from_numpy(np.asarray(getattr(meta, f), np.int32)).to(dev)
                          for f in ("kv_ids", "kv_counts", "kv_types"))
    o, _ = tree_attn_fwd_plain(q4, k, v, ld, ids, counts, types, scale, meta.block_q, meta.block_kv, c=c)
    return o.reshape(hq, n, dh)
