"""Dense interval-mask tree attention: the oracle.

Counterpart of ``dynamictreeattn_tpu/ops/tree_attention_ref.py``. Position q
attends to position k iff k is an ancestor-or-self of q in the packed DFS
layout, i.e. ``k <= q <= last_desc[k]``. Materializes the full [n, n] score
matrix — for tests and small inputs only.
"""

from __future__ import annotations

import torch

__all__ = ["tree_attention_reference", "tree_mask"]


def tree_mask(last_desc: torch.Tensor) -> torch.Tensor:
    """[n, n] boolean mask: mask[q, k] = q attends to k (k ancestor of q)."""
    n = last_desc.shape[0]
    pos = torch.arange(n, device=last_desc.device)
    return (pos[None, :] <= pos[:, None]) & (pos[:, None] <= last_desc[None, :])


def tree_attention_reference(
    q: torch.Tensor,  # [Hq, n, dh]
    k: torch.Tensor,  # [Hkv, n, dh]
    v: torch.Tensor,  # [Hkv, n, dv] (dv = dh but for latent attention)
    last_desc: torch.Tensor,  # [n] int
    scale: float | None = None,
) -> torch.Tensor:
    hq, n, dh = q.shape
    hkv = k.shape[0]
    if hq % hkv:
        raise ValueError(f"{hq=} not a multiple of {hkv=}")
    g = hq // hkv
    if scale is None:
        scale = dh**-0.5
    qf = q.float().reshape(hkv, g, n, dh)
    s = torch.einsum("hgqd,hkd->hgqk", qf, k.float()) * scale
    s = s.masked_fill(~tree_mask(last_desc)[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("hgqk,hkd->hgqd", p, v.float())
    return o.reshape(hq, n, v.shape[-1]).to(q.dtype)
