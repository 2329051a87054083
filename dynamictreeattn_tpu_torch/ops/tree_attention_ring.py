"""Ring tree attention: tree-masked attention over a sequence-sharded trie.

Counterpart of ``dynamictreeattn_tpu/ops/tree_attention_ring.py``. The
packed DFS trie is sharded over the mesh's "seq" group: each rank holds q, k
and v of its n/sp rows with all its local heads, and the K/V chunks rotate
around the ring (``parallel.collectives.ring_shift``, to the next rank), one
step per shard. At step r rank ``me`` holds the chunk of ``src = (me - r) mod
sp`` and runs the port's own kernels on the (my q shard, that kv shard)
pair:

* K2, the online forward, K11 (dq) and K12 (dk, dv), each given the pair's
  global position offsets ``(me·n_loc, src·n_loc)``, the whole replicated
  ``last_desc`` and the pair's metadata (``tries.build_ring_block_meta``)
  and work lists (``RingPair``, built on the host once per batch);
* the pairs' (o_i, lse_i) merged in fp32 by online softmax (``_combine``,
  JAX's, -inf special-cased).

A pair with no live block (a later shard's keys, or no ancestor relation)
launches nothing: its kernels would give o = 0 and lse = -inf, which merge
with weight 0, and zero gradients. A row that sees no key of a live pair
gets (the mean of its keys' v, lse ~ MASK_VALUE) from K2 and from the plain
K2; the diagonal pair comes first and every row sees itself there, so such
a partial merges with weight exp(MASK_VALUE - lse) = 0 exactly.

The backward (``_TreeAttentionRing``, JAX's custom_vjp): dq accumulates
locally in fp32 over the incoming chunks; the fp32 (dk, dv) accumulators
travel with their kv chunk and are home after sp hops.

``tree_attention_ring_reference`` is the blocked differentiable ring in
plain torch (autograd through the rotation): the CPU tests' oracle and the
"reference" attention backend under ring sequence parallelism.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from dynamictreeattn_tpu_torch.ops.tree_attention import (
    MASK_VALUE, BlockSizes, kmajor_work, qmajor_work, tree_attn_bwd_dkv, tree_attn_bwd_dq, tree_attn_fwd_online,
)
from dynamictreeattn_tpu_torch.parallel.collectives import ring_shift
from dynamictreeattn_tpu_torch.tries import KMajorWork, QMajorWork

__all__ = ["RING_META_FIELDS", "RingPair", "ring_pairs", "tree_attention_ring", "tree_attention_ring_reference"]

RING_META_FIELDS = ("kv_ids", "kv_counts", "kv_types", "q_ids", "q_counts", "q_types")


@dataclasses.dataclass
class RingPair:
    """One ring step of a rank: its q shard against kv shard `src`."""

    src: int
    q_off: int  # global position of the first query (me · n_loc)
    kv_off: int  # ... and of the first key (src · n_loc)
    meta: tuple  # the pair's (kv_ids, kv_counts, kv_types, q_ids, q_counts, q_types) int32 on the device
    live: bool  # whether any block of the pair is active
    qwork: QMajorWork | None = None  # K2's and K11's work list on the card
    kwork: KMajorWork | None = None  # K12's


def ring_pairs(last_desc: np.ndarray, ring_meta: dict, me: int, sp: int, block_q: int, block_kv: int,
               device, hkv: int = 0, head_dim: int = 0, work: bool = False) -> list:
    """Rank `me`'s RingPair of each ring step r (src = (me - r) mod sp) from
    the whole ``last_desc`` and the ring metadata ({field: [sp, sp, ...]},
    ``build_ring_block_meta``'s), uploaded to `device`; with `work`, the
    live pairs' work lists for `hkv` kv heads of `head_dim` (the card's)."""
    n_loc = len(last_desc) // sp
    pairs = []
    for r in range(sp):
        src = (me - r) % sp
        arrays = [np.ascontiguousarray(ring_meta[f][me, src], dtype=np.int32) for f in RING_META_FIELDS]
        live = bool((arrays[2] > 0).any())
        pair = RingPair(src=src, q_off=me * n_loc, kv_off=src * n_loc,
                        meta=tuple(torch.from_numpy(a).to(device) for a in arrays), live=live)
        if work and live:
            offs = dict(q_off=pair.q_off, kv_off=pair.kv_off, n_loc=n_loc)
            pair.qwork = qmajor_work(last_desc, *arrays[:3], block_q, block_kv, device, **offs)
            pair.kwork = kmajor_work(last_desc, *arrays[3:], block_q, block_kv, hkv, head_dim, device, **offs)
        pairs.append(pair)
    return pairs


def _combine(o_run, lse_run, o_i, lse_i):
    """fp32 online-softmax merge of a normalised partial (o_i, lse_i)."""
    lse_new = torch.logaddexp(lse_run, lse_i)
    c_run = torch.where(lse_run == -torch.inf, 0.0, torch.exp(lse_run - lse_new))
    c_i = torch.where(lse_i == -torch.inf, 0.0, torch.exp(lse_i - lse_new))
    return o_run * c_run[..., None] + o_i.float() * c_i[..., None], lse_new


def _rotate(tensors, group):
    """The tensors (one dtype) of the previous rank of the ring, in one exchange."""
    return ring_shift(torch.stack(tensors), group).unbind(0)


class _TreeAttentionRing(torch.autograd.Function):
    """Forward: K2 on each live pair, merged by ``_combine``; backward: K11
    and K12 on each live pair from the final lse and di = sum(do * o), dq
    summed here, (dk, dv) riding the ring home (module docstring)."""

    @staticmethod
    def forward(ctx, q4, k, v, last_desc, pairs, group, scale, block_sizes, handoff):
        if handoff is not None and handoff.taking:  # the recompute: the first forward's (o, lse)
            o, lse = handoff.take()
        else:
            hkv, group_size, n, dh = q4.shape
            o_run = torch.zeros(q4.shape, dtype=torch.float32, device=q4.device)
            lse_run = torch.full((hkv, group_size, n), -torch.inf, device=q4.device)
            kc, vc = k, v
            for r, pair in enumerate(pairs):
                if pair.live:
                    o_i, lse_i = tree_attn_fwd_online(q4, kc, vc, last_desc, *pair.meta[:3], scale,
                                                      block_sizes.block_q, block_sizes.block_kv, work=pair.qwork,
                                                      q_off=pair.q_off, kv_off=pair.kv_off)
                    o_run, lse_run = _combine(o_run, lse_run, o_i, lse_i)
                if r < len(pairs) - 1:
                    kc, vc = _rotate((kc, vc), group)
            o, lse = o_run.to(q4.dtype), lse_run
            if handoff is not None:
                handoff.keep((o.detach(), lse))
        ctx.save_for_backward(q4, k, v, o, lse, last_desc)
        ctx.pairs, ctx.group, ctx.scale, ctx.block_sizes = pairs, group, scale, block_sizes
        return o

    @staticmethod
    def backward(ctx, do):
        q4, k, v, o, lse, last_desc = ctx.saved_tensors
        do = do.contiguous()
        di = torch.sum(do.float() * o.float(), dim=-1)
        bq, bkv = ctx.block_sizes.block_q, ctx.block_sizes.block_kv
        dq = torch.zeros(q4.shape, dtype=torch.float32, device=q4.device)
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros_like(dkc)
        kc, vc = k, v
        for r, pair in enumerate(ctx.pairs):
            if pair.live:
                tail = (do, lse, di, ctx.scale, bq, bkv)
                offs = dict(q_off=pair.q_off, kv_off=pair.kv_off)
                dq += tree_attn_bwd_dq(q4, kc, vc, last_desc, *pair.meta[:3], *tail, work=pair.qwork, **offs).float()
                dk_p, dv_p = tree_attn_bwd_dkv(q4, kc, vc, last_desc, *pair.meta[3:], *tail, work=pair.kwork, **offs)
                dkc += dk_p.float()
                dvc += dv_p.float()
            # (dk, dv) travel with their chunk: after sp hops they are home
            dkc, dvc = _rotate((dkc, dvc), ctx.group)
            if r < len(ctx.pairs) - 1:
                kc, vc = _rotate((kc, vc), ctx.group)
        return dq.to(q4.dtype), dkc.to(k.dtype), dvc.to(v.dtype), None, None, None, None, None, None


def tree_attention_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, last_desc: torch.Tensor, pairs: list,
                        group, *, scale: float | None = None, block_sizes: BlockSizes = BlockSizes(),
                        handoff=None) -> torch.Tensor:
    """Ring tree-masked attention over a "seq"-sharded packed trie, o [hq,
    n_loc, dh], differentiable in q, k, v.

    q [hq, n_loc, dh] and k, v [hkv, n_loc, dh]: this rank's rows;
    ``last_desc``: the whole table [n_loc · sp] int32, on q's device;
    `pairs`: the rank's ``RingPair`` of each ring step (``ring_pairs``);
    `group`: the "seq" process group. ``handoff`` as in
    ``ops.tree_attention.tree_attention`` (remat policy "attn")."""
    hq, n_loc, dh = q.shape
    hkv = k.shape[0]
    if hq % hkv:
        raise ValueError(f"{hq=} not a multiple of {hkv=}")
    if n_loc % block_sizes.block_q or n_loc % block_sizes.block_kv:
        raise ValueError(f"block sizes {block_sizes} must divide {n_loc=}")
    sp = 1 if group is None else dist.get_world_size(group)
    if len(pairs) != sp or last_desc.shape != (sp * n_loc,):
        raise ValueError(f"{len(pairs)} ring pairs and last_desc {tuple(last_desc.shape)} for sp={sp}, {n_loc=}")
    if scale is None:
        scale = dh**-0.5
    q4 = q.reshape(hkv, hq // hkv, n_loc, dh).contiguous()
    o = _TreeAttentionRing.apply(q4, k.contiguous(), v.contiguous(), last_desc, pairs, group, float(scale),
                                 block_sizes, handoff)
    return o.reshape(hq, n_loc, dh)


def tree_attention_ring_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, last_desc: torch.Tensor,
                                  group, scale: float | None = None) -> torch.Tensor:
    """The blocked ring in plain torch, differentiable (autograd through the
    rotation): each ring step's chunk folded into a running (m, l, acc) in
    fp32, masked pairs contributing exactly 0. Arguments as
    ``tree_attention_ring``'s, without the metadata."""
    hq, n_loc, dh = q.shape
    hkv = k.shape[0]
    sp, me = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
    if scale is None:
        scale = dh**-0.5
    qg = q.reshape(hkv, hq // hkv, n_loc, dh).float()
    q_pos = me * n_loc + torch.arange(n_loc, device=q.device)
    ld = last_desc.long()
    m = torch.full((hkv, hq // hkv, n_loc), MASK_VALUE, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape, device=q.device)
    kc, vc = k, v
    for r in range(sp):
        src = (me - r) % sp
        k_pos = src * n_loc + torch.arange(n_loc, device=q.device)
        mask = (k_pos[None, :] <= q_pos[:, None]) & (q_pos[:, None] <= ld[src * n_loc:(src + 1) * n_loc][None, :])
        st = torch.einsum("hgqd,hkd->hgqk", qg, kc.float()) * scale + torch.where(mask, 0.0, MASK_VALUE)
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_new[..., None]) * mask
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("hgqk,hkd->hgqd", p, vc.float())
        m = m_new
        if r < sp - 1:
            kc, vc = ring_shift(kc, group), ring_shift(vc, group)
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(hq, n_loc, dh).to(q.dtype)
