"""Vocab-parallel log-probs and entropies over an LM head sharded by vocabulary.

Counterpart of ``dynamictreeattn_tpu/parallel/vocab_parallel.py``. The head
is split into tp column blocks [d, V/tp] on the mesh's "model" axis (the
tied embedding's vocabulary shard, transposed, is that block); the [n, V]
logits exist nowhere.

* ``_VPStats`` (JAX's ``_vp_stats`` custom_vjp): the forward runs the LM
  statistics on this rank's shard — K8 (``ops.lm_stats.lm_stats``) in mode
  "kernel", the plain vocab-chunked fold in mode "vocab" — and merges the
  shards' (lse, mean_x) over "model" (``_vp_merge``: a max and one sum,
  each shard's pair being an exact online-softmax partial with stabiliser
  lse and unit Σeˣ). The backward runs K9 (``lm_stats_bwd``), or the plain
  chunked backward, on the shard with the GLOBAL (lse, mean_x): each rank's
  logit cotangents need only its own shard, so it sends nothing; dhidden is
  this shard's part (``mpar_in`` on the hidden, upstream, sums the parts)
  and dW is exact for the shard.
* Mode "rows" (``_vp_rows_stats``) forms one row chunk's fp32 logits of the
  shard at a time, under ``torch.utils.checkpoint``, with the collectives
  inside the chunk: the legacy formulation and the cross-check.
* ``vp_label_logits``: the label column's logit by a masked local gather
  and a sum over "model".

The kernels take the head as rows of W.T [V/tp, d], contiguous: a tied
shard is the embedding's row block [V/tp, d] (``shard_params`` stores it
contiguous), an untied one a [d, V/tp] view of [V/tp, d] storage; a
contiguous [d, V/tp] head would be copied on each call. V/tp need not be a
multiple of K8's 256-column tile (Qwen3-0.6B at tp = 2: 75,968): the last
tile of a shard is ragged.

Under sequence parallelism (``vp_tree_loss_edges``,
``vp_tree_edge_logprobs_sp``) each "seq" rank holds n/sp rows of hidden
states; an edge's log-prob reads only its PARENT's row (the child gives its
token id, known on the host), so each rank evaluates the edges whose parent
it owns, from host-made (local parent, token, weight or child) triples. The
linear loss sums them on the rank (the step sums the ranks); the custom
loss scatters them to their child's global position and sums the vectors
over "seq" (``psum``), the entropies gathered whole (``fsdp_gather``: an
all-gather whose backward reduce-scatters).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from dynamictreeattn_tpu_torch.ops.lm_stats import lm_stats, lm_stats_bwd, lm_stats_bwd_plain, lm_stats_plain
from dynamictreeattn_tpu_torch.ops.losses import _vocab_chunk_width
from dynamictreeattn_tpu_torch.parallel.collectives import all_reduce_, const_pmax, fsdp_gather, mpar_out, psum

__all__ = ["vp_label_logits", "vp_position_stats", "vp_tree_edge_logprobs", "vp_tree_edge_logprobs_sp",
           "vp_tree_loss_edges", "vp_tree_loss_from_hidden"]


def _vp_local_stats(hidden, w_local, inv_temp: float, mode: str, vc: int):
    """This shard's (lse, mean_x)."""
    if mode == "kernel":
        return lm_stats(hidden, w_local, inv_temp)
    return lm_stats_plain(hidden, w_local, inv_temp, vocab_chunk=vc, row_chunk=max(hidden.shape[0], 1))


def _vp_merge(lse_l, mean_l, group):
    """Global (lse, mean_x) from the shards' (lse, mean_x)."""
    m_g = const_pmax(lse_l, group)
    w8 = torch.exp(lse_l - m_g)
    sums = all_reduce_(torch.stack([w8, mean_l * w8]), group)  # (Σeˣ, Σeˣ·x) over the shards
    return m_g + torch.log(sums[0]), sums[1] / sums[0]


class _VPStats(torch.autograd.Function):
    """(lse, entropy) fp32 [n] over the full vocabulary from this rank's
    shard: forward, shard statistics + merge; backward, shard-local."""

    @staticmethod
    def forward(ctx, hidden, w_local, inv_temp, group, mode, vc):
        lse, mean_x = _vp_merge(*_vp_local_stats(hidden, w_local, inv_temp, mode, vc), group)
        ctx.save_for_backward(hidden, w_local, lse, mean_x)
        ctx.inv_temp, ctx.mode, ctx.vc = inv_temp, mode, vc
        return lse, lse - mean_x

    @staticmethod
    def backward(ctx, g_lse, g_ent):
        hidden, w_local, lse, mean_x = ctx.saved_tensors
        if ctx.mode == "kernel":
            dh, dwT = lm_stats_bwd(hidden, w_local, lse, mean_x, g_lse, g_ent, ctx.inv_temp)
        else:
            dh, dwT = lm_stats_bwd_plain(hidden, w_local, lse, mean_x, g_lse, g_ent, ctx.inv_temp,
                                         vocab_chunk=ctx.vc)
        return dh, dwT.t(), None, None, None, None


def _vp_chunk_stats(h_chunk, w_local, inv_temp: float, group):
    logits = torch.matmul(h_chunk.float(), w_local.float()) * inv_temp  # [C, V/tp] fp32
    m = const_pmax(torch.amax(logits, dim=-1), group)
    ex = torch.exp(logits - m[:, None])
    se = mpar_out(torch.sum(ex, dim=-1), group)
    lse = m + torch.log(se)
    sx = mpar_out(torch.sum(ex * logits, dim=-1), group)
    return lse, lse - sx / se


def _vp_rows_stats(hidden, w_local, temperature: float, chunk_size: int, group):
    """The row-chunked formulation (mode "rows"): a chunk size that does
    not divide n is lowered until it does, as in JAX."""
    n = hidden.shape[0]
    c = min(chunk_size, n)
    while n % c:
        c -= 1
    inv_temp = 1.0 / temperature
    stats = [checkpoint(_vp_chunk_stats, h, w_local, inv_temp, group, use_reentrant=False)
             if torch.is_grad_enabled() else _vp_chunk_stats(h, w_local, inv_temp, group)
             for h in hidden.split(c)]
    return torch.cat([s[0] for s in stats]), torch.cat([s[1] for s in stats])


def vp_position_stats(hidden, w_local, temperature: float, chunk_size: int, mesh, axis: str = "model",
                      mode: str = "vocab"):
    """(lse [n], entropy [n]) fp32 with the head [d, V/tp] sharded on
    `axis`: mode "kernel" (K8 / K9 on the shard), "vocab" (the plain
    chunked fold) or "rows" (module docstring)."""
    group = mesh.group(axis)
    if mode == "rows":
        return _vp_rows_stats(hidden, w_local, temperature, chunk_size, group)
    if mode not in ("kernel", "vocab"):
        raise ValueError(f"unknown loss mode {mode!r}")
    vc = min(_vocab_chunk_width(w_local.shape[1], hidden.shape[0]), w_local.shape[1])
    return _VPStats.apply(hidden, w_local, 1.0 / temperature, group, mode, vc)


def vp_label_logits(h_at_parent, tokens, w_local, temperature: float, mesh, axis: str = "model"):
    """label_logit[j] = <h[parent[j]], W[:, token[j]]>/T with W sharded by
    vocabulary: each rank gathers the columns it holds, zero elsewhere, and
    the ranks' values are summed."""
    v_local = w_local.shape[1]
    off = mesh.rank(axis) * v_local
    in_range = (tokens >= off) & (tokens < off + v_local)
    local_tok = torch.clamp(tokens.long() - off, 0, v_local - 1)
    w_cols = w_local.t()[local_tok]  # [n, d]: advanced indexing, summed in a fixed order backward
    ll = torch.sum(h_at_parent.float() * w_cols.float(), dim=-1) / temperature
    return mpar_out(torch.where(in_range, ll, 0.0), mesh.group(axis))


def vp_tree_edge_logprobs(hidden, w_local, tokens, parent, temperature: float = 1.0, chunk_size: int = 1024,
                          mesh=None, axis: str = "model", mode: str = "vocab"):
    """(lp_edge [n], entropy [n]) fp32 over a vocab-sharded head; roots get 0."""
    lse, entropy = vp_position_stats(hidden, w_local, temperature, chunk_size, mesh, axis, mode)
    par = torch.clamp(parent.long(), min=0)
    label_logit = vp_label_logits(hidden[par], tokens, w_local, temperature, mesh, axis)
    lp_edge = torch.where(parent >= 0, label_logit - lse[par], 0.0)
    return lp_edge, entropy


def vp_tree_loss_from_hidden(hidden, w_local, tokens, parent, w_logprob, w_entropy, temperature: float = 1.0,
                             chunk_size: int = 1024, mesh=None, axis: str = "model", mode: str = "vocab"):
    """The sharded-head ``ops.losses.tree_loss_from_hidden``: (loss, aux),
    the loss the same on every rank of `axis`."""
    lp_edge, entropy = vp_tree_edge_logprobs(hidden, w_local, tokens, parent, temperature, chunk_size, mesh,
                                             axis, mode)
    sum_lp = torch.sum(w_logprob * lp_edge)
    sum_ent = torch.sum(w_entropy * entropy)
    return sum_lp + sum_ent, {"lp_edge": lp_edge, "entropy": entropy, "sum_logprob": sum_lp,
                              "sum_entropy": sum_ent}


def _owned_edges(hidden_local, w_local, edge_parent, edge_token, temperature, chunk_size, mesh, axis, mode):
    """(lp of the owned edges [E], entropy of the local rows [n_loc])."""
    lse, entropy = vp_position_stats(hidden_local, w_local, temperature, chunk_size, mesh, axis, mode)
    par = edge_parent.long()
    label_logit = vp_label_logits(hidden_local[par], edge_token, w_local, temperature, mesh, axis)
    return label_logit - lse[par], entropy


def vp_tree_edge_logprobs_sp(hidden_local, w_local, edge_parent, edge_token, edge_child, n_global: int,
                             temperature: float = 1.0, chunk_size: int = 1024, mesh=None, axis: str = "model",
                             seq_axis: str = "seq", mode: str = "vocab"):
    """(lp_edge [n_global], entropy [n_global]) fp32 under sequence
    parallelism, every rank of `seq_axis` holding the whole vectors: this
    rank's edges (local parent rows `edge_parent`, child tokens
    `edge_token`, GLOBAL child positions `edge_child`; a padding slot's
    child is n_global and lands in a spare row that is dropped) scattered to
    their children and summed over the ranks; the entropies of the ranks'
    row blocks gathered in order. Each rank's loss must carry 1/sp of the
    total (the step sums the ranks): the sum's backward sums the ranks'
    cotangents, which then equal the total's (JAX's psum transposing as
    itself)."""
    lp_own, ent_loc = _owned_edges(hidden_local, w_local, edge_parent, edge_token, temperature, chunk_size, mesh,
                                   axis, mode)
    lp_edge = torch.zeros(n_global + 1, dtype=torch.float32, device=lp_own.device)
    lp_edge = lp_edge.index_add(0, edge_child.long(), lp_own)[:n_global]
    group = mesh.group(seq_axis)
    return psum(lp_edge, group), fsdp_gather(ent_loc, group, 0)


def vp_tree_loss_edges(hidden_local, w_local, edge_parent, edge_token, edge_w, w_entropy_local,
                       temperature: float = 1.0, chunk_size: int = 1024, mesh=None, axis: str = "model",
                       mode: str = "vocab"):
    """The sequence-parallel trie loss on this rank's rows: (loss, aux) of
    the edges whose parent it owns (local parent rows `edge_parent`, child
    tokens `edge_token`, weights `edge_w`, 0 on padding slots) and its rows'
    entropy terms; the step sums the ranks over "seq". No hidden row leaves
    its rank."""
    lp_edge, entropy = _owned_edges(hidden_local, w_local, edge_parent, edge_token, temperature, chunk_size, mesh,
                                    axis, mode)
    sum_lp = torch.sum(edge_w * lp_edge)
    sum_ent = torch.sum(w_entropy_local * entropy)
    return sum_lp + sum_ent, {"sum_logprob": sum_lp, "sum_entropy": sum_ent}
