"""The tensor-parallel Qwen3 forward on this rank's shards.

Counterpart of ``dynamictreeattn_tpu/parallel/tp_model.py``. Megatron
partitioning over the mesh's "model" axis:

* embedding: vocabulary-sharded rows, a masked local gather + ``mpar_out``;
* attention: heads sharded, each rank's q heads with their kv heads (GQA
  co-located: no communication inside attention); the rank runs the port's
  own kernels — K4/K5 qk-prep, K1/K2 forward, K3/K10/K11/K12 backward,
  K6/K7 — on its LOCAL heads, whose work lists ``TreeEngine.prepare`` sizes
  for the local kv-head count (the engine holds ``local_config``); o_proj
  row-sharded, then ``mpar_out``;
* MLP: gate/up column-sharded, down row-sharded, then ``mpar_out``;
* MoE: the router replicated; the experts sharded over "model"
  (``_moe_block_ep``), or, with expert parallelism over "data", exchanged
  by token all-to-all (``_moe_block_ep_a2a``);
* norms replicated (fp32 math).

Sequence parallelism over "seq" (sp > 1): each rank holds n/sp rows of the
packed trie. Ulysses trades the row shard for a kv-head shard with three
all-to-alls (GQA groups ride with their kv head), runs the attention on the
full sequence with hkv/(tp·sp) kv heads, and trades back with a fourth; it
keeps the unfused qk-prep chain, as in JAX. The ring keeps the rows and
rotates K/V inside its attention (``ops/tree_attention_ring.py``). A MoE
layer pools its load-balance statistics over "seq" and returns lb/sp, so
that the step's sum over "seq" is the unsharded term.

ZeRO-3 (FSDP): `unshard_fn` gathers a layer's shards over "data" at the top
of the layer, inside its checkpoint, so the recompute gathers again and no
gathered weight is kept between forward and backward.

The layers run under the single-device model's remat machinery
(``models.qwen3.forward_hidden_aux`` with this module's layer and
embedding): policies None / "dots" / "attn" / "attn_dots" and nested
segments hand their kept values over as they do on one device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from dynamictreeattn_tpu_torch.models.qwen3 import (
    Qwen3Config, _Combine, _Dispatch, _dot, attention_inputs, forward_hidden_aux, moe_apply, moe_capacity,
    moe_route, pack_pairs, rms_norm,
)
from dynamictreeattn_tpu_torch.ops.fused_norm_act import swiglu
from dynamictreeattn_tpu_torch.parallel.collectives import all_to_all, mpar_in, mpar_out
from dynamictreeattn_tpu_torch.utils.profiling import counter

__all__ = ["forward_hidden_tp", "local_config", "tp_param_shard_info"]


def tp_param_shard_info(config: Qwen3Config, tp: int) -> dict:
    """Which dims shard, per rank; raises if the config can't shard tp-ways."""
    c = config
    if c.num_key_value_heads % tp:
        raise ValueError(f"kv heads {c.num_key_value_heads} not divisible by {tp=}")
    if c.vocab_size % tp:
        raise ValueError("vocab not divisible by tp")
    info = {
        "local_q_heads": c.num_attention_heads // tp,
        "local_kv_heads": c.num_key_value_heads // tp,
        "local_vocab": c.vocab_size // tp,
    }
    if c.is_moe:
        if c.num_experts % tp:
            raise ValueError(f"experts {c.num_experts} not divisible by {tp=}")
        info["local_experts"] = c.num_experts // tp
    else:
        if c.intermediate_size % tp:
            raise ValueError("intermediate not divisible by tp")
        info["local_intermediate"] = c.intermediate_size // tp
    return info


def local_config(config: Qwen3Config, tp: int) -> Qwen3Config:
    """The config of one rank's attention: hq/tp q heads, hkv/tp kv heads
    (the rest, the vocabulary and the expert count included, unchanged: the
    layers read those from the shards' shapes)."""
    if tp == 1:
        return config
    return dataclasses.replace(config, num_attention_heads=config.num_attention_heads // tp,
                               num_key_value_heads=config.num_key_value_heads // tp)


def _embed_vp(embed_local, tokens, mesh):
    v_local = embed_local.shape[0]
    off = mesh.rank("model") * v_local
    in_range = (tokens >= off) & (tokens < off + v_local)
    local_tok = torch.clamp(tokens.long() - off, 0, v_local - 1)
    x = torch.where(in_range[:, None], embed_local[local_tok], 0)
    return mpar_out(x, mesh.group("model"))


def _layer_tp(x, lp, cos, sin, config: Qwen3Config, attn_fn, fused_qk: bool = False, handoff=None, valid=None,
              *, mesh, ep: int = 1, sp: int = 1, sp_mode: str = "ulysses", unshard_fn=None):
    """One layer on this rank's shards: (x, lb); `config` is the rank's
    ``local_config``. ``models.qwen3._layer``'s signature up to `valid`, the
    mesh bound (module docstring for `sp`, `sp_mode`, `unshard_fn`)."""
    c = config
    g = mesh.group("model")
    n = x.shape[0]
    if unshard_fn is not None:
        lp = unshard_fn(lp)
    h = mpar_in(rms_norm(x, lp["ln1"], c.rms_norm_eps), g)
    ulysses = sp > 1 and sp_mode == "ulysses"
    qkv = attention_inputs(h, lp, cos, sin, c, fused_qk and not ulysses, handoff)
    if ulysses:
        o = _attention_ulysses(*qkv, c, attn_fn, handoff, mesh.group("seq"), sp)
    else:
        o = attn_fn(*qkv, handoff=handoff) if handoff is not None and handoff.attn else attn_fn(*qkv)
        o = o.transpose(0, 1).reshape(n, c.num_attention_heads * c.head_dim)
    x = x + mpar_out(_dot(o, lp["wo"], handoff), g)
    return _layer_tp_mlp(x, lp, c, mesh, ep, valid, handoff, sp)


def _attention_ulysses(q, k, v, c: Qwen3Config, attn_fn, handoff, group, sp: int):
    """o [n, hq_l·dh] of this rank's rows: q [hq_l, n, dh] and k, v
    [hkv_l, n, dh] all-to-all'd over "seq" from the row shard to a kv-head
    shard (the group heads of a kv head ride with it), the attention on the
    full sequence with hkv_l/sp kv heads, and its output all-to-all'd back
    (JAX ``_layer_tp``'s Ulysses branch)."""
    hq, n, dh = q.shape
    hkv = k.shape[0]
    grp, h_s = hq // hkv, hkv // sp

    def to_heads(t, heads):  # [heads·x, n, dh] -> [x, sp·n, dh]: the kv-head blocks to their ranks
        t = t.reshape(sp, heads // sp, n, dh)
        return all_to_all(t, group).transpose(0, 1).reshape(heads // sp, sp * n, dh)

    qf, kf, vf = to_heads(q, hq), to_heads(k, hkv), to_heads(v, hkv)  # q's heads are kv-major
    o = attn_fn(qf, kf, vf, handoff=handoff) if handoff is not None and handoff.attn else attn_fn(qf, kf, vf)
    # [h_s·grp, sp·n, dh] -> this rank's rows of every head: rank j's rows to rank j
    o = all_to_all(o.reshape(h_s * grp, sp, n, dh).transpose(0, 1), group)  # [sp (head block), h_s·grp, n, dh]
    return o.reshape(hq, n, dh).transpose(0, 1).reshape(n, hq * dh)


def _layer_tp_mlp(x, lp, c: Qwen3Config, mesh, ep: int, valid, handoff, sp: int = 1):
    g = mesh.group("model")
    h_norm = rms_norm(x, lp["ln2"], c.rms_norm_eps)
    if c.is_moe:
        # every seq rank routes a slice of one trie: the load-balance
        # statistics are pooled over "seq" and each rank returns lb/sp, so
        # that the step's sum over "seq" is the unsharded term
        stat_groups = (mesh.group("seq"),) if sp > 1 else ()
        if ep > 1:
            x, lb = _moe_block_ep_a2a(x, h_norm, lp, c, mesh, ep, valid, handoff, stat_groups)
        else:
            x, lb = _moe_block_ep(x, h_norm, lp, c, mesh, valid, handoff, stat_groups)
        return x, (lb / sp if sp > 1 else lb)
    h = mpar_in(h_norm, g)
    act = swiglu(_dot(h, lp["gate"], handoff), _dot(h, lp["up"], handoff))
    return x + mpar_out(_dot(act, lp["down"], handoff), g), None


def _moe_block_ep(x, h_norm, lp, c: Qwen3Config, mesh, valid=None, handoff=None, stat_groups=()):
    """Experts sharded over "model", activations replicated: every rank
    routes all rows (the router is small, so no routing collective),
    dispatches the pairs of the experts it holds at the one-device capacity,
    and the partial outputs are summed (``mpar_out``). The combine weights
    pass ``mpar_in``: each rank's w-cotangent covers its own experts only;
    the load-balance path is replicated, so already full. Each model rank
    counts the pairs of its own experts (``moe_apply``), so the counters
    summed over "model" count every pair once."""
    g = mesh.group("model")
    w, idx, lb = moe_route(h_norm, lp["router"], c, valid, handoff, groups=stat_groups)
    cap = moe_capacity(c, h_norm.shape[0])
    e_off = mesh.rank("model") * lp["e_gate"].shape[0]
    y = moe_apply(mpar_in(h_norm, g), lp["e_gate"], lp["e_up"], lp["e_down"], idx - e_off, mpar_in(w, g), cap)
    return x + mpar_out(y, g).to(x.dtype), lb


def ep_capacity(c: Qwen3Config, n: int, ep: int) -> tuple[int, int]:
    """(C, local capacity) of the all-to-all dispatch for n rows a rank:
    C = ceil(factor · n·k / ep) pairs sent to each data rank (the same on
    every rank: the tries share one padded length, and the all-to-all needs
    equal splits), and ceil(factor · ep·n·k / E) pairs a received expert
    keeps (JAX ``_moe_block_ep_a2a``)."""
    nk = n * c.num_experts_per_tok
    return (int(math.ceil(c.moe_capacity_factor * nk / ep)),
            int(math.ceil(c.moe_capacity_factor * ep * nk / c.num_experts)))


def ep_dispatch(idx, ep: int, e_owned: int, C: int):
    """The pairs a rank sends: ``pack_pairs`` of each pair's destination
    data rank (idx // e_owned; a padding row's idx E goes nowhere) at
    capacity C, the stable sort keeping each destination's pairs in
    row-major order, so the drops past C are deterministic. Returns
    pack_pairs' five tensors and the local expert id of each send slot
    (-1 where unfilled)."""
    dest = torch.div(idx, e_owned, rounding_mode="floor")
    slot, keep, tok_of_slot, pair_of_slot, filled = pack_pairs(dest, ep, C)
    base = torch.div(torch.arange(ep * C, device=idx.device), C, rounding_mode="floor") * e_owned
    send_e = torch.where(filled, idx.reshape(-1)[pair_of_slot] - base, -1)
    return slot, keep, tok_of_slot, pair_of_slot, filled, send_e


def _moe_block_ep_a2a(x, h_norm, lp, c: Qwen3Config, mesh, ep: int, valid=None, handoff=None, stat_groups=()):
    """Expert parallelism over "data" by token all-to-all, composed with
    expert sharding over "model": expert e lives on data rank e // (E/ep),
    model rank (e % (E/ep)) // (E/(ep·tp)). Each rank routes its own rows
    (router replicated over "model"), packs the (row, choice) pairs bound
    for each data rank into [ep, C, d] (``ep_dispatch``), exchanges rows and
    local expert ids, runs its experts on the received set at the local
    capacity (partial over "model", summed), sends the outputs back and
    combines them with the weights it kept. The dispatch and the combine
    are the one-device pair <-> slot gathers (``_Dispatch``, ``_Combine``);
    the all-to-all's backward is the reverse exchange. Each expert has one
    owner, so its grads are exact on that rank (the step does not sum them
    over "data"). Counters: a pair dropped at the send counts as a pair and
    a drop at its source (on model rank 0, as every model rank sends the
    same pairs); a sent pair counts where it is received (``moe_apply``),
    so the counters summed over the mesh count every pair once."""
    gd, gm = mesh.group("data"), mesh.group("model")
    n = h_norm.shape[0]
    e_owned = c.num_experts // ep
    w, idx, lb = moe_route(h_norm, lp["router"], c, valid, handoff, groups=stat_groups)
    C, cap_local = ep_capacity(c, n, ep)
    slot, keep, tok_of_slot, pair_of_slot, filled, send_e = ep_dispatch(idx, ep, e_owned, C)
    parts = counter()
    if parts is not None and mesh.rank("model") == 0:
        unsent = ((idx >= 0) & (idx < c.num_experts)).sum() - keep.sum()
        parts.count("moe.pairs", unsent)
        parts.count("moe.dropped", unsent)
    recv_x = all_to_all(_Dispatch.apply(h_norm, tok_of_slot, filled, slot, keep), gd)  # [ep*C, d]
    recv_e = all_to_all(send_e, gd)
    m_off = mesh.rank("model") * lp["e_gate"].shape[0]
    ones = torch.ones((recv_x.shape[0], 1), dtype=torch.float32, device=x.device)
    y = moe_apply(mpar_in(recv_x, gm), lp["e_gate"], lp["e_up"], lp["e_down"], (recv_e - m_off)[:, None], ones,
                  cap_local)  # off-rank and unfilled (-1) entries skipped; weights applied at the source
    y_back = all_to_all(mpar_out(y, gm), gd)
    wk = w.to(torch.promote_types(w.dtype, torch.float32)) * keep
    out = _Combine.apply(y_back, wk, slot, tok_of_slot, pair_of_slot, filled)
    return x + out.to(x.dtype), lb


def forward_hidden_tp(params_local: dict, config: Qwen3Config, tokens, positions, attn_fn, mesh,
                      remat: bool = False, remat_policy: str | None = None, remat_segments: int = 0,
                      ep: int = 1, valid=None, fused_qk: bool = False, unshard_fn=None, sp: int = 1,
                      sp_mode: str = "ulysses"):
    """(hidden [n, d], aux) like ``models.qwen3.forward_hidden_aux``, on
    this rank's shards (`config` the full model's). `attn_fn` takes the
    LOCAL heads: with Ulysses (sp > 1) the full sequence on hq/(tp·sp) q
    heads, else this rank's rows (the ring rotates inside it). With sp > 1
    `tokens`, `positions` and `valid` are this rank's rows. `unshard_fn`
    maps one layer's params to their gathered form (FSDP, module
    docstring). The hidden passes a final ``mpar_in``: the vocab-parallel
    loss gives each rank the cotangent of its vocabulary shard only."""
    tp = mesh.size("model")
    if sp_mode not in ("ulysses", "ring"):
        raise ValueError(f"unknown sp_mode {sp_mode!r}")
    hidden, aux = forward_hidden_aux(
        params_local, local_config(config, tp), tokens, positions, attn_fn, remat=remat,
        remat_policy=remat_policy, remat_segments=remat_segments, fused_qk=fused_qk, valid=valid,
        layer_fn=functools.partial(_layer_tp, mesh=mesh, ep=ep, sp=sp, sp_mode=sp_mode, unshard_fn=unshard_fn),
        embed_fn=functools.partial(_embed_vp, mesh=mesh) if tp > 1 else None,
    )
    return mpar_in(hidden, mesh.group("model")), aux
