"""The tensor-parallel Qwen3 forward on this rank's shards.

Counterpart of ``dynamictreeattn_tpu/parallel/tp_model.py`` (its
sequence-parallel branches wait for ROADMAP queue 1 item 10, leg (f)).
Megatron partitioning over the mesh's "model" axis:

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
import torch.nn.functional as F

from dynamictreeattn_tpu_torch.models.qwen3 import (
    Qwen3Config, _Combine, _Dispatch, _dot, attention_inputs, forward_hidden_aux, moe_apply, moe_capacity,
    moe_route, pack_pairs, rms_norm,
)
from dynamictreeattn_tpu_torch.parallel.collectives import all_to_all, mpar_in, mpar_out

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
              *, mesh, ep: int = 1):
    """One layer on this rank's shards: (x, lb); `config` is the rank's
    ``local_config``. ``models.qwen3._layer``'s signature up to `valid`, the
    mesh bound."""
    c = config
    g = mesh.group("model")
    n = x.shape[0]
    h = mpar_in(rms_norm(x, lp["ln1"], c.rms_norm_eps), g)
    qkv = attention_inputs(h, lp, cos, sin, c, fused_qk, handoff)
    o = attn_fn(*qkv, handoff=handoff) if handoff is not None and handoff.attn else attn_fn(*qkv)
    o = o.transpose(0, 1).reshape(n, c.num_attention_heads * c.head_dim)
    x = x + mpar_out(_dot(o, lp["wo"], handoff), g)
    return _layer_tp_mlp(x, lp, c, mesh, ep, valid, handoff)


def _layer_tp_mlp(x, lp, c: Qwen3Config, mesh, ep: int, valid, handoff):
    g = mesh.group("model")
    h_norm = rms_norm(x, lp["ln2"], c.rms_norm_eps)
    if c.is_moe:
        if ep > 1:
            return _moe_block_ep_a2a(x, h_norm, lp, c, mesh, ep, valid, handoff)
        return _moe_block_ep(x, h_norm, lp, c, mesh, valid, handoff)
    h = mpar_in(h_norm, g)
    act = F.silu(_dot(h, lp["gate"], handoff).float()).to(h.dtype)
    return x + mpar_out(_dot(act * _dot(h, lp["up"], handoff), lp["down"], handoff), g), None


def _moe_block_ep(x, h_norm, lp, c: Qwen3Config, mesh, valid=None, handoff=None):
    """Experts sharded over "model", activations replicated: every rank
    routes all rows (the router is small, so no routing collective),
    dispatches the pairs of the experts it holds at the one-device capacity,
    and the partial outputs are summed (``mpar_out``). The combine weights
    pass ``mpar_in``: each rank's w-cotangent covers its own experts only;
    the load-balance path is replicated, so already full."""
    g = mesh.group("model")
    w, idx, lb = moe_route(h_norm, lp["router"], c, valid, handoff)
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


def _moe_block_ep_a2a(x, h_norm, lp, c: Qwen3Config, mesh, ep: int, valid=None, handoff=None):
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
    over "data")."""
    gd, gm = mesh.group("data"), mesh.group("model")
    n = h_norm.shape[0]
    e_owned = c.num_experts // ep
    w, idx, lb = moe_route(h_norm, lp["router"], c, valid, handoff)
    C, cap_local = ep_capacity(c, n, ep)
    slot, keep, tok_of_slot, pair_of_slot, filled, send_e = ep_dispatch(idx, ep, e_owned, C)
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
                      ep: int = 1, valid=None, fused_qk: bool = False):
    """(hidden [n, d], aux) like ``models.qwen3.forward_hidden_aux``, on
    this rank's shards (`config` the full model's). `attn_fn` takes the
    LOCAL heads. The hidden passes a final ``mpar_in``: the vocab-parallel
    loss gives each rank the cotangent of its vocabulary shard only."""
    tp = mesh.size("model")
    hidden, aux = forward_hidden_aux(
        params_local, local_config(config, tp), tokens, positions, attn_fn, remat=remat,
        remat_policy=remat_policy, remat_segments=remat_segments, fused_qk=fused_qk, valid=valid,
        layer_fn=functools.partial(_layer_tp, mesh=mesh, ep=ep),
        embed_fn=functools.partial(_embed_vp, mesh=mesh) if tp > 1 else None,
    )
    return mpar_in(hidden, mesh.group("model")), aux
