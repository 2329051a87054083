"""Functional PyTorch DeepSeek-V3 blocks (Moonlight-16B-A3B, DeepSeek-V3/R1,
Kimi-K2): latent attention (MLA) and the sigmoid-routed MoE with shared
experts, after a few leading dense layers.

No counterpart in the JAX package: this family runs in the port only. Layer
i < first_k_dense_replace: RMSNorm -> MLA -> residual -> RMSNorm -> SwiGLU
MLP of width ``intermediate_size`` -> residual; the rest put the MoE block
in the MLP's place. Then the final RMSNorm; the LM head (untied) is applied
by the losses, as for Qwen3.

MLA without a q LoRA (``modeling_deepseek.py``'s ``DeepseekV3Attention``
at ``q_lora_rank: null``), per layer and row h [n, d]:

* q = h Wq, [n, H, nope + rope]: q_nope, q_pe;
* [c, k_pe] = h Wkv_a: the latent c [n, kv_lora_rank] and one k_pe
  [n, rope] shared by every head; c <- RMSNorm(c);
* [k_nope, v] = c Wkv_b, [n, H, nope + v_head_dim];
* q_pe, k_pe rotated by RoPE in the published interleaved layout (pairs
  (2i, 2i + 1) at frequency i, ``apply_rope_interleaved``);
* q = [q_nope, q_pe], k = [k_nope, k_pe] (192 wide at Moonlight), v (128):
  tree attention at group 1, softmax scale (nope + rope) ** -0.5, then o Wo.

The latent path is plain tensor code under host spans ("mla.q",
"mla.latent", "mla.decompress", "mla.rope") and, while a step's parts are
collected, the device part "mla" (``utils.profiling.device_region``). The
attention is the engine's tree kernels at (192, 128) (``ops/tree_attention.py``
``KERNEL_SPLIT_DIMS``); the fused qk-prep kernels (per-head norm at one
head_dim) do not apply and are not used.

The MoE block (DeepSeek-V3's ``MoEGate`` at ``topk_method: noaux_tc`` with one
group, and ``DeepseekV3MoE``): sigmoid scores s of the fp32 router logits;
the top-k of s + e_score_correction_bias chosen (the bias selects only);
their weights s, renormalised over the k and times routed_scaling_factor
(``route``); the routed experts through the port's
capacity dispatch (``qwen3.moe_apply``, shared with Qwen3-MoE), plus the
shared experts as one SwiGLU of width n_shared_experts * moe_intermediate_size
for every row (span "moe.shared"). The bias is a buffer, not trained: it
lives in ``params["buffers"]["e_bias"]`` ([L_moe, E] fp32), which the engine
does not differentiate and the optimizer does not update
(``engine.tree_engine.trainable``). The model balances without an auxiliary
loss: its ``router_aux_coef`` is 0 and the block's load-balance term is 0.

Parameters: ``embed`` [V, d]; ``dense_layers`` and ``layers`` (the MoE
layers), each a stack on a leading axis, with ``ln1``, ``ln2``, ``wq``
[d, H (nope + rope)], ``wkv_a`` [d, kv_lora_rank + rope], ``kv_norm``
[kv_lora_rank], ``wkv_b`` [kv_lora_rank, H (nope + v)], ``wo`` [H v, d],
then ``gate``/``up``/``down`` (dense) or ``router``, ``e_gate``/``e_up``/
``e_down`` and the shared ``s_gate``/``s_up``/``s_down``; ``final_norm``;
``lm_head`` [d, V] (a view of [V, d] storage); ``buffers``.

Not supported for this family (each raises ``NotImplementedError``): the
rollout (``models/generate.py``: it needs a latent decode cache and a
grouped-decode kernel at the latent width), tensor, sequence and expert
parallelism, ZeRO-3 and the pipeline (``parallel/``).
"""

from __future__ import annotations

import dataclasses
import sys

import torch
import torch.nn.functional as F

from dynamictreeattn_tpu_torch.models.qwen3 import (
    BUFFERS, Qwen3Config, _dot, apply_rope, moe_apply, moe_capacity, rms_norm, rope_tables, run_layers,
)
from dynamictreeattn_tpu_torch.utils.profiling import counter, device_region, span

__all__ = ["DeepseekV3Config", "apply_rope_interleaved", "forward_hidden_aux", "init_params", "route"]


@dataclasses.dataclass(frozen=True)
class DeepseekV3Config(Qwen3Config):
    """A DeepSeek-V3 model (HF ``model_type: deepseek_v3``) with no q LoRA.
    Fields of ``Qwen3Config`` keep their meaning: ``intermediate_size`` is
    the leading dense layers' width, ``num_experts`` the routed experts
    (HF ``n_routed_experts``), ``num_hidden_layers`` every layer, dense and
    MoE; ``head_dim`` must be the q/k width qk_nope + qk_rope and
    ``num_key_value_heads`` the heads (MLA is group 1)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    head_dim: int = 192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    tie_word_embeddings: bool = False
    use_qk_norm: bool = False
    num_experts: int = 64
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    norm_topk_prob: bool = True
    router_aux_coef: float = 0.0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    scoring_func: str = "sigmoid"
    routed_scaling_factor: float = 2.446

    def __post_init__(self):
        if self.head_dim != self.qk_nope_head_dim + self.qk_rope_head_dim:
            raise ValueError(f"head_dim {self.head_dim} must be qk_nope_head_dim + qk_rope_head_dim "
                             f"({self.qk_nope_head_dim} + {self.qk_rope_head_dim})")
        if self.num_key_value_heads != self.num_attention_heads:
            raise ValueError("MLA has one k and v per head: num_key_value_heads must equal num_attention_heads")
        if self.scoring_func != "sigmoid" or self.num_experts <= 0:
            raise NotImplementedError(f"scoring_func {self.scoring_func!r} with {self.num_experts} experts: only "
                                      "the sigmoid-routed MoE (DeepSeek-V3, noaux_tc, one group) is ported")
        if self.use_qk_norm or self.attention_bias or self.rope_scaling is not None:
            raise NotImplementedError("MLA with a qk-norm, attention biases or rope scaling is not ported")
        if not 0 <= self.first_k_dense_replace <= self.num_hidden_layers:
            raise ValueError(f"first_k_dense_replace {self.first_k_dense_replace} outside 0..{self.num_hidden_layers}")

    @property
    def is_mla(self) -> bool:
        return True

    @property
    def family(self):
        return sys.modules[__name__]

    @property
    def attn_widths(self) -> tuple[int, int]:
        return self.head_dim, self.v_head_dim

    @property
    def shared_intermediate_size(self) -> int:
        return self.n_shared_experts * self.moe_intermediate_size


# ----------------------------------------------------------------------- params


def init_params(config: DeepseekV3Config, generator: torch.Generator, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights, N(0, 1/fan_in) projections and unit norms, drawn from
    `generator` on its device (the expert stacks one layer at a time, as
    ``qwen3.init_params``); the selection bias zero (an untrained router's)."""
    c = config
    d, H, r = c.hidden_size, c.num_attention_heads, c.kv_lora_rank
    dn, dr, dv = c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim
    Ld = c.first_k_dense_replace
    Lm = c.num_hidden_layers - Ld
    device = generator.device

    def norm(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def dense(fan_in, *shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        for part in out.reshape(-1, *shape[-2:]) if len(shape) > 2 else [out]:
            w = torch.randn(part.shape, generator=generator, device=device, dtype=torch.float32)
            part.copy_(w * fan_in**-0.5)
        return out

    def attention(L):
        return {"ln1": norm(L, d), "ln2": norm(L, d), "wq": dense(d, L, d, H * (dn + dr)),
                "wkv_a": dense(d, L, d, r + dr), "kv_norm": norm(L, r), "wkv_b": dense(r, L, r, H * (dn + dv)),
                "wo": dense(H * dv, L, H * dv, d)}

    I, E, Ie, Is = c.intermediate_size, c.num_experts, c.moe_intermediate_size, c.shared_intermediate_size
    dense_layers = attention(Ld)
    dense_layers.update(gate=dense(d, Ld, d, I), up=dense(d, Ld, d, I), down=dense(I, Ld, I, d))
    layers = attention(Lm)
    layers.update(router=dense(d, Lm, d, E), e_gate=dense(d, Lm, E, d, Ie), e_up=dense(d, Lm, E, d, Ie),
                  e_down=dense(Ie, Lm, E, Ie, d), s_gate=dense(d, Lm, d, Is), s_up=dense(d, Lm, d, Is),
                  s_down=dense(Is, Lm, Is, d))
    return {"embed": dense(d, c.vocab_size, d), "dense_layers": dense_layers, "layers": layers,
            "final_norm": norm(d), "lm_head": dense(d, c.vocab_size, d).t(),
            BUFFERS: {"e_bias": torch.zeros((Lm, E), dtype=torch.float32, device=device)}}


# ---------------------------------------------------------------------- forward


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE in the published interleaved layout: x [n, H, dr], pairs (2i,
    2i + 1) rotated at frequency i, the result in the de-interleaved order
    (the pairs' first elements, then their second), as ``modeling_deepseek.py``'s
    ``apply_rotary_pos_emb`` returns it; cos / sin [n, dr] of
    ``qwen3.rope_tables``."""
    dr = x.shape[-1]
    return apply_rope(x.unflatten(-1, (dr // 2, 2)).transpose(-1, -2).flatten(-2), cos, sin)


def _swiglu(h, gate, up, down, handoff):
    act = F.silu(_dot(h, gate, handoff).float()).to(h.dtype)
    return _dot(act * _dot(h, up, handoff), down, handoff)


def _mla_inputs(h: torch.Tensor, lp: dict, cos, sin, config: DeepseekV3Config, handoff):
    """Head-major (q [H, n, nope + rope], k [H, n, nope + rope], v [H, n,
    v_head_dim]) of one layer from its normed input h [n, d]."""
    c = config
    n, H, r = h.shape[0], c.num_attention_heads, c.kv_lora_rank
    dn, dr = c.qk_nope_head_dim, c.qk_rope_head_dim
    with span("mla.q"):
        q = _dot(h, lp["wq"], handoff).view(n, H, dn + dr)
    with span("mla.latent"):
        kv_a = _dot(h, lp["wkv_a"], handoff)
        latent = rms_norm(kv_a[:, :r], lp["kv_norm"], c.rms_norm_eps)
    with span("mla.decompress"):
        kv = _dot(latent, lp["wkv_b"], handoff).view(n, H, dn + c.v_head_dim)
    with span("mla.rope"):
        q_pe = apply_rope_interleaved(q[..., dn:], cos, sin)
        k_pe = apply_rope_interleaved(kv_a[:, None, r:], cos, sin)
        q = torch.cat([q[..., :dn], q_pe], dim=-1).transpose(0, 1)
        k = torch.cat([kv[..., :dn], k_pe.expand(n, H, dr)], dim=-1).transpose(0, 1)
        return q, k, kv[..., dn:].transpose(0, 1)


def route(h: torch.Tensor, router: torch.Tensor, bias: torch.Tensor, config: DeepseekV3Config, valid=None,
          handoff=None):
    """(w [n, k] fp32, idx [n, k] int64, lb): DeepSeek-V3's router
    (``MoEGate``, ``noaux_tc`` with one group) for a layer's selection bias
    [E]: s = sigmoid of the fp32 logits; idx the top-k of s + bias (the bias
    selects, ties ordered as ``torch.topk`` orders them); w the chosen s,
    renormalised over the k when ``norm_topk_prob`` (over their sum + 1e-20,
    as published), times ``routed_scaling_factor``. Padding rows (`valid`)
    get idx = E; lb is 0 (the model has no auxiliary loss). While a step's
    parts are collected, "moe.bias_moved" counts the real rows' (row,
    choice) pairs whose expert is not among the row's top-k of s alone."""
    c = config
    E, k = c.num_experts, c.num_experts_per_tok
    scores = torch.sigmoid(_dot(h.float(), router.float(), handoff))  # [n, E] fp32
    idx = torch.topk(scores + bias.float(), k, dim=-1).indices
    w = torch.gather(scores, 1, idx)
    if c.norm_topk_prob:
        w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-20)
    w = w * c.routed_scaling_factor
    parts = counter()
    if parts is not None:  # saves nothing for the backward: the recompute counts nothing again
        with torch.no_grad():
            plain = torch.topk(scores, k, dim=-1).indices
            moved = ~(idx[:, :, None] == plain[:, None, :]).any(-1)  # [n, k]
            if valid is not None:
                moved = moved & (valid[:, None] > 0)
            parts.count("moe.bias_moved", moved.sum())
    if valid is not None:
        idx = torch.where(valid[:, None] > 0, idx, E)
    return w, idx, torch.zeros((), dtype=torch.float32, device=h.device)


def _moe_block(h: torch.Tensor, lp: dict, config: DeepseekV3Config, valid=None, capacity: int | None = None,
               handoff=None):
    """(y [n, d], lb): the routed experts through the capacity dispatch plus
    the shared experts; lb is 0 (no auxiliary loss)."""
    with span("moe.route"):
        w, idx, lb = route(h, lp["router"], lp["e_bias"], config, valid, handoff)
    if capacity is None:
        capacity = moe_capacity(config, h.shape[0])
    y = moe_apply(h, lp["e_gate"], lp["e_up"], lp["e_down"], idx, w, capacity)
    with span("moe.shared"):
        return y + _swiglu(h, lp["s_gate"], lp["s_up"], lp["s_down"], handoff), lb


def _layer(x, lp, cos, sin, config: DeepseekV3Config, attn_fn, fused_qk: bool = False, handoff=None, valid=None,
           capacity: int | None = None):
    """One layer (``qwen3._layer``'s signature): (x, lb), lb None for a
    dense layer. `fused_qk` is not read (no qk-prep at MLA's widths)."""
    c = config
    n = x.shape[0]
    h = rms_norm(x, lp["ln1"], c.rms_norm_eps)
    qkv = device_region("mla", lambda h: _mla_inputs(h, lp, cos, sin, c, handoff), h)
    o = attn_fn(*qkv, handoff=handoff) if handoff is not None and handoff.attn else attn_fn(*qkv)
    x = x + _dot(o.transpose(0, 1).reshape(n, c.num_attention_heads * c.v_head_dim), lp["wo"], handoff)
    h = rms_norm(x, lp["ln2"], c.rms_norm_eps)
    if "router" in lp:  # its device time is part "moe" while a step's parts are collected
        y, lb = device_region("moe", lambda h: _moe_block(h, lp, c, valid, capacity, handoff), h)
        return x + y, lb
    return x + _swiglu(h, lp["gate"], lp["up"], lp["down"], handoff), None


def forward_hidden_aux(params: dict, config: DeepseekV3Config, tokens: torch.Tensor, positions: torch.Tensor,
                       attn_fn, remat: bool = False, remat_policy: str | None = None, remat_segments: int = 0,
                       fused_qk: bool = False, valid=None):
    """(hidden [n, d], aux) as ``qwen3.forward_hidden_aux``: the dense stack,
    then the MoE stack (each through ``qwen3.run_layers``, so with the same
    remat policies; `remat_segments` must divide each stack), then the final
    norm; aux["lb_loss"] is 0."""
    c = config
    x = params["embed"][tokens.long()]
    cos, sin = rope_tables(positions, c.qk_rope_head_dim, c.rope_theta)
    kw = dict(remat=remat, remat_policy=remat_policy, remat_segments=remat_segments, fused_qk=fused_qk,
              valid=valid, layer_fn=_layer)
    if c.first_k_dense_replace:
        x, _ = run_layers(x, params["dense_layers"], c, cos, sin, attn_fn, **kw)
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    if c.num_hidden_layers > c.first_k_dense_replace:
        x, lb = run_layers(x, dict(params["layers"], e_bias=params[BUFFERS]["e_bias"]), c, cos, sin, attn_fn, **kw)
    return rms_norm(x, params["final_norm"], c.rms_norm_eps), {"lb_loss": lb}
