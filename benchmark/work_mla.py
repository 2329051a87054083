"""The work of a DeepSeek-V3 (MLA) configuration's layers, counted from the
sequences (``work.trie_work``) and the published configuration (HF
``deepseek_v3`` keys), never from the program's padded layout.

* ``mla_attn_fwd_work`` / ``mla_attn_bwd_work``: one layer's tree attention
  at MLA's widths, q . k over dqk = nope + rope and p v over dv: forward
  2 * H * (dqk + dv) flops a visible pair; backward the five products (S,
  dP, dV, dK, dQ) 2 * H * (dqk + dv + dv + dqk + dqk); each input byte read
  once, each output byte written once;
* ``mla_lm_fwd_work`` / ``mla_lm_bwd_work``: the LM-head statistics
  kernels (K8, K9) over the trie's tokens, as ``work.lm_fwd_work`` /
  ``work.lm_bwd_work`` count them, from this configuration's d and V;
* ``mla_train_flops``: the model FLOPs of a training step over a trie, as
  ``work.train_flops`` counts them (6 a parameter and token, no recompute),
  for this architecture: the MLA projections, the leading dense MLP, the
  router, k routed experts and the shared experts, the LM head, and
  attention at 3x its forward per pair.
"""

from __future__ import annotations

from work import BF16


def mla_dims(cfg: dict) -> dict:
    H, dn, dr = cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    return dict(d=cfg["hidden_size"], H=H, r=cfg["kv_lora_rank"], dn=dn, dr=dr, dqk=dn + dr, dv=cfg["v_head_dim"],
                V=cfg["vocab_size"], I=cfg["intermediate_size"], E=cfg["n_routed_experts"],
                k=cfg["num_experts_per_tok"], Ie=cfg["moe_intermediate_size"],
                Is=cfg["n_shared_experts"] * cfg["moe_intermediate_size"], L=cfg["num_hidden_layers"],
                Ld=cfg["first_k_dense_replace"])


def mla_attn_fwd_work(cfg: dict, nodes: int, pairs: int) -> tuple[float, float]:
    """One layer's forward: q, k (dqk) and v (dv) read once, o (dv, bf16)
    and lse (fp32) written once, last_desc read once."""
    m = mla_dims(cfg)
    H, dqk, dv = m["H"], m["dqk"], m["dv"]
    flops = 2.0 * H * (dqk + dv) * pairs
    nbytes = BF16 * H * nodes * (2 * dqk + 2 * dv) + 4 * H * nodes + 4 * nodes
    return flops, nbytes


def mla_attn_bwd_work(cfg: dict, nodes: int, pairs: int) -> tuple[float, float]:
    """One layer's backward, counted once as the fused pass needs it: q, k,
    v, do read once, lse and di read once, dq, dk, dv written once (bf16),
    last_desc read once."""
    m = mla_dims(cfg)
    H, dqk, dv = m["H"], m["dqk"], m["dv"]
    flops = 2.0 * H * (3 * dqk + 2 * dv) * pairs
    nbytes = (BF16 * H * nodes * (2 * dqk + 2 * dv) + 8 * H * nodes + 4 * nodes
              + BF16 * H * nodes * (2 * dqk + dv))
    return flops, nbytes


def mla_lm_fwd_work(cfg: dict, nodes: int) -> tuple[float, float]:
    """K8: the [n, V] logits' product; hidden and head read once, (lse,
    mean) written once."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    return 2.0 * nodes * d * V, BF16 * nodes * d + BF16 * d * V + 8 * nodes


def mla_lm_bwd_work(cfg: dict, nodes: int) -> tuple[float, float]:
    """K9: the logits again and the two grad products (3x the forward's);
    hidden, head and the three fp32 row vectors read once, dhidden and
    dhead written once."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    return 6.0 * nodes * d * V, 2 * BF16 * nodes * d + 2 * BF16 * d * V + 12 * nodes


def mla_layer_params(cfg: dict) -> tuple[float, float]:
    """(dense layer, MoE layer) active matrix parameters a token: the MLA
    projections and the dense MLP, or the router, k routed experts and the
    shared experts."""
    m = mla_dims(cfg)
    d, H = m["d"], m["H"]
    attn = d * H * m["dqk"] + d * (m["r"] + m["dr"]) + m["r"] * H * (m["dn"] + m["dv"]) + H * m["dv"] * d
    dense = attn + 3 * d * m["I"]
    moe = attn + d * m["E"] + m["k"] * 3 * d * m["Ie"] + 3 * d * m["Is"]
    return dense, moe


def mla_train_flops(cfg: dict, nodes: int, pairs: int) -> float:
    """Model FLOPs of one training step over a trie: forward and backward (6
    a parameter and token) of every layer's active parameters and of the LM
    head, and attention at 3x its forward per visible pair and layer. No
    recompute is counted."""
    m = mla_dims(cfg)
    dense, moe = mla_layer_params(cfg)
    params = m["Ld"] * dense + (m["L"] - m["Ld"]) * moe + m["d"] * m["V"]
    attn = 3 * 2.0 * m["H"] * (m["dqk"] + m["dv"]) * pairs * m["L"]
    return 6.0 * nodes * params + attn
