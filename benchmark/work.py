"""The work each layer needs, counted from the sequences and the published
configuration, never from the program's padded layout.

* ``trie_work``: the distinct prefixes of a batch (the trie's tokens) and
  the visible (query, key) pairs among them: each trie token sees its
  ancestors and itself.
* per-launch operations and bytes of the kernel layers (tree attention,
  qk-prep, LM-head statistics, grouped decode attention): each input byte
  read once, each output byte written once;
* model FLOPs of a training step and the roofline of a rollout;
* the H100's published dense peaks and the kernel-name -> layer map.

A config here is the dict of a ``configs/*.json`` file (Hugging Face key
names).
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: operations or bytes at peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ------------------------------------------------------------------ sequences


def trie_work(seqs) -> tuple[int, int]:
    """(trie tokens, visible pairs) of a batch of token sequences. In
    lexicographic order a sequence shares with all earlier ones exactly its
    longest common prefix with the one before it, so its new tokens are
    those past that prefix; the token at depth t sees t + 1 tokens."""
    order = sorted(range(len(seqs)), key=lambda i: np.asarray(seqs[i]).tolist())
    nodes = pairs = 0
    prev = None
    for i in order:
        s = np.asarray(seqs[i])
        lcp = 0
        if prev is not None:
            m = min(len(s), len(prev))
            ne = np.nonzero(s[:m] != prev[:m])[0]
            lcp = int(ne[0]) if len(ne) else m
        L = len(s)
        nodes += L - lcp
        pairs += (L * (L + 1) - lcp * (lcp + 1)) // 2
        prev = s
    return nodes, pairs


# ------------------------------------------------------------------- model


def dims(cfg: dict) -> dict:
    d, dh = cfg["hidden_size"], cfg["head_dim"]
    return dict(d=d, dh=dh, hq=cfg["num_attention_heads"], hkv=cfg["num_key_value_heads"],
                L=cfg["num_hidden_layers"], V=cfg["vocab_size"], E=cfg.get("num_experts", 0),
                k=cfg.get("num_experts_per_tok", 0), Ie=cfg.get("moe_intermediate_size", 0),
                I=cfg["intermediate_size"])


def layer_params(cfg: dict, experts_read: float | None = None) -> tuple[float, float]:
    """(active, stored) matrix parameters of one layer: the attention
    projections and the MLP, or the router and k experts (active) of E
    (stored). `experts_read` replaces k in the active count (a decode step
    reads every expert some row chose)."""
    m = dims(cfg)
    attn = m["d"] * (m["hq"] + 2 * m["hkv"]) * m["dh"] + m["hq"] * m["dh"] * m["d"]
    if m["E"]:
        per_expert = 3 * m["d"] * m["Ie"]
        k = m["k"] if experts_read is None else experts_read
        return attn + m["d"] * m["E"] + k * per_expert, attn + m["d"] * m["E"] + m["E"] * per_expert
    mlp = 3 * m["d"] * m["I"]
    return attn + mlp, attn + mlp


def train_flops(cfg: dict, nodes: int, pairs: int) -> float:
    """Model FLOPs of one training step over a trie: forward and backward
    (6 per parameter and token) of every layer's active parameters and of
    the LM head, and attention at 4*dh*hq per visible pair forward and
    twice that backward. No recompute is counted."""
    m = dims(cfg)
    active, _ = layer_params(cfg)
    dense = 6.0 * nodes * (m["L"] * active + m["d"] * m["V"])
    attn = 12.0 * m["dh"] * m["hq"] * pairs * m["L"]
    return dense + attn


def rollout_bound_s(cfg: dict, plens, group: int, max_new: int) -> float:
    """The least time one grouped rollout could take on the chip: the sum
    over the prefills (one a prompt) and the decode steps of max(FLOPs /
    peak, bytes / peak). A prefill reads the weights once and writes its
    prompt's K/V; a decode step reads the weights once (a MoE layer the
    experts some row chose) and the K/V every row must see, and writes
    each row's new K/V."""
    m = dims(cfg)
    L, d, dh, hq, hkv, V = m["L"], m["d"], m["dh"], m["hq"], m["hkv"], m["V"]
    kv_tok = 2 * hkv * dh * BF16 * L  # K and V of one token over all layers
    head = d * V
    total = 0.0
    active, stored = layer_params(cfg)
    for T in plens:
        flops = 2.0 * T * L * active + 2.0 * head + 4.0 * dh * hq * L * T * (T + 1) / 2
        nbytes = (L * stored + head) * BF16 + T * kv_tok
        total += bound_s(flops, nbytes)
    rows = len(plens) * group
    if m["E"]:
        read = m["E"] * (1 - (1 - m["k"] / m["E"]) ** rows)  # expected experts chosen by some row
        weights = L * layer_params(cfg, experts_read=read)[0] + head
    else:
        weights = L * stored + head
    for t in range(max_new - 1):  # the prefill's logits give the first token
        cols = group * (sum(plens) + len(plens) * (t + 1))  # visible columns over all rows
        flops = 2.0 * rows * (L * active + head) + 4.0 * dh * hq * L * cols
        nbytes = weights * BF16 + (sum(plens) + rows * t) * kv_tok + rows * kv_tok
        total += bound_s(flops, nbytes)
    return total


# ------------------------------------------------------- per-launch kernel work


def attn_fwd_work(cfg: dict, nodes: int, pairs: int) -> tuple[float, float]:
    """K1/K2, one layer: 4*dh flops per visible pair per q head; q, k, v
    read once, o (bf16) and lse (fp32) written once, last_desc read once."""
    m = dims(cfg)
    flops = 4.0 * m["dh"] * m["hq"] * pairs
    nbytes = BF16 * (2 * m["hq"] + 2 * m["hkv"]) * nodes * m["dh"] + 4 * m["hq"] * nodes + 4 * nodes
    return flops, nbytes


def attn_bwd_work(cfg: dict, nodes: int, pairs: int) -> tuple[float, float]:
    """The tree-attention backward of one layer, counted once as the fused
    dq/dk/dv pass needs it: 5 products per visible pair per q head (s, dp,
    dq, dk, dv); q, k, v, do read once, lse and di read once, dq, dk, dv
    written once (bf16), last_desc read once."""
    m = dims(cfg)
    flops = 5 * 2.0 * m["dh"] * m["hq"] * pairs
    nbytes = (BF16 * (2 * m["hq"] + 2 * m["hkv"]) * nodes * m["dh"] + 8 * m["hq"] * nodes + 4 * nodes
              + BF16 * (m["hq"] + 2 * m["hkv"]) * nodes * m["dh"])
    return flops, nbytes


def qk_work(n: int, H: int, dh: int, kind: str) -> float:
    """Bytes one qk-prep kernel must move (per-head norm, RoPE, head-major
    transpose): bf16 activations read and written once, fp32 cos/sin read
    once, the bf16 norm weight read once and, backward, its fp32 grad
    written once."""
    act = BF16 * n * H * dh
    n_act = {"fwd_q": 2, "fwd_kv": 4, "bwd_q": 3, "bwd_kv": 5}[kind]
    extra = 2 * dh + (4 * dh if kind.startswith("bwd") else 0)
    return n_act * act + 2 * 4 * n * dh + extra


def qk_pair_bytes(cfg: dict, nodes: int, direction: str) -> float:
    """Bytes of one layer's qk-prep in one direction: the q kernel and the
    k/v kernel together (they run as a pair)."""
    m = dims(cfg)
    return qk_work(nodes, m["hq"], m["dh"], direction + "_q") + qk_work(nodes, m["hkv"], m["dh"], direction + "_kv")


def lm_fwd_work(cfg: dict, nodes: int) -> tuple[float, float]:
    """K8: the [n, V] logits' product; hidden and head read once, (lse,
    mean) written once."""
    m = dims(cfg)
    return 2.0 * nodes * m["d"] * m["V"], BF16 * nodes * m["d"] + BF16 * m["d"] * m["V"] + 8 * nodes


def lm_bwd_work(cfg: dict, nodes: int) -> tuple[float, float]:
    """K9: the logits again and the two grad products (3x the forward's);
    hidden, head and the three fp32 row vectors read once, dhidden and
    dhead written once."""
    m = dims(cfg)
    d, V = m["d"], m["V"]
    return 6.0 * nodes * d * V, 2 * BF16 * nodes * d + 2 * BF16 * d * V + 12 * nodes


def decode_work(cfg: dict, plens, group: int, t: int) -> tuple[float, float]:
    """K13, one layer at decode step t: per q row, 4*dh flops for each
    visible column (its prompt's columns, its own t columns, itself); the
    prompt caches and each branch's t columns read once, q and the new
    k, v read once, o written once."""
    m = dims(cfg)
    P = len(plens)
    cols = group * (sum(plens) + P * (t + 1))
    flops = 4.0 * m["dh"] * m["hq"] * cols
    kv_bytes = 2 * BF16 * m["dh"] * m["hkv"] * (sum(plens) + P * group * t)
    nbytes = kv_bytes + BF16 * P * group * m["dh"] * (2 * m["hq"] + 2 * m["hkv"]) + 4 * P
    return flops, nbytes


# ------------------------------------------------------------- kernel names


def kernel_layer(name: str) -> str:
    """The layer a device kernel belongs to, by its name."""
    if "qk_prep" in name:
        return "qk-prep"
    if "tree_attn_fwd" in name:
        return "tree attention fwd"
    if "tree_attn_bwd" in name:
        return "tree attention bwd"
    if "lm_bwd" in name or "lm_fwd" in name:
        return "LM-head stats"
    if "decode_attn_kernel" in name:
        return "grouped-decode attention"
    low = name.lower()
    if any(tag in low for tag in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
        return "matmuls (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "elementwise / norms / rope / gathers"
