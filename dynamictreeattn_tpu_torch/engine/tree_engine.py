"""TreeEngine: one forward pass over a packed trie (inference log-probs).

Counterpart of the forward path of ``dynamictreeattn_tpu/engine/tree_engine.py``:
``prepare`` flattens a TokenTrie, pads it to a bucket, builds the block-sparse
mask metadata and uploads it; ``forward`` returns per-sequence log-prob vectors
keyed by ``_sequence_batch_id`` — the RL ratio-denominator ("behavior
logprobs") path. The dense baseline is the same engine on
``pack_sequences_dense``: identical math, no prefix reuse, so tree-vs-dense
agreement is the system's own oracle. The training path (``loss_and_grad``)
comes with the backward kernels.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config, forward_hidden, lm_head_weight
from dynamictreeattn_tpu_torch.ops.losses import logprob_entropy_from_hidden
from dynamictreeattn_tpu_torch.ops.tree_attention import BlockSizes, tree_attention
from dynamictreeattn_tpu_torch.ops.tree_attention_ref import tree_attention_reference
from dynamictreeattn_tpu_torch.tries import PackedTrie, TokenTrie, build_block_meta, flatten_trie, pack_forest
from dynamictreeattn_tpu_torch.tries.flatten import _pad_packed

__all__ = [
    "EngineConfig", "TrieBatch", "TreeEngine", "pack_sequences_dense",
    "resolve_kernel_modes", "resolve_loss_mode",
]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Metadata block sizes: the card's choice (multiples of the kernels' 64
    # tiles), not the TPU's 512.
    block_q: int = BlockSizes.block_q
    block_kv: int = BlockSizes.block_kv
    temperature: float = 1.0
    # "auto": the K8 kernel path ("kernel") when the kernel attention backend
    # runs, else the plain vocab-chunked fold ("vocab"); or force either
    loss_mode: str = "auto"
    attn_backend: str = "kernel"  # "kernel" | "reference" (dense oracle)
    # forward softmax shift: "auto" = "bound" for qk-normed models, "online"
    # otherwise; or force either
    fwd_softmax: str = "auto"
    # per-head qk-norm + RoPE as plain tensor code; the fused qk-prep
    # kernels are not ported yet, so "off" is the only accepted value
    fused_qk: str = "off"

    def __post_init__(self):
        if self.fused_qk != "off":
            raise ValueError(f"fused_qk={self.fused_qk!r}: only 'off' is supported by this port")
        if self.attn_backend not in ("kernel", "reference"):
            raise ValueError(f"unknown attn_backend {self.attn_backend!r}")

    @property
    def pad_multiple(self) -> int:
        # metadata needs the padded length to divide both block sizes
        return math.lcm(self.block_q, self.block_kv)

    def bucket_length(self, n: int) -> int:
        """n rounded up to pad_multiple. The JAX engine's geometric "ladder"
        buckets exist so that jit shapes repeat across batches; the eager
        port compiles nothing per shape, so it pads no further."""
        m = self.pad_multiple
        return max(m, -(-n // m) * m)


def resolve_kernel_modes(mc, cfg: EngineConfig) -> str:
    """Forward softmax mode for this model/config: "auto" is "bound" for
    qk-normed models (whose scores are bounded), "online" otherwise."""
    if cfg.fwd_softmax == "auto":
        return "bound" if getattr(mc, "use_qk_norm", False) else "online"
    return cfg.fwd_softmax


def resolve_loss_mode(cfg: EngineConfig) -> str:
    """LM-head statistics implementation: "auto" means the K8 kernel path
    whenever the kernel attention backend runs, else the vocab-chunked fold.
    (The JAX package's d <= 2048 gate was a TPU-compiler limit; the CUDA
    kernel loops over the hidden size and has none.)"""
    if cfg.loss_mode != "auto":
        return cfg.loss_mode
    return "kernel" if cfg.attn_backend == "kernel" else "vocab"


@dataclasses.dataclass
class TrieBatch:
    """Device-ready packed trie + host-side metadata for result extraction."""

    packed: PackedTrie  # host
    tokens: torch.Tensor
    depth: torch.Tensor
    parent: torch.Tensor
    last_desc: torch.Tensor
    meta: tuple  # (kv_ids, kv_counts, kv_types) int32

    @property
    def n_padded(self) -> int:
        return self.packed.n_padded


class TreeEngine:
    def __init__(self, model_config: Qwen3Config, config: EngineConfig = EngineConfig(),
                 device="cuda"):
        self.mc = model_config
        self.cfg = config
        self.device = torch.device(device)

    def prepare(self, trie_or_packed) -> TrieBatch:
        """Flatten (if needed), pad to bucket, build block metadata, upload."""
        cfg = self.cfg
        if isinstance(trie_or_packed, TokenTrie):
            packed = flatten_trie(trie_or_packed)
        else:
            packed = trie_or_packed
        n_pad = cfg.bucket_length(packed.n_padded)
        if packed.n_padded != n_pad:
            packed = _pad_packed(packed, n_pad)
        meta = build_block_meta(packed.last_desc, cfg.block_q, cfg.block_kv)

        def up(a):  # int32 on the device (pack_forest's offsets widen to int64)
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)

        return TrieBatch(
            packed=packed,
            tokens=up(packed.tokens),
            depth=up(packed.depth),
            parent=up(packed.parent),
            last_desc=up(packed.last_desc),
            meta=(up(meta.kv_ids), up(meta.kv_counts), up(meta.kv_types)),
        )

    def _attn_fn(self, batch: TrieBatch):
        cfg = self.cfg
        if cfg.attn_backend == "reference":
            return lambda q, k, v: tree_attention_reference(q, k, v, batch.last_desc)
        bs = BlockSizes(cfg.block_q, cfg.block_kv)
        mode = resolve_kernel_modes(self.mc, cfg)
        return lambda q, k, v: tree_attention(
            q, k, v, batch.last_desc, *batch.meta, block_sizes=bs, softmax_mode=mode,
        )

    def hidden(self, params, batch: TrieBatch) -> torch.Tensor:
        """Final-norm'd hidden states [n_padded, d] of the packed trie."""
        with torch.inference_mode():
            return forward_hidden(params, self.mc, batch.tokens, batch.depth,
                                  self._attn_fn(batch))

    def logprobs(self, params, batch: TrieBatch):
        """(lp_edge [n_padded], entropy [n_padded]) fp32 on the device."""
        with torch.inference_mode():
            return logprob_entropy_from_hidden(
                self.hidden(params, batch), lm_head_weight(params, self.mc),
                batch.tokens, batch.parent, self.cfg.temperature,
                resolve_loss_mode(self.cfg),
            )

    def forward(self, params, batch: TrieBatch) -> dict[int, np.ndarray]:
        """Inference-mode per-sequence log-probs: {_sequence_batch_id: fp32
        array of length len(seq)-1}."""
        lp_edge, _ = self.logprobs(params, batch)
        lp_edge = lp_edge.cpu().numpy()
        out: dict[int, np.ndarray] = {}
        packed = batch.packed
        paths = packed.seq_paths_matrix()
        for s in range(len(packed.seq_batch_ids)):
            L = int(packed.seq_lens[s])
            out[int(packed.seq_batch_ids[s])] = lp_edge[paths[s, 1:L]]
        return out


def pack_sequences_dense(seqs, attachs=None, pad_multiple: int = 256,
                         weight_fn=None) -> PackedTrie:
    """Dense-replay packing: every sequence its own chain (zero sharing).

    Running TreeEngine on this packing IS the dense baseline — identical
    math, no prefix reuse."""
    if attachs is None:
        attachs = [{} for _ in seqs]
    kw = {"weight_fn": weight_fn} if weight_fn is not None else {}
    chains = []
    for i, (s, a) in enumerate(zip(seqs, attachs)):
        t = TokenTrie([s], [dict(a)])
        # keep the original batch id (TokenTrie re-keys to its local index 0)
        t.attach_lists[0] = [
            (dict(att, _sequence_batch_id=i), length)
            for att, length in t.attach_lists[0]
        ]
        chains.append(flatten_trie(t, **kw))
    packed = pack_forest(chains)
    m = pad_multiple
    n_pad = max(m, -(-packed.n_padded // m) * m)
    return _pad_packed(packed, n_pad)
