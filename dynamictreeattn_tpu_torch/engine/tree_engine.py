"""TreeEngine: fused single-pass trie training and inference log-probs.

Counterpart of ``dynamictreeattn_tpu/engine/tree_engine.py``: ``prepare``
flattens a TokenTrie, pads it to a bucket, builds the block-sparse mask
metadata and uploads it;

* ``loss_and_grad(params, batch)`` → (loss, grads, aux): the training step,
  one forward and one backward over the packed trie (autograd through the
  qk-prep, tree-attention and LM-head kernels, layers under remat);
* ``loss(params, batch)`` → (loss, aux) without gradients;
* ``forward(params, batch)`` → per-sequence log-prob vectors keyed by
  ``_sequence_batch_id`` — the RL ratio-denominator ("behavior logprobs")
  path.

The dense baseline is the same engine on ``pack_sequences_dense``: identical
math, no prefix reuse, so tree-vs-dense agreement of loss and gradients is
the system's own oracle.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dynamictreeattn_tpu_torch.models.qwen3 import (
    Qwen3Config, forward_hidden, forward_hidden_aux, lm_head_weight,
)
from dynamictreeattn_tpu_torch.ops.losses import logprob_entropy_from_hidden, tree_loss_from_hidden
from dynamictreeattn_tpu_torch.ops.tree_attention import BlockSizes, cached_bwd_geometry, tree_attention
from dynamictreeattn_tpu_torch.ops.tree_attention_ref import tree_attention_reference
from dynamictreeattn_tpu_torch.tries import (
    PackedTrie, TokenTrie, build_block_meta, build_bwd_cache_sched, flatten_trie, pack_forest,
)
from dynamictreeattn_tpu_torch.tries.flatten import _pad_packed

__all__ = [
    "EngineConfig", "TrieBatch", "TreeEngine", "pack_sequences_dense",
    "resolve_fused_qk", "resolve_kernel_modes", "resolve_loss_mode",
]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Metadata block sizes: the card's choice (multiples of the kernels' 64
    # tiles), not the TPU's 512.
    block_q: int = BlockSizes.block_q
    block_kv: int = BlockSizes.block_kv
    # recompute each layer in the backward (torch.utils.checkpoint); the JAX
    # engine's remat policies and nested segments are not ported
    remat: bool = True
    temperature: float = 1.0
    # "auto": the K8 kernel path ("kernel") when the kernel attention backend
    # runs, else the plain vocab-chunked fold ("vocab"); or force either
    loss_mode: str = "auto"
    attn_backend: str = "kernel"  # "kernel" | "reference" (dense oracle)
    # forward softmax shift: "auto" = "bound" for qk-normed models, "online"
    # otherwise; or force either
    fwd_softmax: str = "auto"
    # backward kernels: "auto" = "cached" (K3, the fused pass with dk/dv on
    # chip), as in the JAX engine; or "fused" (K10), "split" (K11 dq + K12
    # dk/dv). A batch prepared without a slot schedule takes "fused".
    bwd_mode: str = "auto"
    # per-head qk-norm + RoPE + head-major transpose in the fused qk-prep
    # kernels (K4-K7, ops/qk_prep.py): "auto" = on whenever the kernel
    # attention backend runs, as in the JAX engine; "on"/"off" force it
    fused_qk: str = "auto"

    def __post_init__(self):
        if self.fused_qk not in ("auto", "on", "off"):
            raise ValueError(f"unknown fused_qk {self.fused_qk!r}")
        if self.attn_backend not in ("kernel", "reference"):
            raise ValueError(f"unknown attn_backend {self.attn_backend!r}")
        if self.bwd_mode not in ("auto", "split", "fused", "cached"):
            raise ValueError(f"unknown bwd_mode {self.bwd_mode!r}")

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


def resolve_kernel_modes(mc, cfg: EngineConfig) -> tuple[str, str]:
    """(softmax_mode, bwd_mode) for this model/config: softmax "auto" is
    "bound" for qk-normed models (whose scores are bounded), "online"
    otherwise; backward "auto" is "cached" (K3), the JAX engine's rule. A
    batch without a slot schedule downgrades "cached" to "fused" at the
    call site (``TreeEngine._attn_fn``)."""
    fwd = cfg.fwd_softmax
    if fwd == "auto":
        fwd = "bound" if getattr(mc, "use_qk_norm", False) else "online"
    bwd = "cached" if cfg.bwd_mode == "auto" else cfg.bwd_mode
    return fwd, bwd


def resolve_fused_qk(cfg: EngineConfig) -> bool:
    """Whether the layers take the fused qk-prep kernels: "auto" means on
    iff the kernel attention backend runs (the JAX engine's rule; the port
    has no interpret mode, so on CPU tensors the kernel backend runs the
    plain qk-prep versions)."""
    if cfg.fused_qk == "auto":
        return cfg.attn_backend == "kernel"
    return cfg.fused_qk == "on"


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
    w_logprob: torch.Tensor  # [n] fp32 per-edge loss weights
    w_entropy: torch.Tensor  # [n] fp32 per-position loss weights
    valid: torch.Tensor  # [n] fp32, 1 real / 0 padding
    # (kv_ids, kv_counts, kv_types, q_ids, q_counts, q_types) int32, then the
    # slot schedule (actions, flush) int32 when the backward is "cached"
    meta: tuple

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
        """Flatten (if needed), pad to bucket, build block metadata (and, for
        the kernel backend's "cached" backward, the slot schedule), upload."""
        cfg = self.cfg
        if isinstance(trie_or_packed, TokenTrie):
            packed = flatten_trie(trie_or_packed)
        else:
            packed = trie_or_packed
        n_pad = cfg.bucket_length(packed.n_padded)
        if packed.n_padded != n_pad:
            packed = _pad_packed(packed, n_pad)
        meta = build_block_meta(packed.last_desc, cfg.block_q, cfg.block_kv)
        arrays = [meta.kv_ids, meta.kv_counts, meta.kv_types, meta.q_ids, meta.q_counts, meta.q_types]
        if cfg.attn_backend == "kernel" and resolve_kernel_modes(self.mc, cfg)[1] == "cached":
            sched = build_bwd_cache_sched(meta, cached_bwd_geometry(meta.q_ids.shape[0]))
            arrays += [sched.actions, sched.flush]

        def up(a, dtype=np.int32):  # int32 indices (pack_forest's offsets widen to int64)
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(self.device)

        return TrieBatch(
            packed=packed,
            tokens=up(packed.tokens),
            depth=up(packed.depth),
            parent=up(packed.parent),
            last_desc=up(packed.last_desc),
            w_logprob=up(packed.w_logprob, np.float32),
            w_entropy=up(packed.w_entropy, np.float32),
            valid=up(packed.valid, np.float32),
            meta=tuple(up(a) for a in arrays),
        )

    def _attn_fn(self, batch: TrieBatch):
        cfg = self.cfg
        if cfg.attn_backend == "reference":
            return lambda q, k, v: tree_attention_reference(q, k, v, batch.last_desc)
        bs = BlockSizes(cfg.block_q, cfg.block_kv)
        fwd, bwd = resolve_kernel_modes(self.mc, cfg)
        sched = batch.meta[6:] or None
        if bwd == "cached" and sched is None:
            bwd = "fused"  # batch prepared without a schedule
        return lambda q, k, v: tree_attention(
            q, k, v, batch.last_desc, *batch.meta[:6], block_sizes=bs, softmax_mode=fwd,
            bwd_mode=bwd, cache_sched=sched,
        )

    def hidden(self, params, batch: TrieBatch) -> torch.Tensor:
        """Final-norm'd hidden states [n_padded, d] of the packed trie."""
        with torch.inference_mode():
            return forward_hidden(params, self.mc, batch.tokens, batch.depth,
                                  self._attn_fn(batch), fused_qk=resolve_fused_qk(self.cfg))

    def logprobs(self, params, batch: TrieBatch):
        """(lp_edge [n_padded], entropy [n_padded]) fp32 on the device."""
        with torch.inference_mode():
            return logprob_entropy_from_hidden(
                self.hidden(params, batch), lm_head_weight(params, self.mc),
                batch.tokens, batch.parent, self.cfg.temperature,
                resolve_loss_mode(self.cfg),
            )

    def _loss(self, params, batch: TrieBatch):
        cfg = self.cfg
        hidden, _ = forward_hidden_aux(params, self.mc, batch.tokens, batch.depth,
                                       self._attn_fn(batch), remat=cfg.remat,
                                       fused_qk=resolve_fused_qk(cfg))
        loss, aux = tree_loss_from_hidden(
            hidden, lm_head_weight(params, self.mc), batch.tokens, batch.parent,
            batch.w_logprob, batch.w_entropy, cfg.temperature, resolve_loss_mode(cfg),
        )
        return loss, {"sum_logprob": aux["sum_logprob"], "sum_entropy": aux["sum_entropy"]}

    def loss(self, params, batch: TrieBatch):
        """(loss, aux) fp32 scalars on the device, no gradients."""
        with torch.no_grad():
            return self._loss(params, batch)

    def loss_and_grad(self, params, batch: TrieBatch):
        """(loss, grads, aux): the training step. `grads` has the structure,
        dtypes and layouts of `params` (an untied head's grad is a [d, V]
        view of [V, d] storage, as the head itself); aux holds
        "sum_logprob" and "sum_entropy". The caller's tensors are not
        touched: autograd runs on detached leaf aliases of them."""
        names, leaves = _flatten(params)
        aliases = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            loss, aux = self._loss(_unflatten(params, names, aliases), batch)
            grads = torch.autograd.grad(loss, aliases)
        grads = [g if g.stride() == t.stride()
                 else torch.empty_strided(t.shape, t.stride(), dtype=g.dtype, device=g.device).copy_(g)
                 for g, t in zip(grads, leaves)]
        return loss.detach(), _unflatten(params, names, grads), {k: v.detach() for k, v in aux.items()}

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


def _flatten(tree, prefix=()):
    """(paths, leaves) of a nested dict of tensors, in insertion order."""
    names, leaves = [], []
    for key, val in tree.items():
        if isinstance(val, dict):
            sub_names, sub_leaves = _flatten(val, prefix + (key,))
            names += sub_names
            leaves += sub_leaves
        else:
            names.append(prefix + (key,))
            leaves.append(val)
    return names, leaves


def _unflatten(like, names, leaves):
    """A copy of the nested dict `like` with its leaves replaced."""
    out = {key: _unflatten(val, (), []) if isinstance(val, dict) else None
           for key, val in like.items()}
    for path, leaf in zip(names, leaves):
        node = out
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
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
