"""TreeEngine: fused single-pass trie training and inference log-probs.

Counterpart of ``dynamictreeattn_tpu/engine/tree_engine.py``: ``prepare``
flattens a TokenTrie, pads it to a bucket, builds the block-sparse mask
metadata and uploads it;

* ``loss_and_grad(params, batch)`` → (loss, grads, aux): the training step,
  one forward and one backward over the packed trie (autograd through the
  qk-prep, tree-attention and LM-head kernels, layers under remat);
* ``loss_and_grad_custom(params, batch, loss_fn, extras)`` → (loss, grads):
  the training step with a per-sequence loss of the caller's (every RL
  objective goes through it);
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

from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config, forward_hidden_aux, lm_head_weight
from dynamictreeattn_tpu_torch.ops.losses import logprob_entropy_from_hidden
from dynamictreeattn_tpu_torch.ops.tree_attention import (
    KERNEL_TILE, KMAJOR_CTAS_PER_SM, BlockSizes, cached_bwd_geometry, kernel_takes, kmajor_work,
    qmajor_work, tree_attention,
)
from dynamictreeattn_tpu_torch.ops.tree_attention_ref import tree_attention_reference
from dynamictreeattn_tpu_torch.tries import (
    KMajorWork, PackedTrie, QMajorWork, TokenTrie, build_block_meta, build_bwd_cache_sched, flatten_trie,
    pack_forest,
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
    # recompute each layer in the backward (torch.utils.checkpoint), keeping
    # what `remat_policy` names: None (the layer input only), "dots" (the
    # seven projection products), "attn" (the tree attention's o and lse, so
    # its forward kernel runs once a step) or "attn_dots" (both)
    remat: bool = True
    remat_policy: str | None = None
    remat_segments: int = 0  # > 0: nested checkpointing over this many segments
    temperature: float = 1.0
    loss_chunk: int = 1024  # row-chunk size (loss_mode="rows" only)
    # "auto": the K8 kernel path ("kernel") when the kernel attention backend
    # runs, else the plain vocab-chunked fold ("vocab"); or force either, or
    # "rows" (the row-chunked checkpointed fold of plain logits)
    loss_mode: str = "auto"
    attn_backend: str = "kernel"  # "kernel" | "reference" (dense oracle)
    # forward softmax shift: "auto" = "bound" for qk-normed models, "online"
    # otherwise; or force either
    fwd_softmax: str = "auto"
    # backward kernels: "auto" = "cached" (K3, the fused pass with dk/dv on
    # chip), as in the JAX engine; or "fused" (K10), "split" (K11 dq + K12
    # dk/dv: the card's bit-reproducible backward). On the card K3 and K10
    # are one key-major kernel; on the CPU the plain K3 replays a slot
    # schedule, and a CPU batch prepared without one takes "fused".
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
        if self.remat_policy not in (None, "dots", "attn", "attn_dots"):
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        if self.remat_segments < 0:
            raise ValueError(f"remat_segments {self.remat_segments} < 0")
        if self.loss_mode not in ("auto", "kernel", "vocab", "rows"):
            raise ValueError(f"unknown loss_mode {self.loss_mode!r}")

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
    CPU batch without a slot schedule downgrades "cached" to "fused" at the
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
    # slot schedule (actions, flush) int32 when the plain K3 replays it (a
    # CPU batch of the "cached" backward)
    meta: tuple
    # the key-major backwards' work list (K3, K10, K12) for the model's kv
    # heads, on the card, when the kernel backend runs them
    kmajor_work: KMajorWork | None = None
    # the query-major work list of the forward (K1, K2) and of K11, on the
    # card, when the kernel backend runs them
    qmajor_work: QMajorWork | None = None
    # (paths, lengths) of seq_gather_arrays, built on first use
    _gather_cache: tuple | None = dataclasses.field(default=None, repr=False)

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
        """Flatten (if needed), pad to bucket, build block metadata (and, on
        the CPU for the kernel backend's "cached" backward, the slot schedule
        the plain K3 replays; on the card, the query-major work list of
        K1/K2/K11 and the key-major work list of K3/K10/K12), upload."""
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
        if self._wants_schedule():
            sched = build_bwd_cache_sched(meta, cached_bwd_geometry(meta.q_ids.shape[0]))
            arrays += [sched.actions, sched.flush]

        def up(a, dtype=np.int32):  # int32 indices (pack_forest's offsets widen to int64)
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(self.device)

        work = None
        if self._wants_kmajor_work():
            work = kmajor_work(packed.last_desc, meta.q_ids, meta.q_counts, meta.q_types,
                               cfg.block_q, cfg.block_kv, self.mc.num_key_value_heads,
                               self.mc.head_dim, self.device)

        qwork = None
        if self._wants_qmajor_work():
            qwork = qmajor_work(packed.last_desc, meta.kv_ids, meta.kv_counts, meta.kv_types,
                                cfg.block_q, cfg.block_kv, self.device)

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
            kmajor_work=work,
            qmajor_work=qwork,
        )

    def _wants_schedule(self) -> bool:
        """Whether the backward is the plain K3, which replays the slot
        schedule, so that ``prepare`` builds it: the kernel backend's
        "cached" on the CPU (the kernel on the card takes none)."""
        return (self.device.type == "cpu" and self.cfg.attn_backend == "kernel"
                and resolve_kernel_modes(self.mc, self.cfg)[1] == "cached")

    def _wants_qmajor_work(self) -> bool:
        """Whether the forward runs K1/K2 (and the split backward K11) on the
        card at shapes they take, so that ``prepare`` builds their work list."""
        cfg, mc = self.cfg, self.mc
        return (self.device.type == "cuda" and cfg.attn_backend == "kernel"
                and cfg.block_q % KERNEL_TILE == 0 and cfg.block_kv % KERNEL_TILE == 0
                and kernel_takes(mc.head_dim, mc.num_attention_heads // mc.num_key_value_heads))

    def _wants_kmajor_work(self) -> bool:
        """Whether the backward runs K3, K10 or K12 (every mode runs one) on
        the card at shapes they take, so that ``prepare`` builds their work
        list (on the CPU the wrappers run the plain versions, which need
        none)."""
        cfg = self.cfg
        return (self.device.type == "cuda" and cfg.attn_backend == "kernel"
                and cfg.block_q % KERNEL_TILE == 0 and cfg.block_kv % KERNEL_TILE == 0
                and self.mc.head_dim in KMAJOR_CTAS_PER_SM)

    def _attn_fn(self, batch: TrieBatch):
        cfg = self.cfg
        if cfg.attn_backend == "reference":
            # the dense oracle keeps no (o, lse) for a remat hand-off: under
            # "attn" its layers recompute it, as the JAX reference's do
            return lambda q, k, v, handoff=None: tree_attention_reference(q, k, v, batch.last_desc)
        bs = BlockSizes(cfg.block_q, cfg.block_kv)
        fwd, bwd = resolve_kernel_modes(self.mc, cfg)
        sched = batch.meta[6:] or None
        if bwd == "cached" and sched is None and batch.last_desc.device.type == "cpu":
            bwd = "fused"  # a CPU batch prepared without a schedule
        return lambda q, k, v, handoff=None: tree_attention(
            q, k, v, batch.last_desc, *batch.meta[:6], block_sizes=bs, softmax_mode=fwd,
            bwd_mode=bwd, cache_sched=sched, kmajor_work=batch.kmajor_work,
            qmajor_work=batch.qmajor_work, handoff=handoff,
        )

    def hidden(self, params, batch: TrieBatch) -> torch.Tensor:
        """Final-norm'd hidden states [n_padded, d] of the packed trie."""
        with torch.inference_mode():
            return self._hidden_aux(params, batch, train=False)[0]

    def logprobs(self, params, batch: TrieBatch):
        """(lp_edge [n_padded], entropy [n_padded]) fp32 on the device."""
        with torch.inference_mode():
            return self._edge_stats(params, self.hidden(params, batch), batch)

    def _hidden_aux(self, params, batch: TrieBatch, train: bool):
        """(hidden, aux) of the model's layers (MoE routing masked by the
        batch's `valid`): the training path's (remat with its policy and
        segments) when `train`, else one plain forward; fused qk-prep as
        configured. aux holds the MoE load-balance loss. The sharded engine
        (``parallel.train``) overrides it with the tensor-parallel model."""
        cfg = self.cfg
        return forward_hidden_aux(params, self.mc, batch.tokens, batch.depth, self._attn_fn(batch),
                                  remat=train and cfg.remat, remat_policy=cfg.remat_policy if train else None,
                                  remat_segments=cfg.remat_segments if train else 0,
                                  fused_qk=resolve_fused_qk(cfg), valid=batch.valid)

    def _edge_stats(self, params, hidden, batch: TrieBatch):
        """(lp_edge, entropy) fp32 [n] from the hidden states through the LM
        head (the sharded engine's: through its vocabulary shard)."""
        return logprob_entropy_from_hidden(hidden, lm_head_weight(params, self.mc), batch.tokens, batch.parent,
                                           self.cfg.temperature, resolve_loss_mode(self.cfg), self.cfg.loss_chunk)

    def _train_hidden(self, params, batch: TrieBatch):
        """(hidden, aux): differentiable final hidden states of the training
        path's layers and the model's aux (``_hidden_aux``)."""
        return self._hidden_aux(params, batch, train=True)

    def _router_aux(self, loss, aux: dict, faux: dict):
        """A MoE model's loss plus router_aux_coef · lb_loss, and aux with
        "lb_loss" (the JAX engine's ``_loss``); a dense model's unchanged."""
        if self.mc.is_moe:
            aux["lb_loss"] = faux["lb_loss"]
            if self.mc.router_aux_coef:
                loss = loss + self.mc.router_aux_coef * faux["lb_loss"]
        return loss, aux

    def _loss(self, params, batch: TrieBatch):
        """The trie loss Σ w_logprob·lp + Σ w_entropy·H (``tree_loss_from_hidden``)."""
        hidden, faux = self._train_hidden(params, batch)
        lp_edge, entropy = self._edge_stats(params, hidden, batch)
        sum_lp = torch.sum(batch.w_logprob * lp_edge)
        sum_ent = torch.sum(batch.w_entropy * entropy)
        return self._router_aux(sum_lp + sum_ent, {"sum_logprob": sum_lp, "sum_entropy": sum_ent}, faux)

    def loss(self, params, batch: TrieBatch):
        """(loss, aux) fp32 scalars on the device, no gradients."""
        with torch.no_grad():
            return self._loss(params, batch)

    def loss_and_grad(self, params, batch: TrieBatch):
        """(loss, grads, aux): the training step. `grads` has the structure,
        dtypes and layouts of `params` (an untied head's grad is a [d, V]
        view of [V, d] storage, as the head itself); aux holds
        "sum_logprob" and "sum_entropy", and for a MoE model "lb_loss", the
        router load-balance loss, whose router_aux_coef multiple the loss
        includes. The caller's tensors are not touched: autograd runs on
        detached leaf aliases of them."""
        loss, grads, aux = _value_and_grad(lambda p: self._loss(p, batch), params)
        return loss, grads, {k: v.detach() for k, v in aux.items()}

    def seq_gather_arrays(self, batch: TrieBatch):
        """(paths [S, Lmax] int32, -1 padded; lengths [S] int32) on the
        batch's device: row s holds the packed positions of sequence s
        (``batch.packed.seq_batch_ids[s]``), root to end. Built from
        ``PackedTrie.seq_paths_matrix`` once and cached on the batch."""
        if batch._gather_cache is None:
            packed = batch.packed
            batch._gather_cache = (
                torch.from_numpy(np.ascontiguousarray(packed.seq_paths_matrix(), np.int32)).to(self.device),
                torch.from_numpy(np.asarray(packed.seq_lens, np.int32)).to(self.device),
            )
        return batch._gather_cache

    def loss_and_grad_custom(self, params, batch: TrieBatch, loss_fn, extras=None, with_aux: bool = False,
                             router_aux: bool = False):
        """(loss, grads): the training step with an arbitrary per-sequence loss.

        ``loss_fn(lp, ent, extras_s, length) -> scalar`` runs once per
        sequence under ``torch.func.vmap`` and the results are summed:
        `lp` [Lmax-1] is the sequence's per-edge log-prob vector (entries
        from length-1 on are padding: mask by `length`), `ent` [Lmax] its
        entropy vector, `extras_s` the sequence's row of each tensor in the
        dict `extras` (leading dim S, rows in ``batch.packed.seq_batch_ids``
        order), `length` its token count (an int32 0-d tensor). Under vmap
        a `loss_fn` must avoid data-dependent Python control flow and
        host reads (``.item()``, ``bool(tensor)``); an op without a batching
        rule makes vmap loop in Python per sequence, with a warning only.

        The log-probs and entropies are the training path's (remat, fused
        qk-prep, LM-head kernels), so the gradients reach K9 through the
        caller's loss. The gathers are advanced indexing, whose backward
        sums repeated positions (shared prefixes) in a fixed order on the
        card. `grads` as in ``loss_and_grad``. The JAX engine caches one
        compiled step per `loss_fn`; eager code compiles nothing, so there
        is no cache. With `with_aux`, (loss, grads, aux): aux holds
        "sum_logprob" and "sum_entropy", the sums of every sequence's
        log-probs and entropies (the trainer's records). A MoE model routes
        with the batch's `valid`; its load-balance term is left out, as in
        the JAX engine, unless `router_aux` (the trainer's step, as JAX's
        ``make_train_step``): then the loss adds router_aux_coef · lb_loss
        and aux "lb_loss"."""
        paths, lengths = self.seq_gather_arrays(batch)
        safe = paths.long().clamp(min=0)
        extras = {} if extras is None else extras

        def total(p):
            hidden, faux = self._train_hidden(p, batch)
            lp_edge, entropy = self._edge_stats(p, hidden, batch)
            lp_rows, ent_rows = lp_edge[safe[:, 1:]], entropy[safe]
            per_seq = torch.func.vmap(loss_fn)(lp_rows, ent_rows, extras, lengths)
            loss, aux = per_seq.sum(), {}
            if with_aux:
                col = torch.arange(ent_rows.shape[1], device=lengths.device)
                aux = {
                    "sum_logprob": torch.sum(lp_rows * (col[None, :-1] < lengths[:, None] - 1)),
                    "sum_entropy": torch.sum(ent_rows * (col[None, :] < lengths[:, None])),
                }
            return self._router_aux(loss, aux, faux) if router_aux else (loss, aux)

        loss, grads, aux = _value_and_grad(total, params)
        if not with_aux:
            return loss, grads
        return loss, grads, {k: v.detach() for k, v in aux.items()}

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


def _value_and_grad(fn, params):
    """(loss, grads, aux) of ``fn(params) -> (loss, aux)``: autograd on
    detached leaf aliases of the params, grads restrided to each param's
    layout (an untied head's [d, V] view of [V, d] storage included)."""
    names, leaves = _flatten(params)
    aliases = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss, aux = fn(_unflatten(params, names, aliases))
        grads = torch.autograd.grad(loss, aliases)
    grads = [g if g.stride() == t.stride()
             else torch.empty_strided(t.shape, t.stride(), dtype=g.dtype, device=g.device).copy_(g)
             for g, t in zip(grads, leaves)]
    return loss.detach(), _unflatten(params, names, grads), aux


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
