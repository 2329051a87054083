"""Training and forward steps over stacked trie batches, on one device or a mesh.

Counterpart of ``dynamictreeattn_tpu/parallel/train.py`` in PyTorch's
idiom: one process per rank, the JAX ``shard_map`` body as each rank's own
step, its ``psum``s as collectives over the mesh's process groups
(``parallel/mesh.py``).

* ``param_specs`` / ``shard_params`` / ``gather_params``: the Megatron
  layout over "model" (JAX ``param_specs``) — the vocabulary-sharded
  embedding (the tied head shares the shard), heads, MLP columns and rows,
  experts; with expert parallelism the experts shard data-major over
  ("data", "model"). With ``fsdp`` (ZeRO-3, JAX ``fsdp_dims``) each large
  leaf also shards one free dim over "data". ``shard_params`` cuts full
  params into this rank's slices (the port's ``NamedSharding``),
  ``gather_params`` puts them back together (checkpoints, the sampler).
* ``stack_batches`` pads every rank's trie to one common bucket and, given
  an engine, builds the device batch of the ranks this process holds: all
  of them on one device, its own data rank's on a mesh (the JAX package
  stacks host arrays for its mesh; a rank reads only its own). Under
  sequence parallelism it also builds this rank's ``SeqShard``: its
  parent-owned edges, and under the ring its ``RingPair`` of each step
  (metadata and work lists of its q shard against each kv shard).
* ``make_train_step`` / ``make_forward_step``: on one device the
  ``TreeEngine`` step; on a mesh, each rank's step on its shards
  (``ShardedEngine``: the tensor-parallel model of ``tp_model.py``, the
  vocab-parallel loss of ``vocab_parallel.py``, the ZeRO-3 gathers, the
  sequence-parallel rows and loss) and JAX's grad bookkeeping: under
  sequence parallelism every grad and the loss summed over "seq"; q_norm /
  k_norm grads summed over "model" (each rank's covers its heads); every
  grad summed over "data" but the experts' under expert parallelism (each
  has one owner) and the ZeRO-3 leaves' (their gather's backward is a
  reduce-scatter); the loss and aux summed over "data". With an optimizer,
  its non-finite skip reads the summed loss, so every rank skips together.

On a mesh with a "pipe" axis the layouts also cut every stacked layer leaf
into the stages' slices (``pp_param_specs``): ``shard_params``
keeps this stage's layers, ``gather_params`` puts the stages back together
and ``global_sum_squares`` counts each stage's layers once; the step over
such a mesh is ``pipeline.make_pp_train_step``.

JAX's ``batch_partition_specs`` has no counterpart: it tells a global array
how to split over the mesh, and here each rank builds and uploads only its
own rows.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from dynamictreeattn_tpu_torch.engine.tree_engine import (
    EngineConfig, TreeEngine, TrieBatch, _flatten, _unflatten, _value_and_grad, resolve_fused_qk, resolve_loss_mode,
)
from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config, lm_head_weight
from dynamictreeattn_tpu_torch.ops.tree_attention import BlockSizes
from dynamictreeattn_tpu_torch.parallel.collectives import (
    _gather_blocks, _storage_order, all_gather_dim, all_reduce_, fsdp_gather,
)
from dynamictreeattn_tpu_torch.parallel.tp_model import forward_hidden_tp, local_config, tp_param_shard_info
from dynamictreeattn_tpu_torch.parallel.vocab_parallel import (
    vp_tree_edge_logprobs, vp_tree_edge_logprobs_sp, vp_tree_loss_edges,
)
from dynamictreeattn_tpu_torch.tries import TokenTrie, build_ring_block_meta, flatten_trie
from dynamictreeattn_tpu_torch.tries.flatten import _pad_packed
from dynamictreeattn_tpu_torch.utils.profiling import span

__all__ = ["FSDP_MIN_SIZE", "SeqShard", "ShardedEngine", "StackedBatch", "extract_forward",
           "fsdp_dims", "fsdp_param_specs", "gather_params", "global_sum_squares", "make_forward_step",
           "make_train_step", "param_specs", "pp_param_specs", "shard_params", "stack_batches"]


# ------------------------------------------------------------------ layouts

EXPERT_LEAVES = ("e_gate", "e_up", "e_down")
# leaf name -> the dim it shards over "model" (the stacked layer dim is 0)
_MODEL_DIMS = {"embed": 0, "lm_head": 1, "wq": 2, "wk": 2, "wv": 2, "wo": 1, "gate": 2, "up": 2, "down": 1,
               "bq": 1, "bk": 1, "bv": 1, "e_gate": 1, "e_up": 1, "e_down": 1}
FSDP_MIN_SIZE = 1 << 16  # per-layer elements below which a leaf stays replicated under ZeRO-3


def param_specs(config: Qwen3Config, ep: int = 1) -> dict:
    """{leaf name: (dim, axes)}: the dim a leaf shards and over which axes
    ("model", or ("data", "model") for the experts under ep > 1, data
    major); a leaf not named is replicated (the norms, the router)."""
    names = ["embed", "wq", "wk", "wv", "wo"]
    names += list(EXPERT_LEAVES) if config.is_moe else ["gate", "up", "down"]
    if config.attention_bias:
        names += ["bq", "bk", "bv"]
    if not config.tie_word_embeddings:
        names.append("lm_head")
    return {name: (_MODEL_DIMS[name], ("data", "model") if ep > 1 and name in EXPERT_LEAVES else ("model",))
            for name in names}


def _param_shapes(config: Qwen3Config) -> dict:
    """The shapes of ``models.init_params``'s leaves, {"embed": ..., "layers":
    {...}, ...} (an untied head [d, V])."""
    c = config
    d, dh, L, V = c.hidden_size, c.head_dim, c.num_hidden_layers, c.vocab_size
    hq, hkv = c.num_attention_heads * dh, c.num_key_value_heads * dh
    layers = {"ln1": (L, d), "ln2": (L, d), "wq": (L, d, hq), "wk": (L, d, hkv), "wv": (L, d, hkv),
              "wo": (L, hq, d)}
    if c.is_moe:
        E, Ie = c.num_experts, c.moe_intermediate_size
        layers.update(router=(L, d, E), e_gate=(L, E, d, Ie), e_up=(L, E, d, Ie), e_down=(L, E, Ie, d))
    else:
        layers.update(gate=(L, d, c.intermediate_size), up=(L, d, c.intermediate_size),
                      down=(L, c.intermediate_size, d))
    if c.use_qk_norm:
        layers.update(q_norm=(L, dh), k_norm=(L, dh))
    if c.attention_bias:
        layers.update(bq=(L, hq), bk=(L, hkv), bv=(L, hkv))
    shapes = {"embed": (V, d), "layers": layers, "final_norm": (d,)}
    if not c.tie_word_embeddings:
        shapes["lm_head"] = (d, V)
    return shapes


def fsdp_dims(config: Qwen3Config, dp: int, min_size: int = FSDP_MIN_SIZE, ep: int = 1) -> dict:
    """Which dim of each param shards over "data" under ZeRO-3 (-1:
    replicated), in the params' tree (JAX ``fsdp_dims``): the first dim that
    the "model" layout leaves free (never the stacked layer dim) and that
    divides by dp, for the layer stacks and the embedding / untied head
    with at least `min_size` elements a layer; the experts under expert
    parallelism already shard over "data" and stay as they are."""
    specs = param_specs(config, ep)

    def pick(name: str, shape: tuple, in_layers: bool) -> int:
        spec = specs.get(name)
        if spec is not None and "data" in spec[1]:
            return -1
        if not in_layers and name not in ("embed", "lm_head"):
            return -1
        if dp == 1 or math.prod(shape) // (shape[0] if in_layers else 1) < min_size:
            return -1
        for d in range(1 if in_layers else 0, len(shape)):
            if (spec is None or spec[0] != d) and shape[d] % dp == 0:
                return d
        return -1

    shapes = _param_shapes(config)
    return {key: ({n: pick(n, s, True) for n, s in val.items()} if key == "layers" else pick(key, val, False))
            for key, val in shapes.items()}


def _flat_dims(dims: dict | None) -> dict:
    """{leaf name: fsdp dim} of a ``fsdp_dims`` tree (leaf names are unique)."""
    if dims is None:
        return {}
    return {**{k: v for k, v in dims.items() if k != "layers"}, **dims["layers"]}


def fsdp_param_specs(config: Qwen3Config, dp: int, min_size: int = FSDP_MIN_SIZE, ep: int = 1) -> dict:
    """{leaf name: ((dim, axes), ...)}: every leaf's shardings, the "model"
    one of ``param_specs`` and the ZeRO-3 one over "data" (JAX
    ``fsdp_param_specs``); a replicated leaf has none."""
    specs = param_specs(config, ep)
    out = {}
    for name, d in _flat_dims(fsdp_dims(config, dp, min_size, ep)).items():
        parts = ((specs[name],) if name in specs else ()) + (((d, ("data",)),) if d >= 0 else ())
        if parts:
            out[name] = parts
    return out


def pp_param_specs(config: Qwen3Config, pp: int) -> dict:
    """{leaf name: ((dim, axes), ...)}: ``param_specs`` with every stacked
    layer leaf also cut over "pipe" on the layer dim (stage s holds layers
    [s·L/pp, (s+1)·L/pp)); raises unless pp divides the layer count (JAX
    ``pipeline.pp_param_specs``)."""
    if config.num_hidden_layers % pp:
        raise ValueError(f"{config.num_hidden_layers} layers not divisible by pp={pp}")
    specs = {name: (spec,) for name, spec in param_specs(config).items()}
    for name in _param_shapes(config)["layers"]:
        specs[name] = ((0, ("pipe",)),) + specs.get(name, ())
    return specs


def _layout(mesh, config: Qwen3Config, ep: int, fsdp: bool, fsdp_min_size: int) -> dict:
    """{leaf name: ((dim, axes), ...)} of this mesh's layout."""
    if mesh.size("pipe") > 1:
        if fsdp or ep > 1:
            raise ValueError("fsdp and ep do not combine with pipeline parallelism")
        return pp_param_specs(config, mesh.size("pipe"))
    if fsdp and mesh.size("data") > 1:
        return fsdp_param_specs(config, mesh.size("data"), fsdp_min_size, ep)
    return {name: (spec,) for name, spec in param_specs(config, ep).items()}


def _shard_index(mesh, axes) -> tuple[int, int]:
    """(this rank's block, blocks) over `axes`, the first axis major."""
    idx, count = 0, 1
    for axis in axes:
        idx, count = idx * mesh.size(axis) + mesh.rank(axis), count * mesh.size(axis)
    return idx, count


def _copy_to(t: torch.Tensor, device, like: torch.Tensor) -> torch.Tensor:
    """A dense copy of `t` on `device` in the storage order of `like` (a
    slice of a transposed view stays transposed: an untied head's [d, V]
    view of [V, d] storage)."""
    perm = _storage_order(like)
    out = torch.empty([t.shape[i] for i in perm], dtype=t.dtype, device=device)
    return out.permute(sorted(range(len(perm)), key=perm.__getitem__)).copy_(t)


def shard_params(params: dict, mesh, config: Qwen3Config, ep: int = 1, fsdp: bool = False,
                 fsdp_min_size: int = FSDP_MIN_SIZE) -> dict:
    """This rank's slices of full `params` (or any tree of their shape),
    copied to the mesh's device; with `fsdp` (and dp > 1) the ZeRO-3 layout."""
    return _cut(params, mesh, _layout(mesh, config, ep, fsdp, fsdp_min_size))


def _cut(tree: dict, mesh, layout: dict) -> dict:
    """This rank's slices of a tree of full values, per `layout` ({leaf
    name: ((dim, axes), ...)}), copied to the mesh's device."""
    names, leaves = _flatten(tree)
    out = []
    for path, full in zip(names, leaves):
        t = full
        for dim, axes in layout.get(path[-1], ()):
            idx, count = _shard_index(mesh, axes)
            if t.shape[dim] % count:
                raise ValueError(f"{'/'.join(path)} dim {dim} ({t.shape[dim]}) does not divide by {count}")
            size = t.shape[dim] // count
            t = t.narrow(dim, idx * size, size)
        out.append(_copy_to(t, mesh.device, full))
    return _unflatten(tree, names, out)


def gather_params(local: dict, mesh, config: Qwen3Config, ep: int = 1, fsdp: bool = False,
                  fsdp_min_size: int = FSDP_MIN_SIZE) -> dict:
    """Full params (or any tree of their shape, grads and optimizer moments
    included) from every rank's slices; every rank of the mesh calls it and
    gets the whole."""
    layout = _layout(mesh, config, ep, fsdp, fsdp_min_size)
    names, leaves = _flatten(local)
    out = []
    for path, t in zip(names, leaves):
        for dim, axes in reversed(layout.get(path[-1], ())):
            for axis in reversed(axes):  # the minor axis first: blocks in major-first order
                group = mesh.group(axis)
                if group is not None:
                    t = _gather_blocks(t, group, dim) if axis == "data" else all_gather_dim(t, group, dim)
        out.append(t)
    return _unflatten(local, names, out)


def global_sum_squares(mesh, config: Qwen3Config, ep: int = 1, fsdp: bool = False,
                       fsdp_min_size: int = FSDP_MIN_SIZE):
    """grads -> Σ g² over the whole model, for the optimizer's clip: each
    leaf's squares summed over the axes it shards over ("model", "data" or
    both: the experts under expert parallelism, a ZeRO-3 leaf; "pipe": each
    stage's layers) and a replicated leaf counted once."""
    layout = _layout(mesh, config, ep, fsdp, fsdp_min_size)
    pipe = mesh.group("pipe")

    def sum_squares(grads: dict) -> torch.Tensor:
        names, leaves = _flatten(grads)
        # by (over data, over model), and the same for the leaves cut over "pipe"
        parts = torch.zeros(8 if pipe is not None else 4, dtype=torch.float32, device=leaves[0].device)
        for path, g in zip(names, leaves):
            axes = {a for _, over in layout.get(path[-1], ()) for a in over}
            at = 4 * ("pipe" in axes) + 2 * ("data" in axes) + ("model" in axes)
            parts[at] += torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
        if pipe is not None:  # each stage's layers, then as the leaves of one stage
            parts = parts[:4] + all_reduce_(parts[4:].clone(), pipe)
        over_model = all_reduce_(parts[1::2].clone(), mesh.group("model"))  # model only, both
        over_data = all_reduce_(torch.stack([parts[2], over_model[1]]), mesh.group("data"))
        return parts[0] + over_model[0] + over_data.sum()

    return sum_squares


# ------------------------------------------------------------------ batches


@dataclasses.dataclass
class SeqShard:
    """This rank's part of a sequence-parallel batch: its rows
    [me · n_loc, (me + 1) · n_loc) of the data rank's trie, the edges whose
    parent it owns (``arrays``: edge_parent / edge_token / edge_w and, for
    a custom loss, ce_parent / ce_token / ce_child, on the device) and
    under the ring its ``RingPair`` of each ring step."""

    sp: int
    me: int
    n_loc: int
    arrays: dict
    ring: list | None = None

    @property
    def rows(self) -> slice:
        return slice(self.me * self.n_loc, (self.me + 1) * self.n_loc)


@dataclasses.dataclass
class StackedBatch:
    """Per-rank packed tries padded to one bucket, and the device batches
    of the data ranks this process holds."""

    packeds: list  # host PackedTries, one per data rank
    batches: list | None = None  # the TrieBatch of each rank of `ranks`, on the engine's device
    ranks: list = dataclasses.field(default_factory=lambda: [0])  # the data ranks of `batches`
    # its rank's custom-loss extras (x_<name>) on that device
    on_device: dict = dataclasses.field(default_factory=dict)
    seq: SeqShard | None = None  # this rank's sequence shard (sp > 1)

    @property
    def dp(self) -> int:
        return len(self.packeds)

    def add(self, name: str, array: np.ndarray) -> None:
        """Upload this process's row of a host array [dp, ...] to the
        batch's device (an upload before the step, not in it)."""
        if self.batches is None:
            raise ValueError("the batch was stacked without an engine: stack_batches(..., engine=step.engine)")
        self.on_device[name] = torch.from_numpy(np.ascontiguousarray(array[self.ranks[0]])).to(
            self.batches[0].tokens.device)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _edge_arrays(packeds: list, sp: int, n_pad: int) -> dict:
    """Parent-owned edge triples [dp, sp, E] (JAX ``_edge_arrays``): edge j
    (its child position, weight non-zero) belongs to the seq rank holding
    parent[j], as (local parent, child token, weight); padding slots carry
    weight 0 and index 0 (in range, inert)."""
    n_loc = n_pad // sp
    rows, width = [], 1
    for p in packeds:
        j = np.nonzero((p.parent >= 0) & (p.w_logprob != 0))[0]
        par = p.parent[j]
        owner = par // n_loc
        per_rank = []
        for s in range(sp):
            m = owner == s
            per_rank.append((par[m] - s * n_loc, p.tokens[j[m]], p.w_logprob[j[m]]))
            width = max(width, int(m.sum()))
        rows.append(per_rank)
    width = _next_pow2(width)
    out = {"edge_parent": np.zeros((len(packeds), sp, width), np.int32),
           "edge_token": np.zeros((len(packeds), sp, width), np.int32),
           "edge_w": np.zeros((len(packeds), sp, width), np.float32)}
    for r, per_rank in enumerate(rows):
        for s, vals in enumerate(per_rank):
            for key, val in zip(out, vals):
                out[key][r, s, :len(val)] = val
    return out


def _custom_edge_arrays(packeds: list, sp: int, n_pad: int) -> dict:
    """Parent-owned edge triples [dp, sp, E] of the custom loss (JAX
    ``_custom_edge_arrays``): every real edge as (local parent, child token,
    GLOBAL child position); padding slots point their child at n_pad, which
    ``vp_tree_edge_logprobs_sp`` scatters into a spare row it drops."""
    n_loc = n_pad // sp
    rows, width = [], 1
    for p in packeds:
        j = np.nonzero(p.parent >= 0)[0]
        par = p.parent[j]
        owner = par // n_loc
        per_rank = []
        for s in range(sp):
            m = owner == s
            per_rank.append((par[m] - s * n_loc, p.tokens[j[m]], j[m]))
            width = max(width, int(m.sum()))
        rows.append(per_rank)
    width = _next_pow2(width)
    out = {"ce_parent": np.zeros((len(packeds), sp, width), np.int32),
           "ce_token": np.zeros((len(packeds), sp, width), np.int32),
           "ce_child": np.full((len(packeds), sp, width), n_pad, np.int32)}
    for r, per_rank in enumerate(rows):
        for s, vals in enumerate(per_rank):
            for key, val in zip(out, vals):
                out[key][r, s, :len(val)] = val
    return out


def _seq_shard(packeds: list, mesh, cfg: EngineConfig, sp_mode: str, engine, with_paths: bool) -> SeqShard:
    """This rank's ``SeqShard`` (uploaded to the engine's device)."""
    from dynamictreeattn_tpu_torch.ops.tree_attention_ring import RING_META_FIELDS, ring_pairs  # (imports parallel)

    d, me, sp = mesh.rank("data"), mesh.rank("seq"), mesh.size("seq")
    packed = packeds[d]
    n_pad = packed.n_padded
    host = _edge_arrays(packeds, sp, n_pad)
    if with_paths:
        host.update(_custom_edge_arrays(packeds, sp, n_pad))
    arrays = {k: torch.from_numpy(np.ascontiguousarray(v[d, me])).to(engine.device) for k, v in host.items()}
    ring = None
    if sp_mode == "ring":
        meta = build_ring_block_meta(packed.last_desc, sp, cfg.block_q, cfg.block_kv)
        lc = engine.mc
        ring = ring_pairs(packed.last_desc, {f: getattr(meta, f) for f in RING_META_FIELDS}, me, sp, cfg.block_q,
                          cfg.block_kv, engine.device, lc.num_key_value_heads, lc.head_dim,
                          work=engine.ring_work_lists())
    return SeqShard(sp=sp, me=me, n_loc=n_pad // sp, arrays=arrays, ring=ring)


def stack_batches(tries_or_packed: list, cfg: EngineConfig, sp: int = 1, sp_mode: str = "ulysses",
                  engine: TreeEngine | None = None, with_paths: bool = False, mesh=None) -> StackedBatch:
    """Flatten and pad each rank's trie to a common bucket (JAX
    ``stack_batches``), its length a multiple of sp (of sp · lcm(block_q,
    block_kv) under the ring, so that every shard is whole blocks); with
    `engine`, the ``TrieBatch`` on the engine's device of every rank, or on
    a mesh of this rank's data rank only (rank r prepares ``packeds[r]``),
    and with sp > 1 this rank's ``SeqShard``; with `with_paths` its path
    matrix of a custom loss, uploaded now. sp > 1 needs the mesh."""
    if sp_mode not in ("ulysses", "ring"):
        raise ValueError(f"unknown sp_mode {sp_mode!r}")
    if sp > 1 and mesh is None:
        raise ValueError(f"sp={sp}: sequence parallelism needs a mesh (parallel.make_mesh(sp=...))")
    if mesh is not None and sp != mesh.size("seq"):
        raise ValueError(f"sp={sp} for a mesh of {mesh.shape}")
    if sp > 1 and engine is not None and (getattr(engine, "sp", 1), getattr(engine, "sp_mode", None)) != (sp, sp_mode):
        raise ValueError(f"a batch of sp={sp}, {sp_mode!r} for a step of sp={getattr(engine, 'sp', 1)}, "
                         f"{getattr(engine, 'sp_mode', None)!r}")
    with span("prepare.flatten"):
        packeds = [flatten_trie(t) if isinstance(t, TokenTrie) else t for t in tries_or_packed]
        if mesh is not None and len(packeds) != mesh.size("data"):
            raise ValueError(f"{len(packeds)} tries for a mesh of dp={mesh.size('data')}")
        quantum = sp * (math.lcm(cfg.block_q, cfg.block_kv) if sp_mode == "ring" else 1)
        n_pad = cfg.bucket_length(max(p.n_padded for p in packeds))
        while n_pad % quantum:
            n_pad = cfg.bucket_length(n_pad + 1)
        packeds = [_pad_packed(p, n_pad) if p.n_padded != n_pad else p for p in packeds]
    ranks = list(range(len(packeds))) if mesh is None else [mesh.rank("data")]
    batches = None if engine is None else [engine.prepare(packeds[r]) for r in ranks]
    if with_paths and batches is not None:
        with span("prepare.upload"):
            for b in batches:  # uploaded now, not inside the step
                engine.seq_gather_arrays(b)
    seq = None
    if sp > 1 and engine is not None:
        with span("prepare.meta"):
            seq = _seq_shard(packeds, mesh, cfg, sp_mode, engine, with_paths)
    return StackedBatch(packeds=packeds, batches=batches, ranks=ranks, seq=seq)


def _rank_batch(batch: StackedBatch) -> TrieBatch:
    """The one device batch this process trains on."""
    if len(batch.ranks) != 1:
        raise ValueError(f"a batch of {batch.dp} data ranks needs a step over a mesh of dp={batch.dp} "
                         "(make_train_step(..., mesh=make_mesh(dp=...)))")
    if batch.batches is None:
        raise ValueError("the batch was stacked without an engine: stack_batches(..., engine=step.engine)")
    return batch.batches[0]


# -------------------------------------------------------------------- steps


class ShardedEngine(TreeEngine):
    """``TreeEngine`` on this rank's shards: the tensor-parallel model
    (``tp_model.forward_hidden_tp``) and the vocab-parallel head
    (``vocab_parallel``; at tp = 1 without expert parallelism the one-device
    head path, so that a ZeRO-3 step at tp = 1 computes what the one-device
    engine does). It holds the rank's attention config (``local_config``:
    its heads; under Ulysses the full sequence's hkv/(tp·sp) kv heads), so
    that ``prepare`` sizes the kernels' work lists for them. With
    `fsdp_dims` (``fsdp_dims``) it gathers the ZeRO-3 leaves: the embedding
    and head once a step (``_step_params``), each layer's inside the layer.
    Under sequence parallelism (the mesh's "seq" axis) the step runs on the
    rank's rows (``sp_loss_and_grad``), the backward is "fused" where
    "cached" is asked for (JAX's rule: no slot schedule under sp), and the
    ring builds its work lists per pair (``stack_batches``) and none for
    the whole sequence."""

    def __init__(self, model_config: Qwen3Config, config: EngineConfig, mesh, ep: int = 1,
                 sp_mode: str = "ulysses", fsdp_dims: dict | None = None):
        tp, sp = mesh.size("model"), mesh.size("seq")
        heads = tp * (sp if sp > 1 and sp_mode == "ulysses" else 1)
        super().__init__(local_config(model_config, heads), config, device=mesh.device)
        self.full_mc, self.mesh, self.ep, self.sp, self.sp_mode = model_config, mesh, ep, sp, sp_mode
        self.fsdp = _flat_dims(fsdp_dims)
        self.cached_backward = sp == 1

    def ring_work_lists(self) -> bool:
        """Whether the ring's pairs need the kernels' work lists (the card's)."""
        return TreeEngine._wants_qmajor_work(self) and TreeEngine._wants_kmajor_work(self)

    def _wants_qmajor_work(self) -> bool:
        return not (self.sp > 1 and self.sp_mode == "ring") and super()._wants_qmajor_work()

    def _wants_kmajor_work(self) -> bool:
        return not (self.sp > 1 and self.sp_mode == "ring") and super()._wants_kmajor_work()

    def _step_params(self, params):
        if not self.fsdp:
            return params
        group = self.mesh.group("data")
        return {name: fsdp_gather(val, group, self.fsdp[name]) if name in ("embed", "lm_head") else val
                for name, val in params.items()}

    def _unshard(self, lp: dict) -> dict:
        """One layer's leaves gathered over "data" (the stacked dim gone:
        the gather dim is the fsdp dim - 1)."""
        group = self.mesh.group("data")
        return {name: fsdp_gather(w, group, self.fsdp.get(name, -1) - 1) if self.fsdp.get(name, -1) >= 0 else w
                for name, w in lp.items()}

    def _ring_attn_fn(self, batch: TrieBatch, seq: SeqShard):
        from dynamictreeattn_tpu_torch.ops.tree_attention_ring import (  # (it imports parallel)
            tree_attention_ring, tree_attention_ring_reference,
        )

        group = self.mesh.group("seq")
        if self.cfg.attn_backend == "reference":
            return lambda q, k, v, handoff=None: tree_attention_ring_reference(q, k, v, batch.last_desc, group)
        bs = BlockSizes(self.cfg.block_q, self.cfg.block_kv)
        return lambda q, k, v, handoff=None: tree_attention_ring(q, k, v, batch.last_desc, seq.ring, group,
                                                                 block_sizes=bs, handoff=handoff)

    def _hidden_aux(self, params, batch: TrieBatch, train: bool, seq: SeqShard | None = None):
        cfg = self.cfg
        tokens, depth, valid = batch.tokens, batch.depth, batch.valid
        if seq is not None:  # this rank's rows
            tokens, depth, valid = tokens[seq.rows], depth[seq.rows], valid[seq.rows]
        attn = self._ring_attn_fn(batch, seq) if seq is not None and self.sp_mode == "ring" else self._attn_fn(batch)
        return forward_hidden_tp(params, self.full_mc, tokens, depth, attn, self.mesh,
                                 remat=train and cfg.remat, remat_policy=cfg.remat_policy if train else None,
                                 remat_segments=cfg.remat_segments if train else 0, ep=self.ep,
                                 valid=valid, fused_qk=resolve_fused_qk(cfg),
                                 unshard_fn=self._unshard if self.fsdp else None,
                                 sp=1 if seq is None else seq.sp, sp_mode=self.sp_mode)

    def _edge_stats(self, params, hidden, batch: TrieBatch):
        if self.mesh.size("model") == 1 and self.ep == 1:
            return super()._edge_stats(params, hidden, batch)
        return vp_tree_edge_logprobs(hidden, lm_head_weight(params, self.mc), batch.tokens, batch.parent,
                                     self.cfg.temperature, self.cfg.loss_chunk, self.mesh,
                                     mode=resolve_loss_mode(self.cfg))

    def sp_loss_and_grad(self, params, batch: TrieBatch, seq: SeqShard, custom_loss=None, extras=None):
        """(loss, grads, aux) of this rank's rows (JAX's sp loss paths):
        the linear loss over the edges whose parent the rank owns
        (``vp_tree_loss_edges``), or `custom_loss` on the whole edge
        log-prob and entropy vectors (``vp_tree_edge_logprobs_sp``) with the
        loss and aux divided by sp, as every rank computes it whole; a MoE
        model adds router_aux_coef · lb (each rank's lb is 1/sp of the
        pooled term). The caller sums everything over "seq"."""
        cfg = self.cfg
        mode, a = resolve_loss_mode(cfg), seq.arrays

        def total(p):
            p = self._step_params(p)
            hidden, faux = self._hidden_aux(p, batch, True, seq)
            w = lm_head_weight(p, self.mc)
            if custom_loss is None:
                loss, aux = vp_tree_loss_edges(hidden, w, a["edge_parent"], a["edge_token"], a["edge_w"],
                                               batch.w_entropy[seq.rows], cfg.temperature, cfg.loss_chunk,
                                               self.mesh, mode=mode)
            else:
                lp_edge, entropy = vp_tree_edge_logprobs_sp(hidden, w, a["ce_parent"], a["ce_token"], a["ce_child"],
                                                            batch.n_padded, cfg.temperature, cfg.loss_chunk,
                                                            self.mesh, mode=mode)
                loss, aux = self._custom_terms(lp_edge, entropy, batch, custom_loss, extras or {}, True)
                loss, aux = loss / seq.sp, {k: v / seq.sp for k, v in aux.items()}
            return self._router_aux(loss, aux, faux)

        loss, grads, aux = _value_and_grad(total, params)
        return loss, grads, {k: v.detach() for k, v in aux.items()}


def _engine(mc: Qwen3Config, ec: EngineConfig, device, dp: int, tp: int, sp: int, sp_mode: str, ep: bool,
            fsdp: bool, fsdp_min_size: int, mesh):
    """(engine, expert-parallel degree, ZeRO-3 dims or None) of a step."""
    if mc.is_mla and (mesh is not None or ep or fsdp):
        raise NotImplementedError("latent attention (DeepSeek-V3 / MLA) models under tensor, sequence, expert or "
                                  "data parallelism or ZeRO-3: not ported (one device only)")
    if ep and not mc.is_moe:
        raise ValueError("ep=True requires a MoE model config")
    if sp_mode not in ("ulysses", "ring"):
        raise ValueError(f"unknown sp_mode {sp_mode!r}")
    if mesh is None:
        if (dp or 1) > 1 or (tp or 1) > 1 or sp > 1:
            raise ValueError(f"dp={dp}, tp={tp}, sp={sp}: more than one rank needs a mesh (parallel.make_mesh)")
        return TreeEngine(mc, ec, device=device), 1, None
    if mesh.size("pipe") > 1:
        raise ValueError(f"a mesh of {mesh.shape} has pipeline stages: its step is pipeline.make_pp_train_step")
    if ((dp, tp) != (None, None) and (dp or 1, tp or 1) != (mesh.size("data"), mesh.size("model"))) or \
            sp not in (1, mesh.size("seq")):
        raise ValueError(f"dp={dp}, tp={tp}, sp={sp} disagree with a mesh of {mesh.shape}: the mesh sets the degrees")
    tp, dp, sp = mesh.size("model"), mesh.size("data"), mesh.size("seq")
    tp_param_shard_info(mc, tp)
    if sp > 1 and sp_mode == "ulysses" and (mc.num_key_value_heads // tp) % sp:
        raise ValueError(f"seq parallel sp={sp} must divide local kv heads {mc.num_key_value_heads // tp} (= "
                         f"{mc.num_key_value_heads} kv heads / tp={tp}); use sp_mode='ring' for larger sp")
    ep_size = dp if ep else 1
    if ep_size > 1 and (mc.num_experts % ep_size or (mc.num_experts // ep_size) % tp):
        raise ValueError(f"experts {mc.num_experts} must divide ep={ep_size} × tp={tp}")
    dims = fsdp_dims(mc, dp, fsdp_min_size, ep_size) if fsdp and dp > 1 else None
    if tp == 1 and ep_size == 1 and sp == 1 and dims is None:  # data parallelism alone: the one-device engine
        return TreeEngine(mc, ec, device=mesh.device), 1, None
    return ShardedEngine(mc, ec, mesh, ep_size, sp_mode, dims), ep_size, dims


def _reduce_step(mesh, loss, grads: dict, aux: dict, ep: int, dims: dict | None):
    """JAX's grad bookkeeping (module docstring), in place on `grads`."""
    names, leaves = _flatten(grads)
    keys = list(aux)

    def sums(group):
        return all_reduce_(torch.stack([loss.float(), *(aux[k].float() for k in keys)]), group)

    seq = mesh.group("seq")
    if seq is not None:
        for g in leaves:
            all_reduce_(_dense_view(g), seq)
        total = sums(seq)
        loss, aux = total[0], dict(zip(keys, total[1:]))
    layers = grads["layers"]
    for name in ("q_norm", "k_norm"):
        if name in layers:
            all_reduce_(layers[name], mesh.group("model"))
    group = mesh.group("data")
    if group is None:
        return loss, grads, aux
    fsdp = _flat_dims(dims)
    for path, g in zip(names, leaves):
        if not (ep > 1 and path[-1] in EXPERT_LEAVES) and fsdp.get(path[-1], -1) < 0:
            all_reduce_(_dense_view(g), group)
    total = sums(group)
    return total[0], grads, dict(zip(keys, total[1:]))


def _dense_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous view of a dense tensor's storage (its dims ordered by
    stride: an untied head's [d, V] view becomes [V, d])."""
    if t.is_contiguous():
        return t
    view = t.permute(_storage_order(t))
    if not view.is_contiguous():
        raise ValueError(f"a tensor of strides {t.stride()} is not dense")
    return view


def make_train_step(model_config: Qwen3Config, engine_config: EngineConfig = EngineConfig(),
                    optimizer=None, custom_loss=None, device="cuda", dp: int | None = None,
                    tp: int | None = None, sp: int = 1, sp_mode: str = "ulysses", fsdp: bool = False,
                    fsdp_min_size: int = FSDP_MIN_SIZE, ep: bool = False, mesh=None):
    """The training step: on one device (no `mesh`) the ``TreeEngine``
    step, on a `mesh` (``parallel.make_mesh``) this rank's step on its
    shards with the grads reduced as the JAX step reduces them (module
    docstring); params from ``shard_params`` (with the same `fsdp`). `ep`
    (a MoE model) shards the experts over "data" too, exchanging tokens by
    all-to-all. `fsdp` (dp > 1) keeps the params ZeRO-3-sharded over
    "data": each layer gathered inside its remat'd body (again in the
    recompute), the embedding and head once a step, and the gathers'
    backward reduce-scatters the grads. Over a mesh with a "seq" axis
    `sp_mode` picks the sequence parallelism: "ulysses" (all-to-all to a
    kv-head shard; sp must divide the local kv heads) or "ring" (the K/V
    chunks rotate; any sp whose shards are whole blocks). The mesh sets the
    degrees: `dp`, `tp` and `sp`, where given, must equal its sizes
    (without a mesh, above 1 they raise).

    Without `optimizer`: step(params, batch) -> (loss, grads, aux). With one
    (``training.trainer.OptaxAdamW``): step(params, opt_state, batch,
    mark=None) -> (params, opt_state, loss, aux), the optimizer applied in
    place on the device and skipped there (params and state bit-unchanged)
    when the loss is not finite, so that the step reads nothing back to the
    host; `mark(name)` is called after the engine's step ("engine") and by
    the optimizer. Scalars stay device tensors. The batch comes from
    ``stack_batches(..., engine=step.engine, mesh=mesh)`` (with the mesh's
    sp and this `sp_mode`).

    `custom_loss(lp_rows, ent_rows, extras, length) -> scalar` replaces the
    linear weighted loss through ``TreeEngine.loss_and_grad_custom`` (aux
    the sums of the sequences' log-probs and entropies): the batch comes
    from ``stack_batches(with_paths=True)`` and carries one ``x_<name>``
    array [dp, S, ...] per extra (``StackedBatch.add``). For a MoE model the
    loss adds router_aux_coef · lb_loss and aux holds "lb_loss", with the
    linear loss and with a custom one, as in the JAX step."""
    engine, ep_size, dims = _engine(model_config, engine_config, device, dp, tp, sp, sp_mode, ep, fsdp,
                                    fsdp_min_size, mesh)

    def grad_step(params, batch: StackedBatch):
        tb = _rank_batch(batch)
        extras = {k[2:]: v for k, v in batch.on_device.items()}
        if batch.seq is not None:
            loss, grads, aux = engine.sp_loss_and_grad(params, tb, batch.seq, custom_loss, extras)
        elif custom_loss is None:
            loss, grads, aux = engine.loss_and_grad(params, tb)
        else:
            loss, grads, aux = engine.loss_and_grad_custom(params, tb, custom_loss, extras, with_aux=True,
                                                           router_aux=True)
        if mesh is not None:
            loss, grads, aux = _reduce_step(mesh, loss, grads, aux, ep_size, dims)
        return loss, grads, aux

    grad_step.engine = engine
    if optimizer is None:
        return grad_step

    def opt_step(params, opt_state, batch: StackedBatch, mark=None):
        loss, grads, aux = grad_step(params, batch)
        if mark:
            mark("engine")
        params, opt_state = optimizer.update(grads, opt_state, params, torch.isfinite(loss), mark)
        return params, opt_state, loss, aux

    opt_step.engine = engine
    return opt_step


def make_forward_step(model_config: Qwen3Config, engine_config: EngineConfig = EngineConfig(),
                      device="cuda", dp: int | None = None, tp: int | None = None, sp: int = 1, ep: bool = False,
                      fsdp: bool = False, fsdp_min_size: int = FSDP_MIN_SIZE, mesh=None):
    """Inference-mode per-edge log-probs: step(params, batch) -> (lp_edge
    [dp, n], entropy [dp, n]) fp32 on the device, every data rank's rows
    (gathered over "data" on a mesh); `extract_forward` maps them back to
    sequences. `fsdp` must match the params' layout, as in
    ``make_train_step``. A mesh with a "seq" axis raises, as in JAX."""
    if sp > 1 or (mesh is not None and mesh.size("seq") > 1):
        raise ValueError("make_forward_step does not shard over 'seq' yet: a seq-axis mesh would run the full "
                         "forward on every seq rank")
    engine, _, _ = _engine(model_config, engine_config, device, dp, tp, 1, "ulysses", ep, fsdp, fsdp_min_size, mesh)

    def step(params, batch: StackedBatch):
        lp, ent = engine.logprobs(params, _rank_batch(batch))
        if mesh is None:
            return lp[None], ent[None]
        out = all_gather_dim(torch.stack([lp, ent])[:, None], mesh.group("data"), dim=1)
        return out[0], out[1]

    step.engine = engine
    return step


def extract_forward(batch: StackedBatch, lp_edge) -> list:
    """Per data rank: {_sequence_batch_id: fp32 log-prob array of length
    len(seq)-1} from a ``make_forward_step`` result."""
    lp = lp_edge.detach().cpu().numpy() if isinstance(lp_edge, torch.Tensor) else np.asarray(lp_edge)
    out = []
    for r, packed in enumerate(batch.packeds):
        m = packed.seq_paths_matrix()
        out.append({int(packed.seq_batch_ids[s]): lp[r, m[s, 1:int(packed.seq_lens[s])]]
                    for s in range(len(packed.seq_batch_ids))})
    return out
