"""Training and forward steps over stacked trie batches, on one device or a mesh.

Counterpart of ``dynamictreeattn_tpu/parallel/train.py`` without FSDP and
sequence parallelism, in PyTorch's idiom: one process per rank, the JAX
``shard_map`` body as each rank's own step, its ``psum``s as collectives
over the mesh's process groups (``parallel/mesh.py``).

* ``param_specs`` / ``shard_params`` / ``gather_params``: the Megatron
  layout over "model" (JAX ``param_specs``) — the vocabulary-sharded
  embedding (the tied head shares the shard), heads, MLP columns and rows,
  experts; with expert parallelism the experts shard data-major over
  ("data", "model"). ``shard_params`` cuts full params into this rank's
  slices (the port's ``NamedSharding``), ``gather_params`` puts them back
  together (checkpoints, the sampler).
* ``stack_batches`` pads every rank's trie to one common bucket and, given
  an engine, builds the device batch of the ranks this process holds: all
  of them on one device, its own data rank's on a mesh (the JAX package
  stacks host arrays for its mesh; a rank reads only its own).
* ``make_train_step`` / ``make_forward_step``: on one device the
  ``TreeEngine`` step; on a mesh, each rank's step on its shards
  (``ShardedEngine``: the tensor-parallel model of ``tp_model.py`` and the
  vocab-parallel loss of ``vocab_parallel.py``) and JAX's grad bookkeeping:
  q_norm / k_norm grads summed over "model" (each rank's covers its heads),
  every grad but the experts' under expert parallelism summed over "data",
  and the loss and aux summed over "data". With an optimizer, its
  non-finite skip reads the summed loss, so every rank skips together.

FSDP, sequence and pipeline parallelism and multi-host runs are not ported
yet: asking for them raises (``check_single_device``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dynamictreeattn_tpu_torch.engine.tree_engine import (
    EngineConfig, TreeEngine, TrieBatch, _flatten, _unflatten, resolve_fused_qk, resolve_loss_mode,
)
from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config, lm_head_weight
from dynamictreeattn_tpu_torch.parallel.collectives import all_gather_dim, all_reduce_
from dynamictreeattn_tpu_torch.parallel.tp_model import forward_hidden_tp, local_config, tp_param_shard_info
from dynamictreeattn_tpu_torch.parallel.vocab_parallel import vp_tree_edge_logprobs
from dynamictreeattn_tpu_torch.tries import TokenTrie, flatten_trie
from dynamictreeattn_tpu_torch.tries.flatten import _pad_packed

__all__ = ["ShardedEngine", "StackedBatch", "check_single_device", "extract_forward", "gather_params",
           "global_sum_squares", "make_forward_step", "make_train_step", "param_specs", "shard_params",
           "stack_batches"]


def check_single_device(**settings) -> None:
    """Raise for the parallel settings not ported yet: fsdp=, multihost=
    flags on, sp= or pp= degrees above 1 (ROADMAP queue 1 item 10)."""
    over = {name: v for name, v in settings.items()
            if not (v is None or v is False or (type(v) is int and v == 1))}
    if over:
        raise ValueError(f"{over}: not ported yet (ROADMAP queue 1 item 10: FSDP, sequence and pipeline "
                         "parallelism, multi-host)")


# ------------------------------------------------------------------ layouts

EXPERT_LEAVES = ("e_gate", "e_up", "e_down")
# leaf name -> the dim it shards over "model" (the stacked layer dim is 0)
_MODEL_DIMS = {"embed": 0, "lm_head": 1, "wq": 2, "wk": 2, "wv": 2, "wo": 1, "gate": 2, "up": 2, "down": 1,
               "bq": 1, "bk": 1, "bv": 1, "e_gate": 1, "e_up": 1, "e_down": 1}


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


def _shard_index(mesh, axes) -> tuple[int, int]:
    """(this rank's block, blocks) over `axes`, the first axis major."""
    idx, count = 0, 1
    for axis in axes:
        idx, count = idx * mesh.size(axis) + mesh.rank(axis), count * mesh.size(axis)
    return idx, count


def _copy_to(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of `t` on `device` with its layout (a dense view keeps its
    strides: an untied head stays a [d, V] view of [V, d] storage)."""
    return torch.empty_like(t, device=device, memory_format=torch.preserve_format).copy_(t)


def shard_params(params: dict, mesh, config: Qwen3Config, ep: int = 1) -> dict:
    """This rank's slices of full `params`, copied to the mesh's device."""
    specs = param_specs(config, ep)
    names, leaves = _flatten(params)
    out = []
    for path, t in zip(names, leaves):
        spec = specs.get(path[-1])
        if spec is not None:
            dim, axes = spec
            idx, count = _shard_index(mesh, axes)
            if t.shape[dim] % count:
                raise ValueError(f"{'/'.join(path)} dim {dim} ({t.shape[dim]}) does not divide by {count}")
            size = t.shape[dim] // count
            t = t.narrow(dim, idx * size, size)
        out.append(_copy_to(t, mesh.device))
    return _unflatten(params, names, out)


def gather_params(local: dict, mesh, config: Qwen3Config, ep: int = 1) -> dict:
    """Full params (or any tree of their shape, grads and optimizer moments
    included) from every rank's slices; every rank of the mesh calls it and
    gets the whole."""
    specs = param_specs(config, ep)
    names, leaves = _flatten(local)
    out = []
    for path, t in zip(names, leaves):
        spec = specs.get(path[-1])
        if spec is not None:
            dim, axes = spec
            for axis in reversed(axes):  # the minor axis first: blocks in major-first order
                t = all_gather_dim(t, mesh.group(axis), dim)
        out.append(t)
    return _unflatten(local, names, out)


def global_sum_squares(mesh, config: Qwen3Config, ep: int = 1):
    """grads -> Σ g² over the whole model, for the optimizer's clip: the
    squares of a model-sharded leaf summed over "model", of an expert leaf
    under expert parallelism over "data" and "model", and a replicated leaf
    counted once."""
    specs = param_specs(config, ep)

    def sum_squares(grads: dict) -> torch.Tensor:
        names, leaves = _flatten(grads)
        parts = torch.zeros(3, dtype=torch.float32, device=leaves[0].device)  # replicated, model, all ranks
        for path, g in zip(names, leaves):
            spec = specs.get(path[-1])
            kind = 0 if spec is None else len(spec[1])
            parts[kind] += torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
        sharded = all_reduce_(parts[1:].clone(), mesh.group("model"))
        sharded[1:] = all_reduce_(sharded[1:].clone(), mesh.group("data"))
        return parts[0] + sharded.sum()

    return sum_squares


# ------------------------------------------------------------------ batches


@dataclasses.dataclass
class StackedBatch:
    """Per-rank packed tries padded to one bucket, and the device batches
    of the data ranks this process holds."""

    packeds: list  # host PackedTries, one per data rank
    batches: list | None = None  # the TrieBatch of each rank of `ranks`, on the engine's device
    ranks: list = dataclasses.field(default_factory=lambda: [0])  # the data ranks of `batches`
    # its rank's custom-loss extras (x_<name>) on that device
    on_device: dict = dataclasses.field(default_factory=dict)

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


def stack_batches(tries_or_packed: list, cfg: EngineConfig, sp: int = 1, sp_mode: str = "ulysses",
                  engine: TreeEngine | None = None, with_paths: bool = False, mesh=None) -> StackedBatch:
    """Flatten and pad each rank's trie to a common bucket (JAX
    ``stack_batches``; ``sp > 1`` raises); with `engine`, the ``TrieBatch``
    on the engine's device of every rank, or on a mesh of this rank's data
    rank only (rank r prepares ``packeds[r]``); with `with_paths` its path
    matrix of a custom loss, uploaded now."""
    check_single_device(sp=sp)
    packeds = [flatten_trie(t) if isinstance(t, TokenTrie) else t for t in tries_or_packed]
    if mesh is not None and len(packeds) != mesh.size("data"):
        raise ValueError(f"{len(packeds)} tries for a mesh of dp={mesh.size('data')}")
    n_pad = cfg.bucket_length(max(p.n_padded for p in packeds))
    packeds = [_pad_packed(p, n_pad) if p.n_padded != n_pad else p for p in packeds]
    ranks = list(range(len(packeds))) if mesh is None else [mesh.rank("data")]
    batches = None if engine is None else [engine.prepare(packeds[r]) for r in ranks]
    if with_paths and batches is not None:
        for b in batches:  # uploaded now, not inside the step
            engine.seq_gather_arrays(b)
    return StackedBatch(packeds=packeds, batches=batches, ranks=ranks)


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
    (``vocab_parallel.vp_tree_edge_logprobs``). It holds the rank's
    ``local_config`` (its heads), so that ``prepare`` sizes the kernels'
    work lists for the local kv heads; every other entry point (the loss,
    the custom loss, the log-probs) is the engine's, on local grads."""

    def __init__(self, model_config: Qwen3Config, config: EngineConfig, mesh, ep: int = 1):
        super().__init__(local_config(model_config, mesh.size("model")), config, device=mesh.device)
        self.full_mc, self.mesh, self.ep = model_config, mesh, ep

    def _hidden_aux(self, params, batch: TrieBatch, train: bool):
        cfg = self.cfg
        return forward_hidden_tp(params, self.full_mc, batch.tokens, batch.depth, self._attn_fn(batch), self.mesh,
                                 remat=train and cfg.remat, remat_policy=cfg.remat_policy if train else None,
                                 remat_segments=cfg.remat_segments if train else 0, ep=self.ep,
                                 valid=batch.valid, fused_qk=resolve_fused_qk(cfg))

    def _edge_stats(self, params, hidden, batch: TrieBatch):
        return vp_tree_edge_logprobs(hidden, lm_head_weight(params, self.mc), batch.tokens, batch.parent,
                                     self.cfg.temperature, self.cfg.loss_chunk, self.mesh,
                                     mode=resolve_loss_mode(self.cfg))


def _engine(mc: Qwen3Config, ec: EngineConfig, device, dp: int, tp: int, ep: bool, mesh):
    """(engine, expert-parallel degree) of a step."""
    if ep and not mc.is_moe:
        raise ValueError("ep=True requires a MoE model config")
    if mesh is None:
        if (dp or 1) > 1 or (tp or 1) > 1:
            raise ValueError(f"dp={dp}, tp={tp}: more than one rank needs a mesh (parallel.make_mesh)")
        return TreeEngine(mc, ec, device=device), 1
    if (dp, tp) != (None, None) and (dp or 1, tp or 1) != (mesh.size("data"), mesh.size("model")):
        raise ValueError(f"dp={dp}, tp={tp} disagree with a mesh of {mesh.shape}: the mesh sets the degrees")
    tp, dp = mesh.size("model"), mesh.size("data")
    tp_param_shard_info(mc, tp)
    ep_size = dp if ep else 1
    if ep_size > 1 and (mc.num_experts % ep_size or (mc.num_experts // ep_size) % tp):
        raise ValueError(f"experts {mc.num_experts} must divide ep={ep_size} × tp={tp}")
    if tp == 1 and ep_size == 1:  # data parallelism alone: each rank runs the one-device engine
        return TreeEngine(mc, ec, device=mesh.device), 1
    return ShardedEngine(mc, ec, mesh, ep_size), ep_size


def _reduce_step(mesh, loss, grads: dict, aux: dict, ep: int):
    """JAX's grad bookkeeping (module docstring), in place on `grads`."""
    layers = grads["layers"]
    for name in ("q_norm", "k_norm"):
        if name in layers:
            all_reduce_(layers[name], mesh.group("model"))
    group = mesh.group("data")
    if group is None:
        return loss, grads, aux
    names, leaves = _flatten(grads)
    for path, g in zip(names, leaves):
        if not (ep > 1 and path[-1] in EXPERT_LEAVES):
            all_reduce_(_dense_view(g), group)
    keys = list(aux)
    sums = all_reduce_(torch.stack([loss.float(), *(aux[k].float() for k in keys)]), group)
    return sums[0], grads, dict(zip(keys, sums[1:]))


def _dense_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous view of a dense tensor's storage (its dims ordered by
    stride: an untied head's [d, V] view becomes [V, d])."""
    if t.is_contiguous():
        return t
    view = t.permute(sorted(range(t.dim()), key=lambda i: -t.stride(i)))
    if not view.is_contiguous():
        raise ValueError(f"a tensor of strides {t.stride()} is not dense")
    return view


def make_train_step(model_config: Qwen3Config, engine_config: EngineConfig = EngineConfig(),
                    optimizer=None, custom_loss=None, device="cuda", dp: int | None = None,
                    tp: int | None = None, sp: int = 1, fsdp: bool = False, ep: bool = False, mesh=None):
    """The training step: on one device (no `mesh`) the ``TreeEngine``
    step, on a `mesh` (``parallel.make_mesh``) this rank's step on its
    shards with the grads reduced as the JAX step reduces them (module
    docstring); params from ``shard_params``. `ep` (a MoE model) shards the
    experts over "data" too, exchanging tokens by all-to-all. The mesh sets
    the degrees: `dp` and `tp`, where given, must equal its sizes (without a
    mesh, above 1 they raise).

    Without `optimizer`: step(params, batch) -> (loss, grads, aux). With one
    (``training.trainer.OptaxAdamW``): step(params, opt_state, batch,
    mark=None) -> (params, opt_state, loss, aux), the optimizer applied in
    place on the device and skipped there (params and state bit-unchanged)
    when the loss is not finite, so that the step reads nothing back to the
    host; `mark(name)` is called after the engine's step ("engine") and by
    the optimizer. Scalars stay device tensors. The batch comes from
    ``stack_batches(..., engine=step.engine, mesh=mesh)``.

    `custom_loss(lp_rows, ent_rows, extras, length) -> scalar` replaces the
    linear weighted loss through ``TreeEngine.loss_and_grad_custom`` (aux
    the sums of the sequences' log-probs and entropies): the batch comes
    from ``stack_batches(with_paths=True)`` and carries one ``x_<name>``
    array [dp, S, ...] per extra (``StackedBatch.add``). For a MoE model the
    loss adds router_aux_coef · lb_loss and aux holds "lb_loss", with the
    linear loss and with a custom one, as in the JAX step."""
    check_single_device(sp=sp, fsdp=fsdp)
    engine, ep_size = _engine(model_config, engine_config, device, dp, tp, ep, mesh)

    def grad_step(params, batch: StackedBatch):
        tb = _rank_batch(batch)
        if custom_loss is None:
            loss, grads, aux = engine.loss_and_grad(params, tb)
        else:
            extras = {k[2:]: v for k, v in batch.on_device.items()}
            loss, grads, aux = engine.loss_and_grad_custom(params, tb, custom_loss, extras, with_aux=True,
                                                           router_aux=True)
        if mesh is not None:
            loss, grads, aux = _reduce_step(mesh, loss, grads, aux, ep_size)
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
                      mesh=None):
    """Inference-mode per-edge log-probs: step(params, batch) -> (lp_edge
    [dp, n], entropy [dp, n]) fp32 on the device, every data rank's rows
    (gathered over "data" on a mesh); `extract_forward` maps them back to
    sequences."""
    check_single_device(sp=sp)
    engine, _ = _engine(model_config, engine_config, device, dp, tp, ep, mesh)

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
