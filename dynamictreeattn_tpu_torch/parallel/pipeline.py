"""Pipeline parallelism over the mesh's "pipe" axis: GPipe and 1F1B.

Counterpart of ``dynamictreeattn_tpu/parallel/pipeline.py``, one process per
rank. The layer stack is cut into pp contiguous stages (stage s keeps layers
[s·L/pp, (s+1)·L/pp) of every stacked leaf, on top of the "model" slicing;
``embed``, ``final_norm`` and ``lm_head`` stay on every stage), and each
data rank's M microbatch tries stream through the stages; activations hop
stage → stage, their cotangents back.

The JAX package differentiates a ``lax.scan`` over the ticks, where the
transpose of every ``ppermute`` runs on every device. Eager autograd prunes
branches that no gradient reaches (stage 0 discards what it receives), so
an autograd hop would leave one rank waiting in a collective the other
never enters. Both schedules here are therefore tick loops that call the
forward hop and the backward hop explicitly (``collectives._shift``, the
``all_to_all_single`` rotation the ring attention uses, which gloo runs on
CUDA tensors), in one order on every rank of the pipe group; the stage's
compute is an ordinary autograd graph between them, and its gradients are
taken with ``torch.autograd.grad`` per microbatch:

* ``schedule="gpipe"``: M + pp − 1 forward ticks keeping each
  microbatch's graph (memory grows with M), then the same ticks in reverse,
  each running one microbatch's backward and hopping its input cotangent
  back;
* ``schedule="1f1b"``: M + 2(pp − 1) ticks; stage s runs the forward of
  microbatch t − s (without a graph) and the backward of microbatch
  t − 2(pp−1) + s, recomputing that stage forward from its stashed input
  (a ring of 2·pp − 1 slots: memory bounded by pp, not M). The last stage's
  forward and backward fall on the same microbatch in the same tick, so it
  runs only the recomputing pass (what it would send goes to stage 0, which
  embeds instead).

Bubble ticks compute nothing and send zeros, but every rank makes every
hop. Each stage runs its layers with the engine's remat setting (per layer,
JAX's stage ignores ``remat_segments``), the tensor-parallel layer
(``tp_model._layer_tp``) without the fused qk-prep (JAX's stage leaves it
out: no K4–K7), the tree-attention backward "fused" where "cached" is
asked (no slot schedule per microbatch, JAX's rule), and on the last stage
the final norm and the LM-head statistics (vocab-parallel at tp > 1).

Gradients accumulate per microbatch in fp32 buffers and are cast to the
params' dtype once, at the end (JAX's order). JAX's bookkeeping: layer
grads stay stage-local; ``embed``, ``final_norm`` and ``lm_head`` grads
summed over "pipe" (the tied embedding: stage 0's embedding grad plus the
last stage's head grad); q_norm / k_norm summed over "model"; every grad
summed over "data"; the loss and aux (``sum_logprob``, ``sum_entropy`` and
a MoE model's per-stage ``lb_loss``) summed over "pipe" and "data".
Sequence parallelism, ZeRO-3 and expert parallelism do not combine with
the pipeline (JAX's refusals).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from dynamictreeattn_tpu_torch.engine.tree_engine import EngineConfig, TrieBatch, _flatten, _unflatten
from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config, rms_norm, rope_tables, run_layers
from dynamictreeattn_tpu_torch.parallel.collectives import _shift, all_reduce_, mpar_in
from dynamictreeattn_tpu_torch.parallel.tp_model import _embed_vp, _layer_tp, local_config
from dynamictreeattn_tpu_torch.parallel.train import (
    ShardedEngine, _cut, _dense_view, _reduce_step, pp_param_specs, stack_batches,
)

__all__ = ["StackedMicrobatch", "make_pp_train_step", "shard_params_pp", "stack_microbatches"]

SCHEDULES = ("gpipe", "1f1b")


def shard_params_pp(params: dict, mesh, config: Qwen3Config) -> dict:
    """This rank's stage and "model" slices of full `params`, on the mesh's
    device (``shard_params`` on a mesh with a "pipe" axis)."""
    return _cut(params, mesh, pp_param_specs(config, mesh.size("pipe")))


@dataclasses.dataclass
class StackedMicrobatch:
    """dp × M packed tries padded to one common bucket, data-major, and the
    device batches of this process's data rank."""

    packeds: list  # host PackedTries, [r · M + j] = data rank r's microbatch j
    dp: int
    M: int
    batches: list | None = None  # the M TrieBatches of data rank `rank`, on the engine's device
    rank: int = 0

    def row(self, r: int) -> list:
        """Data rank r's M host PackedTries."""
        return self.packeds[r * self.M:(r + 1) * self.M]


def stack_microbatches(tries: list, cfg: EngineConfig, engine=None, mesh=None) -> StackedMicrobatch:
    """[dp][M] tries → one common bucket over every microbatch (JAX
    ``stack_microbatches``: the hops need one activation shape); with
    `engine`, the TrieBatches (metadata and, on the card, the q-major and
    k-major work lists of each microbatch) of this process's data row only
    (row 0 without a mesh). No slot schedule: the pipelined step runs the
    schedule-free "fused" backward."""
    dp, M = len(tries), len(tries[0])
    if any(len(row) != M for row in tries):
        raise ValueError("every data rank needs the same microbatch count")
    if mesh is not None and dp != mesh.size("data"):
        raise ValueError(f"{dp} rows of microbatches for a mesh of dp={mesh.size('data')}")
    flat = stack_batches([t for row in tries for t in row], cfg)
    out = StackedMicrobatch(packeds=flat.packeds, dp=dp, M=M, rank=0 if mesh is None else mesh.rank("data"))
    if engine is not None:
        out.batches = [engine.prepare(p) for p in out.row(out.rank)]
    return out


class PipelineEngine(ShardedEngine):
    """``ShardedEngine`` of one pipeline stage: the rank's heads and layer
    slice, no slot schedule ("cached" runs "fused")."""

    def __init__(self, model_config: Qwen3Config, config: EngineConfig, mesh):
        super().__init__(model_config, config, mesh)
        self.cached_backward = False
        self.stage, self.pp = mesh.rank("pipe"), mesh.size("pipe")

    def stage_forward(self, params, batch: TrieBatch, x_in, train: bool):
        """(y, seed, stats) of this stage on one microbatch: the embedding
        (stage 0) or `x_in` through the stage's layers (remat as configured
        when `train`); `seed` the scalar this stage's backward starts from
        (the last stage's trie loss, plus router_aux_coef · lb of its own
        MoE layers; None for a dense middle stage), `stats` the stage's
        sum_logprob, sum_entropy and lb_loss."""
        mc, cfg, mesh = self.full_mc, self.cfg, self.mesh
        tp = mesh.size("model")
        first, last = self.stage == 0, self.stage == self.pp - 1
        if first:
            x = _embed_vp(params["embed"], batch.tokens, mesh) if tp > 1 else params["embed"][batch.tokens.long()]
        else:
            x = x_in
        cos, sin = rope_tables(batch.depth, mc.head_dim, mc.rope_theta, mc.rope_scaling_tuple)
        y, lb = run_layers(x, params["layers"], local_config(mc, tp), cos, sin, self._attn_fn(batch),
                           remat=train and cfg.remat, remat_policy=cfg.remat_policy if train else None,
                           valid=batch.valid, layer_fn=functools.partial(_layer_tp, mesh=mesh))
        zero = torch.zeros((), dtype=torch.float32, device=y.device)
        stats = {"sum_logprob": zero, "sum_entropy": zero, "lb_loss": lb}
        seed = None
        if last:
            h = mpar_in(rms_norm(y, params["final_norm"], mc.rms_norm_eps), mesh.group("model"))
            lp_edge, entropy = self._edge_stats(params, h, batch)
            stats["sum_logprob"] = torch.sum(batch.w_logprob * lp_edge)
            stats["sum_entropy"] = torch.sum(batch.w_entropy * entropy)
            seed = stats["sum_logprob"] + stats["sum_entropy"]
        if mc.is_moe and mc.router_aux_coef:
            term = mc.router_aux_coef * lb
            seed = term if seed is None else seed + term
        return y, seed, stats


def make_pp_train_step(model_config: Qwen3Config, mesh, engine_config: EngineConfig = EngineConfig(),
                       optimizer=None, schedule: str = "gpipe"):
    """The pipelined training step on this rank (module docstring).

    Without `optimizer`: step(params, batch) -> (loss, grads, aux). With one
    (``training.trainer.OptaxAdamW``): step(params, opt_state, batch,
    mark=None) -> (params, opt_state, loss, aux), the update skipped on the
    device when the summed loss is not finite, as ``make_train_step``'s.
    params from ``shard_params_pp`` (or ``shard_params`` on this mesh); the
    batch from ``stack_microbatches(..., engine=step.engine, mesh=mesh)``.
    `schedule`: "gpipe" (memory grows with M) or "1f1b" (memory bounded by
    pp)."""
    mc, ec = model_config, engine_config
    if mc.is_mla:
        raise NotImplementedError("latent attention (DeepSeek-V3 / MLA) models in a pipeline: not ported")
    if mesh.size("seq") > 1:
        raise ValueError("pipeline and sequence parallelism are exclusive")
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    pp_param_specs(mc, mesh.size("pipe"))  # raises unless pp divides the layers
    engine = PipelineEngine(mc, ec, mesh)
    run = _gpipe if schedule == "gpipe" else _one_f_one_b

    def grad_step(params, batch: StackedMicrobatch):
        if batch.batches is None or batch.rank != mesh.rank("data"):
            raise ValueError("stack the microbatches with stack_microbatches(..., engine=step.engine, mesh=mesh)")
        names, leaves = _flatten(params)
        aliases = [t.detach().requires_grad_(True) for t in leaves]
        acc = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
        totals = run(engine, _unflatten(params, names, aliases), aliases, acc, batch.batches)
        return _reduce_pp(mesh, names, leaves, acc, totals, mc.is_moe, params)

    grad_step.engine = engine
    if optimizer is None:
        return grad_step

    def opt_step(params, opt_state, batch: StackedMicrobatch, mark=None):
        loss, grads, aux = grad_step(params, batch)
        if mark:
            mark("engine")
        params, opt_state = optimizer.update(grads, opt_state, params, torch.isfinite(loss), mark)
        return params, opt_state, loss, aux

    opt_step.engine = engine
    return opt_step


def _hop(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """`x` of pipe rank (me − shift) on this rank; every rank of the group calls it."""
    return x if group is None else _shift(x, group, shift)


def _forward(engine, tree, batch, x_in, totals: dict):
    """One microbatch's stage forward under autograd, its seed and stats
    added into `totals`: (input leaf or None on stage 0, y, seed)."""
    with torch.enable_grad():
        x_leaf = None if x_in is None else x_in.detach().requires_grad_(True)
        y, seed, stats = engine.stage_forward(tree, batch, x_leaf, train=True)
    for key, val in stats.items():
        totals[key] = totals[key] + val.detach().float()
    if seed is not None:
        totals["loss"] = totals["loss"] + seed.detach().float()
    return x_leaf, y, seed


def _backward(engine, aliases, acc, x_leaf, y, seed, dy):
    """The backward of one `_forward`: param grads added into the fp32
    `acc`; returns the input cotangent (None on stage 0). A stage before
    the last seeds y with `dy`, the cotangent the next stage sent back."""
    outs, cots = ([y], [dy]) if engine.stage < engine.pp - 1 else ([], [])
    if seed is not None:
        outs.append(seed)
        cots.append(torch.ones_like(seed))
    inputs = aliases + ([x_leaf] if x_leaf is not None else [])
    grads = torch.autograd.grad(outs, inputs, cots, allow_unused=True)
    for a, g in zip(acc, grads):
        if g is not None:
            a.add_(g)
    return grads[-1] if x_leaf is not None else None


def _setup(engine, tree, aliases, mbs):
    """(pipe group, stage, pp, M, a zero activation maker, totals)."""
    dev = aliases[0].device
    shape = (mbs[0].n_padded, engine.full_mc.hidden_size)
    dtype = tree["layers"]["ln1"].dtype
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    totals = {"loss": zero, "sum_logprob": zero, "sum_entropy": zero, "lb_loss": zero}
    return (engine.mesh.group("pipe"), engine.stage, engine.pp, len(mbs),
            lambda: torch.zeros(shape, dtype=dtype, device=dev), totals)


def _gpipe(engine, tree, aliases, acc, mbs) -> dict:
    """GPipe: every forward tick keeps its microbatch's graph; the backward
    replays the ticks in reverse."""
    group, s, pp, M, zeros, totals = _setup(engine, tree, aliases, mbs)
    kept = {}
    x_prev = zeros()
    for t in range(M + pp - 1):
        mb, out = t - s, zeros()
        if 0 <= mb < M:
            kept[mb] = _forward(engine, tree, mbs[mb], None if s == 0 else x_prev, totals)
            if s < pp - 1:
                out = kept[mb][1].detach()
        x_prev = _hop(out, group, 1)
    dy = zeros()
    for t in reversed(range(M + pp - 1)):
        mb, dx = t - s, None
        if 0 <= mb < M:
            dx = _backward(engine, aliases, acc, *kept.pop(mb), dy)
        dy = _hop(zeros() if dx is None else dx, group, -1)
    return totals


def _one_f_one_b(engine, tree, aliases, acc, mbs) -> dict:
    """1F1B: one forward and one recomputing backward a tick, the stage
    inputs of the microbatches in flight stashed in 2·pp − 1 slots."""
    group, s, pp, M, zeros, totals = _setup(engine, tree, aliases, mbs)
    slots = 2 * pp - 1
    stash = [None] * slots
    x_prev = dx_prev = zeros()
    for t in range(M + 2 * (pp - 1)):
        out, dx = zeros(), None
        mf = t - s  # this tick's forward
        if 0 <= mf < M:
            if s > 0:
                if stash[mf % slots] is not None:
                    raise AssertionError(f"stash slot {mf % slots} is still in use")
                stash[mf % slots] = x_prev
            if s < pp - 1:
                with torch.no_grad():
                    out = engine.stage_forward(tree, mbs[mf], x_prev, train=False)[0]
        mb = t - 2 * (pp - 1) + s  # this tick's backward
        if 0 <= mb < M:
            x_in = None
            if s > 0:
                x_in, stash[mb % slots] = stash[mb % slots], None
            dx = _backward(engine, aliases, acc, *_forward(engine, tree, mbs[mb], x_in, totals), dx_prev)
        x_prev = _hop(out, group, 1)
        dx_prev = _hop(zeros() if dx is None else dx, group, -1)
    return totals


def _reduce_pp(mesh, names, leaves, acc, totals: dict, moe: bool, params):
    """JAX's grad bookkeeping (module docstring): the fp32 sums cast to the
    params' dtypes, the leaves outside the layer stack summed over "pipe",
    then ``_reduce_step``'s sums over "model" (q_norm, k_norm) and "data"."""
    keys = ["sum_logprob", "sum_entropy"] + (["lb_loss"] if moe else [])
    pipe = mesh.group("pipe")
    grads = [a.to(t.dtype) for a, t in zip(acc, leaves)]
    for path, g in zip(names, grads):
        if path[0] != "layers":
            all_reduce_(_dense_view(g), pipe)
    summed = all_reduce_(torch.stack([totals["loss"], *(totals[k] for k in keys)]), pipe)
    return _reduce_step(mesh, summed[0], _unflatten(params, names, grads), dict(zip(keys, summed[1:])), 1, None)
