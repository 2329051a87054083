"""Training and forward steps over stacked trie batches, on one device.

Counterpart of the one-rank subset of ``dynamictreeattn_tpu/parallel/train.py``:

* ``stack_batches`` flattens and pads each rank's trie to a COMMON bucket
  and, given an engine, builds each one's device batch through
  ``TreeEngine.prepare``: the block metadata, the slot schedule where the
  plain K3 replays one (a CPU "cached" backward), the work lists of the
  kernels on the card, never a schedule there (with ``with_paths``, also
  the per-sequence path matrix of a custom loss). The JAX package also
  stacks the ranks' host arrays, at common power-of-two slot widths, for
  its mesh; one device reads none of them, so they wait for the mesh.
* ``make_train_step`` / ``make_forward_step`` build the steps on
  ``TreeEngine``: the training step (loss, grads, aux) with an optional
  optimizer applied on the device, and the inference-mode per-edge
  log-probs that ``extract_forward`` maps back to sequences.

The mesh of the JAX package (data, tensor and sequence parallelism, FSDP,
expert parallelism) is not ported: any degree above 1 raises
``ValueError`` naming ROADMAP queue 1 item 10, which ports it over
``torch.distributed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dynamictreeattn_tpu_torch.engine.tree_engine import EngineConfig, TreeEngine, TrieBatch
from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config
from dynamictreeattn_tpu_torch.tries import TokenTrie, flatten_trie
from dynamictreeattn_tpu_torch.tries.flatten import _pad_packed

__all__ = ["StackedBatch", "check_single_device", "extract_forward", "make_forward_step",
           "make_train_step", "stack_batches"]


def check_single_device(**settings) -> None:
    """Raise unless every parallel setting (dp=, tp=, sp=, pp= degrees;
    fsdp=, ep=, multihost= flags; mesh=) asks for one device: degree 1,
    flag off, no mesh. The port runs on one device until the mesh is
    ported."""
    over = {name: v for name, v in settings.items()
            if not (v is None or v is False or (type(v) is int and v == 1))}
    if over:
        raise ValueError(f"{over}: more than one device is not ported yet (ROADMAP queue 1 item 10, "
                         "parallelism over torch.distributed)")


@dataclasses.dataclass
class StackedBatch:
    """Per-rank packed tries padded to one bucket, and their device batches."""

    packeds: list  # host PackedTries, one per data rank
    batches: list | None = None  # each rank's TrieBatch on the engine's device
    # rank 0's custom-loss extras (x_<name>) on that device
    on_device: dict = dataclasses.field(default_factory=dict)

    @property
    def dp(self) -> int:
        return len(self.packeds)

    def add(self, name: str, array: np.ndarray) -> None:
        """Upload rank 0's row of a host array [dp, ...] to the batch's
        device (an upload before the step, not in it)."""
        if self.batches is None:
            raise ValueError("the batch was stacked without an engine: stack_batches(..., engine=step.engine)")
        self.on_device[name] = torch.from_numpy(np.ascontiguousarray(array[0])).to(self.batches[0].tokens.device)


def stack_batches(tries_or_packed: list, cfg: EngineConfig, sp: int = 1, sp_mode: str = "ulysses",
                  engine: TreeEngine | None = None, with_paths: bool = False) -> StackedBatch:
    """Flatten and pad each rank's trie to a common bucket (JAX
    ``stack_batches``; ``sp > 1`` raises); with `engine`, each rank's
    ``TrieBatch`` on the engine's device (``TreeEngine.prepare``), and with
    `with_paths` its path matrix of a custom loss, uploaded now."""
    check_single_device(sp=sp)
    packeds = [flatten_trie(t) if isinstance(t, TokenTrie) else t for t in tries_or_packed]
    n_pad = cfg.bucket_length(max(p.n_padded for p in packeds))
    packeds = [_pad_packed(p, n_pad) if p.n_padded != n_pad else p for p in packeds]
    batches = None if engine is None else [engine.prepare(p) for p in packeds]
    if with_paths and batches is not None:
        for b in batches:  # uploaded now, not inside the step
            engine.seq_gather_arrays(b)
    return StackedBatch(packeds=packeds, batches=batches)


def _rank_batch(batch: StackedBatch) -> TrieBatch:
    """The one rank's device batch."""
    check_single_device(dp=batch.dp)
    if batch.batches is None:
        raise ValueError("the batch was stacked without an engine: stack_batches(..., engine=step.engine)")
    return batch.batches[0]


def make_train_step(model_config: Qwen3Config, engine_config: EngineConfig = EngineConfig(),
                    optimizer=None, custom_loss=None, device="cuda", dp: int = 1, tp: int = 1, sp: int = 1, fsdp: bool = False,
                    ep: bool = False):
    """The training step on one device (the JAX ``make_train_step`` on a
    one-device mesh; any parallel degree above 1 raises).

    Without `optimizer`: step(params, batch) -> (loss, grads, aux). With one
    (``training.trainer.OptaxAdamW``): step(params, opt_state, batch,
    mark=None) -> (params, opt_state, loss, aux), the optimizer applied in
    place on the device and skipped there (params and state bit-unchanged)
    when the loss is not finite, so that the step reads nothing back to the
    host; `mark(name)` is called after the engine's step ("engine") and by
    the optimizer. Scalars stay device tensors. The batch comes from
    ``stack_batches(..., engine=step.engine)``.

    `custom_loss(lp_rows, ent_rows, extras, length) -> scalar` replaces the
    linear weighted loss through ``TreeEngine.loss_and_grad_custom`` (aux
    the sums of the sequences' log-probs and entropies): the batch comes
    from ``stack_batches(with_paths=True)`` and carries one ``x_<name>``
    array [1, S, ...] per extra (``StackedBatch.add``). For a MoE model the
    loss adds router_aux_coef · lb_loss and aux holds "lb_loss", with the
    linear loss and with a custom one, as in the JAX step."""
    check_single_device(dp=dp, tp=tp, sp=sp, fsdp=fsdp, ep=ep)
    engine = TreeEngine(model_config, engine_config, device=device)

    def grad_step(params, batch: StackedBatch):
        tb = _rank_batch(batch)
        if custom_loss is None:
            return engine.loss_and_grad(params, tb)
        extras = {k[2:]: v for k, v in batch.on_device.items()}
        return engine.loss_and_grad_custom(params, tb, custom_loss, extras, with_aux=True, router_aux=True)

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
                      device="cuda", dp: int = 1, tp: int = 1, sp: int = 1):
    """Inference-mode per-edge log-probs on one device (the JAX
    ``make_forward_step`` on a one-device mesh): step(params, batch) ->
    (lp_edge [1, n], entropy [1, n]) fp32 on the device."""
    check_single_device(dp=dp, tp=tp, sp=sp)
    engine = TreeEngine(model_config, engine_config, device=device)

    def step(params, batch: StackedBatch):
        lp, ent = engine.logprobs(params, _rank_batch(batch))
        return lp[None], ent[None]

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
