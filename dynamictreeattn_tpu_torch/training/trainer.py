"""Trainer: RL-style trie training, fed by the live cost model.

Counterpart of ``dynamictreeattn_tpu/training/trainer.py``: every step, the
incoming rollout batch is partitioned into dp bins, stacked, trained in one
step with the optimizer applied on the device, and the step's time feeds
the execution-time model back (``parallel.TreeTimeModel``). The step reads
back to the host once: the loss and its two aux sums, together.

On one device (dp = tp = sp = pp = 1) the step is ``TreeEngine``'s. At dp,
sp, tp, pp > 1, with ZeRO-3 (``fsdp``) or with expert parallelism it runs on
a mesh (``parallel.make_mesh``), one process per rank: every rank builds the
same global batch and runs the same partition into dp bins, and each rank
trains its data rank's bin on its shards (``parallel.make_train_step``),
under sequence parallelism its rows of it. With pipeline stages (pp > 1)
the batch is binned into dp × M tries (M = ``microbatches``), each rank
builds its data row's M microbatches and runs its stage of
``parallel.make_pp_train_step`` (``pp_schedule`` "gpipe" or "1f1b"). Each
rank times its own step; rank 0's time is broadcast before it feeds the
cost model, so that every rank fits the same model and the next step's bins
agree. Checkpoints keep the one-file format: global rank 0 writes the
params and moments gathered from every rank (the stages' layers put back
together), so a checkpoint restores at any mesh.

``multihost`` marks a run whose ranks span hosts (``cli.train --multihost``
starts the process group with ``parallel.distributed.initialize_multihost``)
and changes nothing in the Trainer: it is kept for the JAX config's fields.
One process per rank makes a multi-host run's math identical to a one-host
run of the same mesh: every host computes the same global batch and partition, each rank
uploads its own rows, and global rank 0 writes the checkpoint to a
directory every host reads while all ranks wait at a barrier. NCCL across
hosts runs on no machine this package was tested on.

The optimizer is the JAX Trainer's optax chain with optax's arithmetic
(``OptaxAdamW``): ``clip_by_global_norm`` → ``adamw`` with a linear 10% →
100% warmup, inside ``MultiSteps`` accumulation; on a mesh the clip takes
the norm over the whole model (``parallel.global_sum_squares``); under
ZeRO-3 the moments are sharded as their params (``zeros_like`` of the
shards). MoE models train with the router's load-balance term in the loss.
As in JAX, the pipeline does not combine with ``fsdp``, ``ep`` or a custom
loss, and ``forward_logprobs`` refuses pp > 1.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from dynamictreeattn_tpu_torch.engine import EngineConfig
from dynamictreeattn_tpu_torch.engine.tree_engine import _flatten, _unflatten, trainable
from dynamictreeattn_tpu_torch.models.generate import generate_grouped
from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config
from dynamictreeattn_tpu_torch.ops import adamw
from dynamictreeattn_tpu_torch.parallel import (
    LB_by_DFS_and_TM, LB_by_n_tokens, TreeTimeModel, extract_forward, gather_params, global_sum_squares,
    make_forward_step, make_pp_train_step, make_train_step, shard_params, stack_batches, stack_microbatches,
)
from dynamictreeattn_tpu_torch.parallel.collectives import _call, broadcast_
from dynamictreeattn_tpu_torch.training.checkpoint import CheckpointManager
from dynamictreeattn_tpu_torch.tries import TokenTrie, trie_stats
from dynamictreeattn_tpu_torch.utils import profiling
from dynamictreeattn_tpu_torch.utils.profiling import span

__all__ = ["OptaxAdamW", "TrainConfig", "Trainer"]

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    dp: int = 1
    tp: int = 1
    sp: int = 1  # sequence parallelism over the "seq" axis
    sp_mode: str = "ulysses"  # or "ring"
    pp: int = 1  # pipeline stages
    pp_schedule: str = "gpipe"  # or "1f1b"
    microbatches: int = 4  # microbatches per data rank when pp > 1
    learning_rate: float = 1e-5
    warmup_steps: int = 0  # linear warmup into a constant schedule
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    grad_accum: int = 1  # optax.MultiSteps accumulation
    fsdp: bool = False  # ZeRO-3 sharding over "data"
    ep: bool = False  # MoE expert parallelism over "data"
    fsdp_min_size: int = 1 << 16
    param_dtype: str = "bf16"
    lb_method: str = "LB_by_DFS_and_TM"  # or "LB_by_n_tokens"
    lb_block_size: int = 2048
    ckpt_dir: str | None = None
    ckpt_every: int = 0  # 0 = only on demand
    log_every: int = 1
    skip_nonfinite: bool = True  # drop updates from non-finite-loss steps
    multihost: bool = False  # the ranks span hosts; read by nothing here (module docstring)


class OptaxAdamW:
    """``optax.MultiSteps(chain(clip_by_global_norm(grad_clip), adamw(lr,
    weight_decay=wd)), grad_accum)`` with optax's arithmetic, on torch
    tensors, in place on the device:

    * clip: g -> g if ||g|| < max_norm else (g / ||g||) * max_norm, ||g|| the
      fp32 global norm (not ``torch.nn.utils.clip_grad_norm_``, whose
      ``max_norm / (norm + 1e-6)`` scales otherwise);
    * adam (b1 0.9, b2 0.999, eps 1e-8): mu, nu in the params' dtype,
      bias-corrected by ``1 - b**count``; then ``+ wd * p``; then ``* -lr``,
      lr from ``linear_schedule(0.1 lr, lr, warmup_steps)`` of the count of
      real updates when warming up;
    * accumulation over k micro-steps: the running mean ``acc + (g - acc) /
      (mini_step + 1)``; the k-th micro-step updates with it and resets it,
      the others leave the params unchanged.

    ``update(..., good=)`` takes a 0-d bool tensor: where it is False (a
    non-finite loss) params and every part of the state stay bit-unchanged,
    decided on the device. The counters are device int32 tensors, so no
    step reads anything back. The clip's Σ g² and the update are
    ``ops.adamw``'s: on the card two kernels (the update applies the clip's
    scale to each gradient it reads), on the CPU the eager chain.
    `sum_squares(grads)`, if given, returns the clip's Σ g² in place of
    ``ops.adamw.sum_squares`` (on a mesh, over every rank's shards:
    ``parallel.global_sum_squares``)."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adamw's defaults, the JAX Trainer's

    def __init__(self, learning_rate: float, weight_decay: float = 0.0, grad_clip: float = 0.0,
                 warmup_steps: int = 0, grad_accum: int = 1, sum_squares=None):
        self.lr, self.wd, self.clip = learning_rate, weight_decay, grad_clip
        self.warmup, self.k = warmup_steps, grad_accum
        self.sum_squares = sum_squares

    def init(self, params: dict) -> dict:
        leaves = _leaves(trainable(params))
        dev = leaves[0].device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        return {"count": zero(), "mini_step": zero(), "gradient_step": zero(),
                "mu": [torch.zeros_like(p) for p in leaves], "nu": [torch.zeros_like(p) for p in leaves],
                "acc": [torch.zeros_like(p) for p in leaves] if self.k > 1 else None}

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        """-lr at `count` real updates (optax's polynomial schedule of power 1)."""
        if not self.warmup:
            return torch.full((), -self.lr, dtype=torch.float32, device=count.device)
        init, end = 0.1 * self.lr, self.lr
        frac = 1 - torch.clamp(count, 0, self.warmup).float() / self.warmup
        return -((init - end) * frac + end)

    def update(self, grads: dict, state: dict, params: dict, good: torch.Tensor,
               mark: Callable[[str], None] | None = None) -> tuple[dict, dict]:
        """One step: params and state updated in place (and returned);
        `grads` may be overwritten (by the plain version, on the CPU).
        `mark(name)`, if given, is called after the clip's norm ("clip")
        and after the AdamW update ("adamw")."""
        gs, ps = _leaves(grads), _leaves(trainable(params))
        k, commit = self.k, good
        if k > 1:  # g <- acc + (g - acc) / (mini + 1); acc <- it, or 0 on the k-th
            mini = state["mini_step"]
            emit = mini == k - 1
            for g, acc in zip(gs, state["acc"]):
                g.sub_(acc).div_((mini + 1).to(g.dtype)).add_(acc)
                acc.copy_(torch.where(good, torch.where(emit, torch.zeros_like(g), g), acc))
            state["mini_step"] = torch.where(good, (mini + 1) % k, mini)
            commit = good & emit
        clip = None
        if self.clip:  # g -> g if norm < clip else (g / norm) * clip, inside the update
            norm = torch.sqrt(self.sum_squares(grads) if self.sum_squares else adamw.sum_squares(gs))
            trigger = norm < self.clip
            one = torch.ones((), dtype=torch.float32, device=norm.device)
            clip = torch.where(trigger, one, norm), torch.where(trigger, one, one * self.clip)
        if mark:
            mark("clip")
        count = state["count"] + 1
        bc1 = 1 - torch.pow(self.b1, count.float())  # scalar bases: no host-to-device copy
        bc2 = 1 - torch.pow(self.b2, count.float())
        adamw.adamw_update(ps, gs, state["mu"], state["nu"], lr=self._lr(state["count"]), bc1=bc1, bc2=bc2,
                           commit=commit, clip=clip, b1=self.b1, b2=self.b2, eps=self.eps, weight_decay=self.wd)
        c = commit.to(torch.int32)
        state["count"] = state["count"] + c
        state["gradient_step"] = state["gradient_step"] + c
        if mark:
            mark("adamw")
        return params, state


def _leaves(tree: dict) -> list:
    out = []
    for v in tree.values():
        out += _leaves(v) if isinstance(v, dict) else [v]
    return out


class Trainer:
    def __init__(self, model_config: Qwen3Config, engine_config: EngineConfig = EngineConfig(),
                 train_config: TrainConfig = TrainConfig(), mesh=None, custom_loss=None,
                 extras_spec: dict | None = None, device="cuda"):
        """`custom_loss(lp_rows, ent_rows, extras, length)` swaps the linear
        weighted loss for a per-sequence one (clipped-ratio GRPO);
        `extras_spec` maps each extras name to its per-sequence ndim (0 =
        scalar, 1 = per-edge vector); pass the values to
        ``train_step(..., extras=...)``. `mesh`: the ranks' mesh
        (``parallel.make_mesh``) of tc.dp × tc.sp × tc.tp, needed when one
        is above 1 or with fsdp."""
        tc = train_config
        if model_config.is_mla and (tc.dp * tc.tp * tc.sp * tc.pp > 1 or tc.fsdp or tc.ep):
            raise NotImplementedError(f"dp={tc.dp}, tp={tc.tp}, sp={tc.sp}, pp={tc.pp}, fsdp={tc.fsdp}, ep={tc.ep}: "
                                      "latent attention (DeepSeek-V3 / MLA) models train on one device only")
        if tc.pp > 1:
            if tc.fsdp:
                raise ValueError("fsdp + pipeline not supported yet")
            if tc.ep:
                raise ValueError("ep (data-axis expert parallelism) + pipeline not supported yet")
            if custom_loss is not None:
                raise ValueError("custom_loss requires pp == 1")
        if mesh is None and (tc.dp * tc.tp * tc.sp * tc.pp > 1 or tc.fsdp):
            raise ValueError(f"dp={tc.dp}, tp={tc.tp}, sp={tc.sp}, pp={tc.pp}, fsdp={tc.fsdp} needs mesh=: a "
                             "Trainer leaves torch.distributed not initialised; start the process group and pass "
                             "mesh=parallel.make_mesh(...)")
        if mesh is not None and (mesh.size("data"), mesh.size("seq"), mesh.size("pipe"), mesh.size("model")) != \
                (tc.dp, tc.sp, tc.pp, tc.tp):
            raise ValueError(f"a mesh of {mesh.shape} for dp={tc.dp}, sp={tc.sp}, pp={tc.pp}, tp={tc.tp}")
        self.mc, self.ec, self.tc, self.mesh = model_config, engine_config, train_config, mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        self.ep = tc.dp if tc.ep and model_config.is_moe else 1
        self.time_model = TreeTimeModel()
        self.step_idx = 0
        self.skipped_steps = 0
        self.history: list[dict] = []
        self._layout = dict(ep=self.ep, fsdp=tc.fsdp, fsdp_min_size=tc.fsdp_min_size)
        self.optimizer = OptaxAdamW(tc.learning_rate, tc.weight_decay, tc.grad_clip, tc.warmup_steps,
                                    tc.grad_accum,
                                    None if mesh is None else global_sum_squares(mesh, model_config, **self._layout))
        if tc.pp > 1:
            self._step_fn = make_pp_train_step(model_config, mesh, engine_config, optimizer=self.optimizer,
                                               schedule=tc.pp_schedule)
        else:
            self._step_fn = make_train_step(model_config, engine_config, optimizer=self.optimizer,
                                            custom_loss=custom_loss, device=self.device, ep=tc.ep, mesh=mesh,
                                            sp=tc.sp, sp_mode=tc.sp_mode, fsdp=tc.fsdp,
                                            fsdp_min_size=tc.fsdp_min_size)
        self.custom_loss = custom_loss
        self.extras_spec = extras_spec or {}
        self.params = None
        self.opt_state = None
        self._fwd_fn = None
        self._ckpt = CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None
        self._parts: profiling.Parts | None = None  # collecting while `time_parts` is on
        self._t_read: float | None = None  # when the last step's host read returned
        self.last_parts_ms: dict | None = None

    @property
    def time_parts(self) -> bool:
        """While on, each step's parts are collected (``utils.profiling``,
        one collector for the process) and ``last_parts_ms`` holds the last
        step's: on a card the device ms of its CUDA events ("engine",
        "clip", "adamw", a MoE model's "moe"); the host ms of the spans
        closed since the step before's read ("step.record" of that step,
        this step's "prepare.*", "step.launch", "step.read", "moe.*");
        "host_serial", the host ms from the step before's read returning to
        this step's first launch (from the second step on); and the counts
        "moe.pairs" and "moe.dropped", read in the step's one host read.
        Off, nothing of this runs but the spans' records."""
        return self._parts is not None

    @time_parts.setter
    def time_parts(self, on: bool) -> None:
        if bool(on) == self.time_parts:
            return
        if on:
            self._parts = profiling.Parts(device_events=self.device.type == "cuda")
            profiling.collect(self._parts)
        else:
            if profiling.collecting() is self._parts:  # another Trainer's collector stays
                profiling.collect(None)
            self._parts = None
        self._t_read = None

    # ------------------------------------------------------------------ state
    @property
    def lead(self) -> bool:
        """Whether this process is global rank 0 (always, on one device): the
        one that writes checkpoints and, in ``cli.train``, the records."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def init(self, seed: int = 0) -> None:
        """Random params from `seed` (on a mesh, the same full params drawn
        on every rank, then this rank's slices kept)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.mc.family.init_params(self.mc, gen, dtype=DTYPES[self.tc.param_dtype])
        self._set(params if self.mesh is None else self._shard(params))

    def set_params(self, params: dict) -> None:
        """Train a copy of full `params` on the trainer's device (on a mesh,
        this rank's slices; the optimizer updates the trainer's params in
        place; the caller's stay as given)."""
        self._set(_to_device(params, self.device, copy=True) if self.mesh is None else self._shard(params))

    def _shard(self, tree):
        return shard_params(tree, self.mesh, self.mc, **self._layout)

    def full_params(self) -> dict:
        """The whole model's params (gathered from every rank on a mesh:
        every rank calls it)."""
        return self.params if self.mesh is None else gather_params(self.params, self.mesh, self.mc, **self._layout)

    def _set(self, params: dict) -> None:
        self.params = params
        self.opt_state = self.optimizer.init(params)

    def save(self, extra: dict | None = None) -> None:
        """One checkpoint file of the whole model; on a mesh every rank
        calls it, the params and moments are gathered and rank 0 writes."""
        assert self._ckpt, "no ckpt_dir configured"
        params, state = self.params, self.opt_state
        if self.mesh is not None:  # the moments are lists in the params' leaf order
            params = self.full_params()
            state = {key: _leaves(gather_params(_state_tree(val, self.params), self.mesh, self.mc, **self._layout))
                     if isinstance(val, list) else val for key, val in state.items()}
        if self.lead:
            self._ckpt.save(self.step_idx, params, state, extra={"step": self.step_idx, **(extra or {})})
        if self.mesh is not None:
            _call("barrier", group=self.mesh.everyone)

    def restore(self, step: int | None = None) -> None:
        """Params, optimizer state and step from a checkpoint written at any
        mesh (on a mesh, each rank reads the file and keeps its slices)."""
        assert self._ckpt, "no ckpt_dir configured"
        out = self._ckpt.restore(step, map_location=self.device if self.mesh is None else "cpu")
        state = out.get("opt_state")
        if self.mesh is None:
            self._set(out["params"])
        else:
            self._set(self._shard(out["params"]))
            if state is not None:  # the moments sliced as their params, the counters copied
                state = {key: _leaves(self._shard(_state_tree(val, out["params"]))) if isinstance(val, list)
                         else val if val is None else val.to(self.device) for key, val in state.items()}
        if state is not None:
            self.opt_state = state
        extra = out.get("extra") or {}
        self.step_idx = int(extra.get("step", step or 0))

    # ------------------------------------------------------------------ steps
    def partition(self, seqs, attachs, n_bins: int | None = None) -> list[TokenTrie]:
        """Split one rollout batch into per-device (or per-microbatch) tries."""
        tries, _ = self.partition_with_ids(seqs, attachs, n_bins)
        return tries

    def partition_with_ids(self, seqs, attachs, n_bins: int | None = None):
        """(tries, bins): bins[r][j] = original index of the sequence whose
        _sequence_batch_id is j within bin r's trie. One bin on one device;
        `n_bins` > 1 bins on the host as the JAX package does; on a mesh, dp
        bins by default."""
        dp = n_bins if n_bins is not None else (1 if self.mesh is None else self.mesh.size("data"))
        with span("prepare.partition"):
            if dp == 1:
                bins = [list(range(len(seqs)))]
            elif self.tc.lb_method == "LB_by_n_tokens":
                bins = LB_by_n_tokens(seqs, dp)
            else:
                bins = LB_by_DFS_and_TM(seqs, self.time_model, dp, block_size=self.tc.lb_block_size)
        tries, out_bins = [], []
        with span("prepare.trie"):
            for ids in bins:
                ids = ids or [int(np.argmin([len(s) for s in seqs]))]  # never empty
                tries.append(TokenTrie([seqs[i] for i in ids], [attachs[i] for i in ids]))
                out_bins.append(list(ids))
        return tries, out_bins

    def rollout(self, prompts, prompt_lens, group: int, max_new: int,
                generator: torch.Generator | None = None, temperature: float = 1.0,
                greedy: bool = False, eos_id: int | None = None, top_k: int = 0,
                top_p: float | None = None, min_p: float | None = None):
        """Sample `group` completions per prompt with the CURRENT params
        (``models.generate_grouped``; `generator` in place of the JAX key).
        On a mesh every rank gathers the full params and samples the same
        completions from the same generator state. Returns [P, group,
        max_new] int32 numpy."""
        assert self.params is not None, "call init()/restore() first"
        return generate_grouped(self.full_params(), self.mc, prompts, prompt_lens, group, max_new,
                                generator=generator, temperature=temperature, greedy=greedy,
                                eos_id=eos_id, top_k=top_k, top_p=top_p, min_p=min_p)

    def forward_logprobs(self, seqs, attachs) -> list:
        """Behavior log-probs for a rollout batch (the RL ratio
        denominators): a list aligned with `seqs` of fp32 arrays of length
        len(seq)-1."""
        assert self.params is not None, "call init()/restore() first"
        if self.tc.pp > 1 or self.tc.sp > 1:
            raise ValueError("forward_logprobs does not support pp/sp>1 yet")
        if self._fwd_fn is None:
            self._fwd_fn = make_forward_step(self.mc, self.ec, device=self.device, ep=self.tc.ep, mesh=self.mesh,
                                             fsdp=self.tc.fsdp, fsdp_min_size=self.tc.fsdp_min_size)
        tries, bins = self.partition_with_ids(seqs, attachs)
        batch = stack_batches(tries, self.ec, engine=self._fwd_fn.engine, mesh=self.mesh)
        lp, _ = self._fwd_fn(self.params, batch)
        per_rank = extract_forward(batch, lp)
        out = [None] * len(seqs)
        for r, ids in enumerate(bins):
            for j, orig in enumerate(ids):
                out[orig] = per_rank[r][j]
        return out

    def _extras_arrays(self, batch, bins, extras: dict) -> dict:
        """Per-sequence extras (aligned with the input order) -> x_<name>
        host arrays [dp, S, ...] in each bin's _sequence_batch_id order."""
        S = max(len(p.seq_batch_ids) for p in batch.packeds)
        width = max((int(p.seq_lens.max()) if len(p.seq_lens) else 1) for p in batch.packeds) - 1
        out = {}
        for name, nd in self.extras_spec.items():
            vals = extras[name]
            if nd == 0:
                a = np.zeros((len(bins), S), np.float32)
                for r, ids in enumerate(bins):
                    for j, orig in enumerate(ids):
                        a[r, j] = float(vals[orig])
            elif nd == 1:
                a = np.zeros((len(bins), S, width), np.float32)
                for r, ids in enumerate(bins):
                    for j, orig in enumerate(ids):
                        v = np.asarray(vals[orig], np.float32)
                        a[r, j, : len(v)] = v[:width]
            else:
                raise ValueError(f"extras ndim {nd} not supported")
            out["x_" + name] = a
        return out

    def prepare_step(self, seqs, attachs, extras: dict | None = None):
        """(batch, tries): the host half of ``train_step`` — partition,
        stack, upload (the step's batch, work lists and extras on the
        device). With pipeline stages: dp × M bins, this rank's data row's
        M microbatches."""
        if self.tc.pp > 1:
            dp, M = self.mesh.size("data"), self.tc.microbatches
            flat = self.partition(seqs, attachs, n_bins=dp * M)
            rows = [flat[r * M:(r + 1) * M] for r in range(dp)]
            return stack_microbatches(rows, self.ec, engine=self._step_fn.engine, mesh=self.mesh), flat
        tries, bins = self.partition_with_ids(seqs, attachs)
        batch = stack_batches(tries, self.ec, sp=self.tc.sp, sp_mode=self.tc.sp_mode, engine=self._step_fn.engine,
                              with_paths=self.custom_loss is not None, mesh=self.mesh)
        if self.custom_loss is not None:
            with span("prepare.upload"):
                for name, a in self._extras_arrays(batch, bins, extras or {}).items():
                    batch.add(name, a)
        return batch, tries

    def run_step(self, batch, tries, n_sequences: int, n_tokens: int) -> dict:
        """The device half of ``train_step``: the step, the optimizer, ONE
        read of the loss and aux back to the host, the cost model, the
        record (host spans "step.launch", "step.read", "step.record"; the
        parts of ``time_parts``)."""
        parts, events = self._parts, []
        timing = parts is not None and self.device.type == "cuda"

        def mark(name):
            if timing:
                events.append((name, torch.cuda.Event(enable_timing=True)))
                events[-1][1].record()

        host_serial = None
        if parts is not None and self._t_read is not None:
            host_serial = (time.perf_counter() - self._t_read) * 1e3
        mark("start")
        t0 = time.time()
        with span("step.launch"):
            _, _, loss, aux = self._step_fn(self.params, self.opt_state, batch, mark)
        with span("step.read"):  # ONE host read for every scalar this step logs, and its counts
            scalars = torch.stack([loss.float(), aux["sum_logprob"].float(), aux["sum_entropy"].float()])
            counts = parts.take_counts() if parts is not None else {}
            if counts:
                scalars = torch.cat([scalars.double(), torch.stack(list(counts.values())).double()])
            loss, sum_lp, sum_ent, *counted = scalars.tolist()
        dt = time.time() - t0
        with span("step.record"):
            if parts is not None:  # the events precede the read, so they are complete
                self._t_read = time.perf_counter()
                self.last_parts_ms = {name: a.elapsed_time(b) for (_, a), (name, b) in zip(events, events[1:])}
                self.last_parts_ms.update(parts.take())
                if host_serial is not None:
                    self.last_parts_ms["host_serial"] = host_serial
                self.last_parts_ms.update(zip(counts, counted))
            if self.tc.skip_nonfinite and not np.isfinite(loss):
                # the update was skipped on the device: params and state unchanged
                self.skipped_steps += 1
                self.step_idx += 1
                rec = {"step": self.step_idx, "loss": loss, "skipped": True, "time": dt,
                       "n_sequences": n_sequences}
                self.history.append(rec)
                return rec
            self.step_idx += 1
            # feed the cost model with the largest bin's features and the step time
            feats = [trie_stats(t.lens, t.lcp_lens, mode="backward", block_size=self.tc.lb_block_size)
                     for t in tries]
            biggest = max(feats, key=lambda s: s["n_tree_tokens"])
            fit_dt = dt
            if self.mesh is not None:  # every rank fits rank 0's time: the same model, the same next bins
                t = broadcast_(torch.full((1,), dt, dtype=torch.float64, device=self.device), 0, self.mesh.everyone)
                fit_dt = t.item()
            self.time_model.add_data(dict(biggest, time=fit_dt))
            rec = {
                "step": self.step_idx,
                "loss": loss,
                "time": dt,
                "n_sequences": n_sequences,
                "n_tokens": n_tokens,
                "n_tree_tokens": int(sum(f["n_tree_tokens"] for f in feats)),
                "sum_logprob": sum_lp,
                "sum_entropy": sum_ent,
            }
            self.history.append(rec)
            if self._ckpt and self.tc.ckpt_every and self.step_idx % self.tc.ckpt_every == 0:
                self.save()
            return rec

    def train_step(self, seqs, attachs, extras: dict | None = None) -> dict:
        assert self.params is not None, "call init()/restore() first"
        if self.custom_loss is not None and extras is None:
            extras = {}
        batch, tries = self.prepare_step(seqs, attachs, extras)
        return self.run_step(batch, tries, len(seqs), int(sum(len(s) for s in seqs)))

    def fit(self, batches: Iterable, log_fn: Callable[[dict], None] = None) -> list[dict]:
        for seqs, attachs in batches:
            rec = self.train_step(seqs, attachs)
            if log_fn and self.step_idx % self.tc.log_every == 0:
                log_fn(rec)
        return self.history


def _state_tree(leaves: list, like: dict) -> dict:
    """Optimizer moments (a list in the params' leaf order) as a tree of
    the params' structure."""
    names, _ = _flatten(like)
    return _unflatten(like, names, leaves)


def _to_device(tree: dict, device: torch.device, copy: bool = False) -> dict:
    """The tree's tensors on `device` (strides kept), copied when `copy`."""
    return {k: _to_device(v, device, copy) if isinstance(v, dict) else v.to(device, copy=copy)
            for k, v in tree.items()}
