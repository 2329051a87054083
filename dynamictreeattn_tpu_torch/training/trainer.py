"""Trainer: RL-style trie training, fed by the live cost model.

Counterpart of ``dynamictreeattn_tpu/training/trainer.py``: every step, the
incoming rollout batch is partitioned into dp bins, stacked, trained in one
step with the optimizer applied on the device, and the step's time feeds
the execution-time model back (``parallel.TreeTimeModel``). The step reads
back to the host once: the loss and its two aux sums, together.

On one device (dp = tp = 1) the step is ``TreeEngine``'s. At dp, tp > 1 or
with expert parallelism it runs on a mesh (``parallel.make_mesh``), one
process per rank: every rank builds the same global batch and runs the same
partition into dp bins, and rank r trains bin r // tp on its shards
(``parallel.make_train_step``). Each rank times its own step; rank 0's time
is broadcast before it feeds the cost model, so that every rank fits the
same model and the next step's bins agree. Checkpoints keep the one-file
format: global rank 0 writes the params and moments gathered from every
rank, so a checkpoint restores at any mesh.

The optimizer is the JAX Trainer's optax chain with optax's arithmetic
(``OptaxAdamW``): ``clip_by_global_norm`` → ``adamw`` with a linear 10% →
100% warmup, inside ``MultiSteps`` accumulation; on a mesh the clip takes
the norm over the whole model (``parallel.global_sum_squares``). MoE models
train with the router's load-balance term in the loss. FSDP, sequence and
pipeline parallelism and multi-host runs raise ``ValueError`` naming
ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import numpy as np
import torch

from dynamictreeattn_tpu_torch.engine import EngineConfig
from dynamictreeattn_tpu_torch.engine.tree_engine import _flatten, _unflatten
from dynamictreeattn_tpu_torch.models.generate import generate_grouped
from dynamictreeattn_tpu_torch.models.qwen3 import Qwen3Config, init_params
from dynamictreeattn_tpu_torch.parallel import (
    LB_by_DFS_and_TM, LB_by_n_tokens, TreeTimeModel, check_single_device, extract_forward, gather_params,
    global_sum_squares, make_forward_step, make_train_step, shard_params, stack_batches,
)
from dynamictreeattn_tpu_torch.parallel.collectives import _call, broadcast_
from dynamictreeattn_tpu_torch.training.checkpoint import CheckpointManager
from dynamictreeattn_tpu_torch.tries import TokenTrie, trie_stats

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
    multihost: bool = False


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
    step reads anything back. Leaves are updated in slices of at most
    ``CHUNK`` elements to bound the temporaries. `sum_squares(grads)`, if
    given, returns the clip's Σ g² (on a mesh, over every rank's shards:
    ``parallel.global_sum_squares``)."""

    CHUNK = 1 << 25
    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adamw's defaults, the JAX Trainer's

    def __init__(self, learning_rate: float, weight_decay: float = 0.0, grad_clip: float = 0.0,
                 warmup_steps: int = 0, grad_accum: int = 1, sum_squares=None):
        self.lr, self.wd, self.clip = learning_rate, weight_decay, grad_clip
        self.warmup, self.k = warmup_steps, grad_accum
        self.sum_squares = sum_squares

    def init(self, params: dict) -> dict:
        leaves = _leaves(params)
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
        `grads` may be overwritten. `mark(name)`, if given, is called after
        the clip ("clip") and after the AdamW update ("adamw")."""
        gs, ps = _leaves(grads), _leaves(params)
        k, commit = self.k, good
        if k > 1:  # g <- acc + (g - acc) / (mini + 1); acc <- it, or 0 on the k-th
            mini = state["mini_step"]
            emit = mini == k - 1
            for g, acc in zip(gs, state["acc"]):
                g.sub_(acc).div_((mini + 1).to(g.dtype)).add_(acc)
                acc.copy_(torch.where(good, torch.where(emit, torch.zeros_like(g), g), acc))
            state["mini_step"] = torch.where(good, (mini + 1) % k, mini)
            commit = good & emit
        if self.clip:  # g <- g if norm < clip else (g / norm) * clip, in place
            norm = torch.sqrt(self.sum_squares(grads) if self.sum_squares else
                              sum(torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in gs))
            trigger = norm < self.clip
            one = torch.ones((), dtype=torch.float32, device=norm.device)
            div, mul = torch.where(trigger, one, norm), torch.where(trigger, one, one * self.clip)
            for g in gs:
                g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
        if mark:
            mark("clip")
        count = state["count"] + 1
        bc1 = 1 - torch.pow(self.b1, count.float())  # scalar bases: no host-to-device copy
        bc2 = 1 - torch.pow(self.b2, count.float())
        lr = self._lr(state["count"])
        for i, (p, g) in enumerate(zip(ps, gs)):
            for sl in _slices(p.shape, self.CHUNK):
                pc, gc, mc, nc = p[sl], g[sl], state["mu"][i][sl], state["nu"][i][sl]
                mu = (1 - self.b1) * gc + self.b1 * mc
                nu = (1 - self.b2) * (gc * gc) + self.b2 * nc
                u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + self.eps)
                u = (u + self.wd * pc) * lr.to(u.dtype)
                torch.where(commit, (pc + u).to(pc.dtype), pc, out=pc)
                torch.where(commit, mu, mc, out=mc)
                torch.where(commit, nu, nc, out=nc)
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


def _slices(shape, chunk: int) -> list:
    """Index tuples cutting a tensor of `shape` along dim 0 into pieces of
    at most ~`chunk` elements (one piece for a small leaf)."""
    numel = int(np.prod(shape)) if len(shape) else 1
    if numel <= chunk or len(shape) == 0:
        return [(slice(None),)] if len(shape) else [()]
    rows = max(1, chunk // (numel // shape[0]))
    return [(slice(r, min(r + rows, shape[0])),) for r in range(0, shape[0], rows)]


class Trainer:
    def __init__(self, model_config: Qwen3Config, engine_config: EngineConfig = EngineConfig(),
                 train_config: TrainConfig = TrainConfig(), mesh=None, custom_loss=None,
                 extras_spec: dict | None = None, device="cuda"):
        """`custom_loss(lp_rows, ent_rows, extras, length)` swaps the linear
        weighted loss for a per-sequence one (clipped-ratio GRPO);
        `extras_spec` maps each extras name to its per-sequence ndim (0 =
        scalar, 1 = per-edge vector); pass the values to
        ``train_step(..., extras=...)``. `mesh`: the ranks' mesh
        (``parallel.make_mesh``) of tc.dp × tc.tp, needed when either is
        above 1."""
        tc = train_config
        check_single_device(sp=tc.sp, pp=tc.pp, fsdp=tc.fsdp, multihost=tc.multihost)
        if mesh is None and tc.dp * tc.tp > 1:
            raise ValueError(f"dp={tc.dp}, tp={tc.tp} needs mesh=: a Trainer leaves torch.distributed not "
                             "initialised; start the process group and pass mesh=parallel.make_mesh(...)")
        if mesh is not None and (mesh.size("data"), mesh.size("model")) != (tc.dp, tc.tp):
            raise ValueError(f"a mesh of {mesh.shape} for dp={tc.dp}, tp={tc.tp}")
        self.mc, self.ec, self.tc, self.mesh = model_config, engine_config, train_config, mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        self.ep = tc.dp if tc.ep and model_config.is_moe else 1
        self.time_model = TreeTimeModel()
        self.step_idx = 0
        self.skipped_steps = 0
        self.history: list[dict] = []
        self.optimizer = OptaxAdamW(tc.learning_rate, tc.weight_decay, tc.grad_clip, tc.warmup_steps,
                                    tc.grad_accum,
                                    None if mesh is None else global_sum_squares(mesh, model_config, self.ep))
        self._step_fn = make_train_step(model_config, engine_config, optimizer=self.optimizer,
                                        custom_loss=custom_loss, device=self.device, ep=tc.ep, mesh=mesh)
        self.custom_loss = custom_loss
        self.extras_spec = extras_spec or {}
        self.params = None
        self.opt_state = None
        self._fwd_fn = None
        self._ckpt = CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None
        # with `time_parts` on the card: the last step's parts, device ms from
        # CUDA events (engine, clip, adamw) and the host's wait at the read
        self.time_parts = False
        self.last_parts_ms: dict | None = None

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
        params = init_params(self.mc, gen, dtype=DTYPES[self.tc.param_dtype])
        self._set(params if self.mesh is None else self._shard(params))

    def set_params(self, params: dict) -> None:
        """Train a copy of full `params` on the trainer's device (on a mesh,
        this rank's slices; the optimizer updates the trainer's params in
        place; the caller's stay as given)."""
        self._set(_to_device(params, self.device, copy=True) if self.mesh is None else self._shard(params))

    def _shard(self, tree):
        return shard_params(tree, self.mesh, self.mc, self.ep)

    def full_params(self) -> dict:
        """The whole model's params (gathered from every rank on a mesh:
        every rank calls it)."""
        return self.params if self.mesh is None else gather_params(self.params, self.mesh, self.mc, self.ep)

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
            state = {key: _leaves(gather_params(_state_tree(val, self.params), self.mesh, self.mc, self.ep))
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
        if dp == 1:
            bins = [list(range(len(seqs)))]
        elif self.tc.lb_method == "LB_by_n_tokens":
            bins = LB_by_n_tokens(seqs, dp)
        else:
            bins = LB_by_DFS_and_TM(seqs, self.time_model, dp, block_size=self.tc.lb_block_size)
        tries, out_bins = [], []
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
        if self._fwd_fn is None:
            self._fwd_fn = make_forward_step(self.mc, self.ec, device=self.device, ep=self.tc.ep, mesh=self.mesh)
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
        device)."""
        tries, bins = self.partition_with_ids(seqs, attachs)
        batch = stack_batches(tries, self.ec, engine=self._step_fn.engine,
                              with_paths=self.custom_loss is not None, mesh=self.mesh)
        if self.custom_loss is not None:
            for name, a in self._extras_arrays(batch, bins, extras or {}).items():
                batch.add(name, a)
        return batch, tries

    def run_step(self, batch, tries, n_sequences: int, n_tokens: int) -> dict:
        """The device half of ``train_step``: the step, the optimizer, ONE
        read of the loss and aux back to the host, the cost model, the
        record."""
        events = []
        timing = self.time_parts and self.device.type == "cuda"

        def mark(name):
            if timing:
                events.append((name, torch.cuda.Event(enable_timing=True)))
                events[-1][1].record()

        mark("start")
        t0 = time.time()
        _, _, loss, aux = self._step_fn(self.params, self.opt_state, batch, mark)
        # ONE host read for every scalar this step logs
        t_read = time.perf_counter()
        loss, sum_lp, sum_ent = torch.stack([loss.float(), aux["sum_logprob"].float(),
                                             aux["sum_entropy"].float()]).tolist()
        dt = time.time() - t0
        if timing:  # the events precede the read, so they are complete
            self.last_parts_ms = {name: a.elapsed_time(b) for (_, a), (name, b) in zip(events, events[1:])}
            self.last_parts_ms["sync (host wait)"] = (time.perf_counter() - t_read) * 1e3
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
