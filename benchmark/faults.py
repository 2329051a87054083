"""Faults planted in the program under test, to show that the comparison
that decides ``correct`` catches them (``tests/test_bench_faults.py`` at a
tiny size on the CPU; ``calibrate.py`` reads them at a cell's own size).
Each is a context manager that patches the port and restores it on exit.

Training: "stale", a step that leaves the parameters and the optimizer
state unchanged; "half", half of each batch left out, the loss's weights
doubled on the rest (the mean over the rest); "alter", the gradient of
one leaf altered where the step produces it. Rollout: "stale", a decode
step that leaves the K/V caches unchanged; "half", half of the prompts
left out (their rows never produced); "alter", the first token of every
branch altered where it is sampled; "swap", each decode step's K/V of a
branch written into the next branch's slot of the completion cache, so
that every branch reads another's history (what a fault in the grouped
decode's per-branch columns does; greedy branches of one prompt are alike
and cannot show it).
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def train_stale():
    from dynamictreeattn_tpu_torch.training.trainer import OptaxAdamW

    def update(self, grads, state, params, good, mark=None):
        return params, state

    return patched(OptaxAdamW, "update", update)


def train_half():
    from dynamictreeattn_tpu_torch.training.trainer import Trainer

    orig = Trainer.partition_with_ids

    def half(self, seqs, attachs, n_bins=None):
        keep = [dict(a, w_logprobs=2 * a["w_logprobs"], w_entropy=2 * a["w_entropy"]) for a in attachs[::2]]
        return orig(self, seqs[::2], keep, n_bins)

    return patched(Trainer, "partition_with_ids", half)


def train_alter(leaf=("layers", "wo"), factor=2.0):
    from dynamictreeattn_tpu_torch.engine.tree_engine import TreeEngine

    orig = TreeEngine.loss_and_grad

    def altered(self, params, batch):
        loss, grads, aux = orig(self, params, batch)
        node = grads
        for key in leaf[:-1]:
            node = node[key]
        node[leaf[-1]].mul_(factor)
        return loss, grads, aux

    return patched(TreeEngine, "loss_and_grad", altered)


def rollout_stale():
    generate = importlib.import_module("dynamictreeattn_tpu_torch.models.generate")
    return patched(generate, "_write_slot", lambda cache, t, val: None)


def rollout_half():
    trainer = importlib.import_module("dynamictreeattn_tpu_torch.training.trainer")
    orig = trainer.generate_grouped

    def half(params, config, prompts, prompt_lens, group, max_new, **kw):
        keep = max(1, len(prompt_lens) // 2)
        out = np.zeros((len(prompt_lens), group, max_new), np.int32)
        out[:keep] = orig(params, config, prompts[:keep], prompt_lens[:keep], group, max_new, **kw)
        return out

    return patched(trainer, "generate_grouped", half)


def rollout_alter():
    generate = importlib.import_module("dynamictreeattn_tpu_torch.models.generate")
    orig = generate._sampler

    def sampler(*args, **kw):
        sample, calls = orig(*args, **kw), [0]

        def altered(logits):
            tok = sample(logits)
            calls[0] += 1
            return (tok + 1) % logits.shape[-1] if calls[0] == 1 else tok

        return altered

    return patched(generate, "_sampler", sampler)


def rollout_swap():
    generate = importlib.import_module("dynamictreeattn_tpu_torch.models.generate")
    orig = generate._write_slot
    return patched(generate, "_write_slot", lambda cache, t, val: orig(cache, t, val.roll(1, dims=2)))


TRAIN = {"stale": train_stale, "half": train_half, "alter": train_alter}
ROLLOUT = {"stale": rollout_stale, "half": rollout_half, "alter": rollout_alter, "swap": rollout_swap}
