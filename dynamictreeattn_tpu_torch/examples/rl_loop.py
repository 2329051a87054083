"""The RL loop on one device: sample rollouts → reward → GRPO update.

Counterpart of the JAX package's ``examples/rl_loop.py``. Each iteration:

1. **Rollout**: ``generate_grouped`` samples G completions per prompt
   against one shared prompt KV cache (on the card: K13 in a replayed
   decode step), the prefix-sharing structure the tree engine exploits;
2. **Reward**: a synthetic verifier (the fraction of even tokens) and GRPO
   advantages standardised within each prompt group;
3. **Behavior log-probs**: one inference walk of the rollout trie
   (``engine.forward``);
4. **Update**: one fused tree step over the whole rollout trie through
   ``loss_and_grad_custom`` (the clipped ratio against the behavior
   log-probs) and AdamW.

Samples are drawn from a ``torch.Generator`` seeded ``--seed + 1``, so the
sampled tokens, and the reward trajectory, are not the JAX package's. Each
record holds ``t_rollout``, ``t_behavior_fwd``, ``t_train`` and ``t_iter``
(host seconds, each ending in a device synchronisation) and, on a card,
``peak_mem_gb`` of the iteration.

    python -m dynamictreeattn_tpu_torch.examples.rl_loop --model qwen3-0.6b --iters 4   # card
    python -m dynamictreeattn_tpu_torch.examples.rl_loop --model qwen3-tiny --iters 8 \\
        --device cpu --attn-backend reference --dtype fp32 --block-q 32 --block-kv 32
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from dynamictreeattn_tpu_torch.cli.common import add_engine_args, add_model_args, build_engine, build_model
from dynamictreeattn_tpu_torch.examples.grpo import (
    adamw, apply_grads, grpo_advantages, grpo_extras, make_grpo_loss,
)
from dynamictreeattn_tpu_torch.models import generate_grouped
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.utils.profiling import device_memory_stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    add_engine_args(p)
    p.add_argument("--iters", type=int, default=8)
    p.add_argument("--n-prompts", type=int, default=2)
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=24)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--rollout-temp", type=float, default=1.0)
    p.add_argument("--clip-eps", type=float, default=0.2)
    p.add_argument("--ent-bonus", type=float, default=0.0)
    args = p.parse_args(argv)

    mc, params = build_model(args)
    engine, _ = build_engine(mc, args)
    dev = engine.device
    opt = adamw(params, args.lr)
    loss_fn = make_grpo_loss(args.clip_eps, args.ent_bonus)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, mc.vocab_size, size=(args.n_prompts, args.prompt_len)).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B = args.n_prompts * args.samples
    lens = np.full((args.n_prompts,), args.prompt_len, np.int32)
    prompt_rows = np.repeat(prompts, args.samples, axis=0)
    attachs = [{"prompt_id": b // args.samples, "prompt_len": args.prompt_len} for b in range(B)]
    groups = np.array([a["prompt_id"] for a in attachs])
    prompt_lens = np.full((B,), args.prompt_len, np.int32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history = []
    for it in range(args.iters):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        sync()
        t0 = time.perf_counter()
        # rollout: G samples per prompt against a shared prompt KV cache
        out = generate_grouped(params, mc, prompts, lens, args.samples, args.max_new, generator=gen,
                               temperature=args.rollout_temp).reshape(B, args.max_new)
        seqs = [np.concatenate([prompt_rows[b], out[b]]).astype(np.int32) for b in range(B)]
        t_roll = time.perf_counter() - t0

        # reward + GRPO advantages
        rewards = np.array([float((out[b] % 2 == 0).mean()) for b in range(B)])
        adv = grpo_advantages(rewards, groups)

        # behavior log-probs, then one fused tree-training step
        batch = engine.prepare(TokenTrie(seqs, attachs))
        t1 = time.perf_counter()
        old_lp = engine.forward(params, batch)  # host arrays: synchronised
        t_fwd = time.perf_counter() - t1
        extras = grpo_extras(batch, old_lp, adv, prompt_lens, dev)
        t2 = time.perf_counter()
        loss, grads = engine.loss_and_grad_custom(params, batch, loss_fn, extras)
        apply_grads(opt, params, grads)
        sync()
        t_train = time.perf_counter() - t2

        rec = {"iter": it + 1, "loss": float(loss), "mean_reward": float(rewards.mean()),
               "n_tree_tokens": int(batch.packed.n_tokens), "t_rollout": t_roll,
               "t_behavior_fwd": t_fwd, "t_train": t_train, "t_iter": time.perf_counter() - t0}
        mem = device_memory_stats(dev)
        if mem.get("peak_bytes_in_use"):
            rec["peak_mem_gb"] = mem["peak_bytes_in_use"] / 2**30
        history.append(rec)
        print(json.dumps(rec), flush=True)
    return history


if __name__ == "__main__":
    main()
