"""GRPO on prefix-shared rollouts through the pluggable per-sequence loss.

Counterpart of the JAX package's ``examples/grpo.py``:

1. a fixed batch of rollout groups (synthetic tries with shared prompts);
2. behavior ("old") log-probs from one inference walk (``engine.forward``);
3. a synthetic reward per completion (the fraction of even tokens),
   standardised within each prompt group (GRPO advantages);
4. steps of a clipped-ratio objective through
   ``engine.loss_and_grad_custom`` and AdamW: every shared prefix token is
   forwarded and backpropagated once for the whole group.

    python -m dynamictreeattn_tpu_torch.examples.grpo --model qwen3-0.6b --steps 5   # card
    python -m dynamictreeattn_tpu_torch.examples.grpo --model qwen3-tiny --steps 5 \\
        --device cpu --attn-backend reference --dtype fp32 --block-q 32 --block-kv 32
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dynamictreeattn_tpu_torch.cli.common import add_engine_args, add_model_args, build_engine, build_model
from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves

__all__ = ["grpo_advantages", "make_grpo_loss", "grpo_extras", "adamw", "apply_grads", "main"]


def grpo_advantages(rewards: np.ndarray, groups: np.ndarray) -> np.ndarray:
    """Per-sequence advantage: reward standardized within its prompt group."""
    adv = np.zeros_like(rewards, dtype=np.float32)
    for g in np.unique(groups):
        m = groups == g
        r = rewards[m]
        adv[m] = (r - r.mean()) / (r.std() + 1e-6)
    return adv


def make_grpo_loss(clip_eps: float, ent_bonus: float):
    """Per-sequence clipped-ratio loss for ``loss_and_grad_custom``: extras
    "behavior_lp" [Lmax-1], "adv" (scalar) and "prompt_len" (int); the mean
    over the completion's edges, minus an entropy bonus over all positions."""

    def loss_fn(lp, ent, extras, length):
        # token mask: completion edges only (prompt tokens are context)
        t = torch.arange(lp.shape[0], device=lp.device)
        m = ((t < length - 1) & (t >= extras["prompt_len"] - 1)).float()
        n_tok = torch.clamp(m.sum(), min=1.0)
        # mask INSIDE the exp: padded rows would overflow to inf and turn
        # the masked product into NaN
        ratio = torch.exp(torch.where(m > 0, lp - extras["behavior_lp"], 0.0))
        adv = extras["adv"]  # scalar, sequence-level (GRPO)
        obj = torch.minimum(ratio * adv, torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv)
        m_en = (torch.arange(ent.shape[0], device=ent.device) < length).float()
        return -(obj * m).sum() / n_tok - ent_bonus * (ent * m_en).sum() / torch.clamp(length, min=1)

    return loss_fn


def grpo_extras(batch, old_lp: dict, adv: np.ndarray, prompt_lens: np.ndarray, device) -> dict:
    """``make_grpo_loss``'s extras on `device`, rows in
    ``batch.packed.seq_batch_ids`` order: the behavior log-probs `old_lp`
    (``engine.forward``'s, zero-padded to Lmax-1), the advantage and the
    prompt length of each sequence (`adv`, `prompt_lens` by batch id)."""
    ids = [int(b) for b in batch.packed.seq_batch_ids]
    beh = np.zeros((len(ids), int(batch.packed.seq_lens.max()) - 1), np.float32)
    for row, b in enumerate(ids):
        beh[row, : len(old_lp[b])] = old_lp[b]
    return {
        "behavior_lp": torch.from_numpy(beh).to(device),
        "adv": torch.from_numpy(adv[ids].astype(np.float32)).to(device),
        "prompt_len": torch.from_numpy(prompt_lens[ids].astype(np.int32)).to(device),
    }


def adamw(params, lr: float) -> torch.optim.AdamW:
    """AdamW over the leaves of `params` with ``optax.adamw``'s defaults
    (torch's weight decay default is 1e-2, optax's 1e-4); its state keeps
    the params' dtype, as optax's does."""
    return torch.optim.AdamW([t for _, t in named_leaves(params)], lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def apply_grads(opt: torch.optim.Optimizer, params, grads) -> None:
    """One optimizer step on `params` in place, with `grads` (the engine's,
    same structure and layouts) as the leaves' .grad."""
    for (_, p), (_, g) in zip(named_leaves(params), named_leaves(grads)):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    add_engine_args(p)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--n-prompts", type=int, default=2)
    p.add_argument("--samples", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=48)
    p.add_argument("--completion-len", type=int, default=24)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--clip-eps", type=float, default=0.2)
    p.add_argument("--ent-bonus", type=float, default=0.01)
    args = p.parse_args(argv)

    mc, params = build_model(args)
    engine, _ = build_engine(mc, args)
    opt = adamw(params, args.lr)

    # one fixed rollout batch (a real loop would resample per step)
    seqs, attachs = synthetic_rollout_batch(
        seed=args.seed, n_prompts=args.n_prompts, samples_per_prompt=args.samples,
        prompt_len=(args.prompt_len, args.prompt_len + 16),
        completion_len=(args.completion_len, args.completion_len + 8),
        vocab_size=mc.vocab_size,
    )
    # synthetic reward: fraction of even tokens in the completion, a
    # learnable target standing in for a verifier or reward model
    prompt_lens = np.array([int(a.get("prompt_len", args.prompt_len)) for a in attachs])
    groups = np.array([int(a.get("prompt_id", i // args.samples)) for i, a in enumerate(attachs)])
    rewards = np.array([float((np.asarray(s)[pl:] % 2 == 0).mean()) for s, pl in zip(seqs, prompt_lens)])
    adv = grpo_advantages(rewards, groups)

    batch = engine.prepare(TokenTrie(seqs, attachs))
    # behavior log-probs from the current policy (one inference tree walk)
    extras = grpo_extras(batch, engine.forward(params, batch), adv, prompt_lens, engine.device)

    loss_fn = make_grpo_loss(args.clip_eps, args.ent_bonus)
    history = []
    for step in range(args.steps):
        loss, grads = engine.loss_and_grad_custom(params, batch, loss_fn, extras)
        apply_grads(opt, params, grads)
        rec = {"step": step + 1, "loss": float(loss), "mean_reward": float(rewards.mean())}
        history.append(rec)
        print(json.dumps(rec), flush=True)
    return history


if __name__ == "__main__":
    main()
