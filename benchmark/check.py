"""The comparisons that decide ``correct``: what the timed path produced
against the plain reference (``reference/``), number by number.

Training: each checked step's loss; the norm of the first step's gradient
as the optimizer got it (after the clip); the norm of each parameter's
change after the checked steps. Norms are compared leaf by leaf, as the
gap between the program's norm and the reference's over the larger of the
reference's norm of that leaf and of the median leaf; the worst leaf is
the number. Norms average unbiased rounding away, so the first gradient
is also compared element by element: the norm of its difference from the
reference's, over the same denominator (``grad_diff``). Leaves whose reference gradient is under a thousandth of the
median leaf's move under Adam by round-off alone and are left out of the
change.

Rollout: greedy tokens, read through the reference's float32 logits at
the same positions: the widest gap by which a served token's logit lies
below the reference's best (``greedy_gap``). Sampled tokens, read the same
way: where each token was drawn from the reference's distribution p at its
position, log p(token) + H(p) has mean 0 and variance Var[log p] given the
tokens before it, so their sum over many positions over its standard
deviation is about a standard normal number; ``sample_z`` is minus that,
large where the served tokens are less likely than the distribution they
should come from makes them (a branch that reads another's history, a
stale cache, logits rounded too coarsely). Unlike ``greedy_gap`` it reads
branches of one prompt that differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

STILL = 1e-3  # a leaf whose reference gradient norm is under this share of the median leaf's


def loss_rel(program: list, reference: list) -> float:
    return max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf for p, r in zip(program, reference))


def leaf_gap(program: dict, reference: dict, keys=None) -> float:
    keys = list(reference) if keys is None else list(keys)
    med = float(np.median([reference[k] for k in reference]))
    worst = 0.0
    for k in keys:
        p = program.get(k, math.nan)
        gap = abs(p - reference[k]) / max(reference[k], med, 1e-30) if math.isfinite(p) else math.inf
        worst = max(worst, gap)
    return worst


def moving(reference_grads: dict) -> list:
    """The leaves whose first reference gradient is not nought to rounding."""
    med = float(np.median(list(reference_grads.values())))
    return [k for k, v in reference_grads.items() if v >= STILL * med]


def leaf_diff(diff: dict, reference: dict) -> float:
    """Worst leaf of the norm of a difference over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median(list(reference.values())))
    return max(d / max(reference[k], med, 1e-30) if math.isfinite(d) else math.inf for k, d in diff.items())


def train_numbers(program: dict, reference: dict, name: str = "program") -> dict:
    """{"loss_rel", "grad_gap", "grad_diff", "change_gap"} of the program's
    checked steps (or another side's in its place, judged by the reference
    as `name`) against the reference's."""
    return {
        "loss_rel": loss_rel(program["loss"], reference["loss"]),
        "grad_gap": leaf_gap(program["grad_norm"], reference["grad_norm"]),
        "grad_diff": leaf_diff(reference["grad_diff_norm"][name], reference["grad_norm"]),
        "change_gap": leaf_gap(program["change_norm"], reference["change_norm"], moving(reference["grad_norm"])),
    }


def greedy_gap(ref_logits: torch.Tensor, tokens) -> float:
    """Widest gap, over positions, between the reference's best logit and
    its logit of the token served there."""
    tok = torch.as_tensor(tokens).to(ref_logits.device, torch.long)
    if tok.numel() and (int(tok.min()) < 0 or int(tok.max()) >= ref_logits.shape[1]):
        return math.inf
    served = ref_logits.gather(1, tok[:, None])[:, 0]
    return float((ref_logits.max(dim=1).values - served).max())


def sample_terms(ref_logits: torch.Tensor, tokens) -> tuple[float, float]:
    """(sum of log p(token) + H(p), sum of Var[log p]) over the positions,
    p the reference's distribution at each."""
    tok = torch.as_tensor(tokens).to(ref_logits.device, torch.long)
    if tok.numel() and (int(tok.min()) < 0 or int(tok.max()) >= ref_logits.shape[1]):
        return -math.inf, 1.0
    logp = torch.log_softmax(ref_logits, dim=1)
    p = logp.exp()
    ent = -(p * logp).sum(dim=1)
    var = (p * logp * logp).sum(dim=1) - ent * ent
    served = logp.gather(1, tok[:, None])[:, 0]
    return float((served + ent).sum()), float(var.sum())


def sample_z(terms) -> float:
    """Minus the served tokens' summed log-likelihood above its
    expectation, in standard deviations, over (sum, variance) terms."""
    total, var = sum(t[0] for t in terms), sum(t[1] for t in terms)
    return -total / math.sqrt(var) if var > 0 and math.isfinite(total) else math.inf
