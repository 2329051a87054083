"""Entry "rollout": ``Trainer.rollout(prompts, prompt_lens, group, max_new)``
(the port's ``generate_grouped``: each prompt prefilled once, ``group``
branches decoded against the shared prompt cache by the replayed CUDA
graph), rollout after rollout on the next prompts of the run's pool.

Set-up builds the Trainer on the benchmark's weights and runs one warm
rollout. The window runs rollouts back to back until ``--seconds`` have
passed and finishes the one under way; every one samples at the mix's
temperature with no filter and no EOS, so every branch runs to
``max_new``. After the window the same Trainer runs one greedy rollout
through the same call on the next prompts, at the same sizes. The
reference then replays, from the seed, ``check_branches`` branches of the
greedy rollout (``greedy_gap``: each served token's reference logit against
the reference's best at its position) and ``sample_branches`` branches of
the window's sampled rollouts (``sample_z``: their tokens' reference
log-likelihood against its expectation), the longest prompt among each. A
traced run traces one rollout of the window.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

import check
import generator
import harness
from reference import model as ref
from reference.weights import make_weights

TRACED = 2  # the window's rollout that a traced run traces


def draw_branches(units: list, n: int, seed: int, stream: int) -> list:
    """(unit, prompt, branch) triples of the units to check: the longest
    prompt first, then a draw from the seed."""
    cands = [(u, p, g) for u, unit in enumerate(units) for p in range(len(unit["plens"])) for g in range(unit["group"])]
    rng = generator.rng(seed, stream)
    longest = max(cands, key=lambda c: units[c[0]]["plens"][c[1]])
    rest = [cands[i] for i in rng.permutation(len(cands)) if cands[i] != longest]
    return [longest] + rest[:n - 1]


def served(units, pool, triple):
    """(tokens of prompt + served, first position the reference reads,
    served tokens) of one branch."""
    u, p, g = triple
    prompts, lens = pool[units[u]["prompts"]]
    plen = int(lens[p])
    toks = units[u]["tokens_out"][p, g]
    return np.concatenate([prompts[p, :plen], toks[:-1]]), plen - 1, toks


def start(ctx: harness.Ctx):
    """(rollout(i, greedy), pool, trainer): the Trainer on the benchmark's
    weights, and a call of its rollout on the pool's i-th prompts."""
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg, mix = ctx.cfg, ctx.mix
    pool = generator.prompt_pool(mix, cfg["vocab_size"], ctx.seed)
    trainer = Trainer(harness.port_config(cfg), EngineConfig(), TrainConfig(), device=ctx.device)
    trainer.set_params(make_weights(cfg, ctx.seed, ctx.device))
    gen = torch.Generator(device=ctx.device).manual_seed(int(generator.rng(ctx.seed, 4).integers(2**62)))

    def rollout(i, greedy):
        prompts, lens = pool[i]
        return trainer.rollout(prompts, lens, mix["group"], mix["max_new"], generator=gen,
                               temperature=mix["temperature"], greedy=greedy)

    return rollout, pool, trainer


def unit_of(pool, b: int, mix: dict, toks) -> dict:
    return {"prompts": b, "plens": [int(x) for x in pool[b][1]], "group": mix["group"], "max_new": mix["max_new"],
            "tokens_out": toks}


def readings(ctx: harness.Ctx, greedy_units, sampled_units, pool, control: bool = False) -> dict:
    """{"greedy_gap", "sample_z"} of the program's tokens; with `control`,
    also the control's ("control.greedy_gap": the gap of the token the
    fp8 reference puts first; "control.sample_z": of a token drawn from
    the fp8 reference's distribution) at each position of the same
    prompts and served tokens, all read on the float32 reference's
    logits."""
    served_ref = ref.Served(ctx.cfg, make_weights(ctx.cfg, ctx.seed, ctx.device))
    out = {"greedy_gap": 0.0, "control.greedy_gap": 0.0} if control else {"greedy_gap": 0.0}
    for triple in draw_branches(greedy_units, ctx.mix["check_branches"], ctx.seed, 3):
        seq, first, toks = served(greedy_units, pool, triple)
        logits = served_ref.logits(seq, first)
        out["greedy_gap"] = max(out["greedy_gap"], check.greedy_gap(logits, toks))
        if control:
            pick = served_ref.logits(seq, first, "fp8").argmax(dim=1)
            out["control.greedy_gap"] = max(out["control.greedy_gap"], check.greedy_gap(logits, pick))
    terms, control_terms = [], []
    draw = torch.Generator(device=ctx.device).manual_seed(int(generator.rng(ctx.seed, 5).integers(2**62)))
    for triple in draw_branches(sampled_units, ctx.mix["sample_branches"], ctx.seed, 6):
        seq, first, toks = served(sampled_units, pool, triple)
        logits = served_ref.logits(seq, first)
        terms.append(check.sample_terms(logits, toks))
        if control:
            probs = torch.softmax(served_ref.logits(seq, first, "fp8"), dim=1)
            control_terms.append(check.sample_terms(logits, torch.multinomial(probs, 1, generator=draw)[:, 0]))
    out["sample_z"] = check.sample_z(terms)
    if control:
        out["control.sample_z"] = check.sample_z(control_terms)
    return out


def run(ctx: harness.Ctx) -> harness.Run:
    cfg, mix = ctx.cfg, ctx.mix
    rollout, pool, trainer = start(ctx)
    rollout(0, False)
    cuda = ctx.device != "cpu"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx.setup_done()

    units, traces = [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    while True:
        i = len(units)
        b = (1 + i) % len(pool)
        unit = unit_of(pool, b, mix, None)
        unit.update(work=tuple(sorted(unit["plens"])), traced=ctx.trace and i == TRACED)  # every set's lengths
        t0 = time.perf_counter()
        if unit["traced"]:
            toks, tr = harness.profiled(lambda: rollout(b, False))
            tr.unit = unit
            traces.append(tr)
        else:
            toks = rollout(b, False)
        t1 = time.perf_counter()
        unit.update(wall_s=t1 - t0, tokens=int(toks.size), tokens_out=toks)
        units.append(unit)
        if t1 - t_start >= ctx.seconds and (not ctx.trace or i >= TRACED):
            break
    window_s = t1 - t_start
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    t_check = time.perf_counter()
    b = (1 + len(units)) % len(pool)
    greedy = [unit_of(pool, b, mix, rollout(b, True))]

    del trainer, rollout
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = readings(ctx, greedy, units, pool)
    print(f"setup {ctx.setup_s:.1f} s, window {window_s:.1f} s ({len(units)} rollouts), "
          f"greedy rollout and reference {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    e2e = {"rollout_tokens_per_s": sum(u["tokens"] for u in units) / window_s,
           "peak_mem_gib": window_peak / 2**30, "setup_s": ctx.setup_s}
    for u in units:
        u["tokens_out"] = None
    checks = {name: (got[name], ctx.cell.limits[name]) for name in ("greedy_gap", "sample_z")}
    return harness.Run(cfg, mix, units, traces, e2e, checks, attempted=len(units), failed=0,
                       memory_peak_bytes=max(setup_peak, window_peak))
