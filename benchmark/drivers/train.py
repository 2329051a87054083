"""Entry "train": ``Trainer.train_step(seqs, attachs)`` once per step on the
next rollout batch of the run's pool.

Set-up builds one Trainer on the benchmark's weights and drives it through
the mix's ``check_steps`` first steps by the window's own call, on distinct
batches; those steps are what the reference follows, and they warm every
kernel and the allocator. The window then trains step after step on the
pool's other batches, cycling, until ``--seconds`` have passed (the step
under way finishes). Each step ends in the Trainer's one host read, so the
host clock around it is the step's whole time. A traced run splits each
step into ``prepare_step`` and ``run_step`` (timed apart), records the
Trainer's device parts, and traces a few steps one by one.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

import check
import harness
import generator
from reference import model as ref
from reference.weights import leaves, make_leaf, make_weights

TRACED = (2, 3, 4)  # the window's steps that a traced run traces
B1 = 0.9  # the optimizer's first-moment decay: mu after one step is (1 - B1) * grad


def program_checks(trainer, pool, k, ctx, paths) -> dict:
    """The checked steps through the window's call: their losses, the
    first step's gradient norms from the optimizer's state, the change of
    every leaf after the last."""
    out = {"loss": []}
    for i in range(k):
        rec = trainer.train_step(*pool[i])
        out["loss"].append(rec["loss"])
        if i == 0:
            out["grad_norm"] = {".".join(p): float(torch.linalg.vector_norm(m.float())) / (1 - B1)
                                for p, m in zip(paths, trainer.opt_state["mu"])}
            out["first_grad"] = [m.to("cpu", copy=True) for m in trainer.opt_state["mu"]]
            out["first_grad_scale"] = 1 / (1 - B1)
    now = dict(zip(paths, [t for _, t in leaves(trainer.params)]))
    out["change_norm"] = {".".join(p): float(torch.linalg.vector_norm(
        now[p].float() - make_leaf(ctx.cfg, ctx.seed, p, ctx.device).float())) for p in paths}
    return out


def start(ctx: harness.Ctx):
    """(trainer, pool, leaf paths): the Trainer on the benchmark's weights,
    the run's batches."""
    from dynamictreeattn_tpu_torch.engine import EngineConfig
    from dynamictreeattn_tpu_torch.training.trainer import TrainConfig, Trainer

    cfg, mix = ctx.cfg, ctx.mix
    pool = generator.train_pool(mix, cfg["vocab_size"], ctx.seed)
    weights = make_weights(cfg, ctx.seed, ctx.device)
    trainer = Trainer(harness.port_config(cfg), EngineConfig(remat=mix["remat"]),
                      TrainConfig(learning_rate=mix["learning_rate"], grad_clip=mix["grad_clip"]), device=ctx.device)
    trainer.set_params(weights)
    return trainer, pool, [p for p, _ in leaves(weights)]


def reference(ctx: harness.Ctx, pool, precision: str = "fp32", against=None, keep_first=False,
              route_log=None) -> dict:
    """The reference's (or, at "fp8", the control's) checked steps;
    `against` {name: a side's results} to judge by their first grads;
    a MoE model's first routing into `route_log`."""
    return ref.train_steps(ctx.cfg, lambda: make_weights(ctx.cfg, ctx.seed, ctx.device), pool[:ctx.mix["check_steps"]],
                           ctx.mix["learning_rate"], ctx.mix["grad_clip"], precision,
                           {name: (side["first_grad"], side["first_grad_scale"]) for name, side in (against or {}).items()},
                           keep_first, route_log)


def roomy_allocator() -> None:
    """Expandable segments for what the process allocates from now on,
    once the program's state is freed and its numbers read: the
    reference's blocks come in many sizes, and a MoE step's fill the card
    (66 of 79 GiB allocated at its peak, 12 more reserved and unused in
    blocks of the wrong size), so they must not fragment it."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def reference_memory() -> str:
    """The card's peak since the last reset, against its size."""
    total = torch.cuda.get_device_properties(0).total_memory
    return (f"reference peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved, of {total / 2**30:.2f} GiB")


def drop_share(route_log: list) -> str:
    """The reference's first step's share of (row, choice) pairs that the
    capacity dispatch drops: over all layers, and each layer's."""
    total = sum(r["dropped"] for r in route_log) / sum(r["pairs"] for r in route_log)
    layers = ", ".join("%.1f" % (100 * r["dropped"] / r["pairs"]) for r in route_log)
    return f"{100 * total:.2f}% ({layers})"


def free(ctx: harness.Ctx) -> None:
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()


def run(ctx: harness.Ctx) -> harness.Run:
    cfg, mix = ctx.cfg, ctx.mix
    k = mix["check_steps"]
    trainer, pool, paths = start(ctx)
    program = program_checks(trainer, pool, k, ctx, paths)
    cuda = ctx.device != "cpu"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx.setup_done()

    trainer.time_parts = ctx.trace
    units, traces = [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    i = k
    while True:
        b = i % len(pool)
        seqs, attachs = pool[b]
        i += 1
        unit = {"batch": b, "work": b, "tokens": int(sum(len(s) for s in seqs)), "traced": ctx.trace and len(units) in TRACED}
        t0 = time.perf_counter()
        if ctx.trace:
            def step():
                t = time.perf_counter()
                batch, tries = trainer.prepare_step(seqs, attachs)
                unit["prepare_s"] = time.perf_counter() - t
                return trainer.run_step(batch, tries, len(seqs), unit["tokens"])

            if unit["traced"]:
                rec, tr = harness.profiled(step)
                tr.unit = unit
                traces.append(tr)
            else:
                rec = step()
            unit["parts_ms"] = dict(trainer.last_parts_ms or {})
        else:
            rec = trainer.train_step(seqs, attachs)
        t1 = time.perf_counter()
        unit.update(wall_s=t1 - t0, skipped=bool(rec.get("skipped")))
        units.append(unit)
        if t1 - t_start >= ctx.seconds and (not ctx.trace or len(units) > max(TRACED)):
            break
    window_s = t1 - t_start
    t_check = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    del trainer, rec
    free(ctx)
    if cuda:
        print(f"before the reference: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held", file=sys.stderr)
        roomy_allocator()
        torch.cuda.reset_peak_memory_stats()
    routes = [] if cfg.get("num_experts", 0) else None
    ref_side = reference(ctx, pool, against={"program": program}, route_log=routes)
    if cuda:
        print(reference_memory(), file=sys.stderr)
    if routes:
        print(f"moe drop share (reference, first checked step; by layer): {drop_share(routes)}", file=sys.stderr)
    numbers = check.train_numbers(program, ref_side)
    print(f"leaves in change_gap: {len(check.moving(ref_side['grad_norm']))} of {len(ref_side['grad_norm'])}",
          file=sys.stderr)
    print(f"setup {ctx.setup_s:.1f} s, window {window_s:.1f} s ({len(units)} steps), "
          f"reference {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    checks = {name: (value, ctx.cell.limits[name]) for name, value in numbers.items() if name in ctx.cell.limits}
    for name in sorted(set(numbers) - set(checks)):
        print(f"reading {name}: {numbers[name]!r} (not compared)", file=sys.stderr)
    e2e = {"train_tokens_per_s": sum(u["tokens"] for u in units) / window_s,
           "peak_mem_gib": window_peak / 2**30, "setup_s": ctx.setup_s}
    return harness.Run(cfg, mix, units, traces, e2e, checks, attempted=len(units),
                       failed=sum(u["skipped"] for u in units), memory_peak_bytes=max(setup_peak, window_peak),
                       cache={"pool": pool})
