"""Readings that the limits of a cell's compared numbers are set from: the
program's checked path on many seeds (the lower reading), the control (the
reference one precision down, fp8, in the program's place) and the planted
faults (``faults.py``) at the cell's own size (the upper reading). The
benchmark's own runs do not run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --what program,control,half,alter

Prints one JSON line per (seed, what) with the numbers the cell compares.
A training cell's readings need no window; a rollout cell's run one
sampled rollout and one greedy rollout through the window's call (a run
draws its sampled branches from several). For a MoE cell, "program" also records the program's
first routing (its ``moe_route``) and prints, layer by layer, the rows
whose top-k choices differ from the reference's, and the reference's
margin between its k-th and (k+1)-th router probability there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import harness


@contextlib.contextmanager
def program_routes(log: list, layers: int):
    """Records the program's first `layers` routings (idx [rows, k])."""
    import faults
    from dynamictreeattn_tpu_torch.models import qwen3

    orig = qwen3.moe_route

    def recording(h, router, config, *args, **kw):
        w, idx, lb = orig(h, router, config, *args, **kw)
        if len(log) < layers:
            log.append(idx.detach().cpu())
        return w, idx, lb

    with faults.patched(qwen3, "moe_route", recording):
        yield


def route_flips(program: list, reference: list, k: int) -> list:
    """Per layer: rows whose top-k set differs, pairs that differ, and the
    reference's k-th to (k+1)-th margin at those rows against all rows."""
    import torch

    out = []
    for pidx, r in zip(program, reference):
        ridx = r["idx"]
        n = ridx.shape[0]
        E = int(max(int(pidx[:n].max()), int(ridx.max()))) + 1
        pm = torch.zeros(n, E).scatter_(1, pidx[:n].long(), 1.0)
        rm = torch.zeros(n, E).scatter_(1, ridx.long(), 1.0)
        shared = (pm * rm).sum(1)
        rows = shared < k
        m = r["margin"]
        out.append({"rows": int(rows.sum()), "of": n, "pairs": int((k - shared).sum()),
                    "margin_flipped_max": float(m[rows].max()) if rows.any() else None,
                    "margin_median": float(m.median())})
    return out


def train_readings(cell, seed: int, whats, device: str):
    import check
    import faults
    import generator

    drv = harness.load_module(harness.BENCH / "drivers" / "train.py")
    ctx = harness.Ctx(cell, seed, 0.0, False, device, time.perf_counter())
    moe = bool(cell.cfg.get("num_experts", 0))
    layers = cell.cfg["num_hidden_layers"]
    out, prog_routes = {}, []
    for what in whats:
        if what == "control":
            continue
        with contextlib.ExitStack() as stack:
            if what in faults.TRAIN:
                stack.enter_context(faults.TRAIN[what]())
            if moe and what == "program":
                stack.enter_context(program_routes(prog_routes, layers))
            trainer, pool, paths = drv.start(ctx)
            out[what] = drv.program_checks(trainer, pool, cell.mix["check_steps"], ctx, paths)
            del trainer
            drv.free(ctx)
    pool = generator.train_pool(cell.mix, cell.cfg["vocab_size"], seed)
    if "control" in whats:
        out["control"] = drv.reference(ctx, pool, "fp8", keep_first=True)
    ref_routes = [] if moe else None
    if device != "cpu":
        import torch

        drv.roomy_allocator()
        torch.cuda.reset_peak_memory_stats()
    reference = drv.reference(ctx, pool, against=out, route_log=ref_routes)
    if device != "cpu":
        print(f"seed {seed}: {drv.reference_memory()}", file=sys.stderr)
    res = {what: check.train_numbers(r, reference, what) for what, r in out.items()}
    if ref_routes:
        print(f"seed {seed}: moe drop share (reference, first step; by layer) {drv.drop_share(ref_routes)}",
              file=sys.stderr)
        if prog_routes:
            res["program"]["routing"] = route_flips(prog_routes, ref_routes, cell.cfg["num_experts_per_tok"])
    return res


def rollout_readings(cell, seed: int, whats, device: str):
    import faults

    drv = harness.load_module(harness.BENCH / "drivers" / "rollout.py")
    ctx = harness.Ctx(cell, seed, 0.0, False, device, time.perf_counter())
    out = {}
    for what in [w for w in whats if w != "control"] or ["program"]:
        with faults.ROLLOUT[what]() if what in faults.ROLLOUT else contextlib.nullcontext():
            rollout, pool, trainer = drv.start(ctx)
            b, c = 1 % len(pool), 2 % len(pool)  # as a window's first rollout and the greedy one after
            sampled = [drv.unit_of(pool, b, cell.mix, rollout(b, False))]
            greedy = [drv.unit_of(pool, c, cell.mix, rollout(c, True))]
            del trainer, rollout
            drv.gc.collect()
        got = drv.readings(ctx, greedy, sampled, pool, control="control" in whats and what == "program")
        out[what] = {k: got[k] for k in ("greedy_gap", "sample_z")}
        if "control.sample_z" in got:
            out["control"] = {"greedy_gap": got["control.greedy_gap"], "sample_z": got["control.sample_z"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--what", default="program", help="comma-separated: program, control, and fault names")
    args = ap.parse_args(argv)
    harness.set_env()
    cell = harness.find_cell(args.workload)
    sys.path.insert(0, str(harness.ROOT))
    whats = args.what.split(",")
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        readings = train_readings if cell.mix["entry"] == "train" else rollout_readings
        for what, numbers in readings(cell, seed, whats, "cuda").items():
            print(json.dumps({"cell": cell.name, "seed": seed, "what": what, **numbers}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
