"""``calibrate.py``'s training readings for a cell of entry "train_mla" (a
DeepSeek-V3 configuration, ``drivers/train_mla.py``): the program's checked
path, the fp8 control and the planted faults (``faults.py``) at the cell's
own size, on each seed, for setting the cell's limits. The benchmark's own
runs do not run this.

    python3 benchmark/calibrate_mla.py --workload <cell> --seeds 1,2 --what program,control,half,alter

Each side is judged as a run judges the program: against a reference that
follows the side's own routing (``train_mla.reference``), so every side
costs a reference of its own. "unforced" judges the program against a
reference that routes by its own top-k, as ``check.py`` alone would.
Prints one JSON line per (seed, what) with the numbers, and the
reference's drop and bias-moved shares. With ``--out DIR`` it also writes,
per seed, ``DIR/seed_<n>.json``: every leaf's numbers (each side's first
gradient norm and change norm, its reference's, and the norm of the
side's first gradient's difference from its reference's). A side's first
gradient is kept in host memory (bf16, about 11 GB at
Moonlight-16B-A3B-9l) beside the reference's float32 moments (43 GB).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import harness


def readings(cell, seed: int, whats, device: str, out_dir: Path | None = None) -> dict:
    import check
    import faults
    import generator

    drv = harness.load_module(harness.BENCH / "drivers" / "train_mla.py")
    ctx = harness.Ctx(cell, seed, 0.0, False, device, time.perf_counter())
    pool = generator.train_pool(cell.mix, cell.cfg["vocab_size"], seed)
    numbers, leaves = {}, {}
    program = None
    for what in whats:
        if what == "control":
            side = drv.reference(ctx, pool, "fp8", keep_first=True)
        elif what == "unforced":
            side, program = dict(program, routes=None), None
        else:
            with faults.TRAIN[what]() if what in faults.TRAIN else contextlib.nullcontext():
                trainer, _, paths = drv.start(ctx)
                side = drv.program_checks(trainer, pool, cell.mix["check_steps"], ctx, paths)
                del trainer
                drv.base.free(ctx)
        routes = []
        if device != "cpu":
            import torch

            drv.base.roomy_allocator()
            torch.cuda.reset_peak_memory_stats()
        if what == "unforced":
            reference = drv.ref.train_steps(
                ctx.cfg, lambda: drv.ref.make_weights(ctx.cfg, ctx.seed, ctx.device), pool[:ctx.mix["check_steps"]],
                ctx.mix["learning_rate"], ctx.mix["grad_clip"], "fp32",
                {what: (side["first_grad"], side["first_grad_scale"])}, route_log=routes)
            numbers[what] = check.train_numbers(side, reference, what)
        else:
            reference = drv.reference(ctx, pool, against={what: side}, route_log=routes)
            numbers[what] = drv.train_numbers(side, reference, what)
        if device != "cpu":
            print(f"seed {seed} {what}: {drv.base.reference_memory()}", file=sys.stderr)
        print(f"seed {seed} {what}: drop share {drv.base.drop_share(routes)}, bias moved {drv.bias_share(routes)}",
              file=sys.stderr, flush=True)
        leaves[what] = {"loss": side["loss"], "grad_norm": side["grad_norm"], "change_norm": side["change_norm"],
                        "grad_diff_norm": reference["grad_diff_norm"][what],
                        "reference": {key: reference[key] for key in ("loss", "grad_norm", "change_norm")}}
        if what == "program" and "unforced" in whats:
            program = side
        del side, reference
        drv.base.free(ctx)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"seed_{seed}.json").write_text(json.dumps({"numbers": numbers, "leaves": leaves}, indent=1))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--what", default="program",
                    help="comma-separated: program, unforced (after program), control, and fault names")
    ap.add_argument("--out", type=Path, default=None, help="a directory for each seed's leaf readings")
    args = ap.parse_args(argv)
    harness.set_env()
    cell = harness.find_cell(args.workload)
    sys.path.insert(0, str(harness.ROOT))
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        for what, numbers in readings(cell, seed, args.what.split(","), "cuda", args.out).items():
            print(json.dumps({"cell": cell.name, "seed": seed, "what": what, **numbers}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
