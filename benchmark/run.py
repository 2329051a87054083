"""Run one cell of the benchmark on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result line holds the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (a few units of the window run
under the profiler). Every run checks what its timed path produced against
the plain reference and prints each number compared with its limit, last
on standard error and under "checks" in the result line, which is the last
line of standard output. Exits non-zero, with no result line, when the
cell needs more CUDA cards than there are, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.set_env()
    cell = harness.find_cell(args.workload)
    sys.path.insert(0, str(harness.ROOT))  # the program under test
    import torch

    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result", file=sys.stderr)
        return 3
    readers = {m["name"]: harness.load_module(harness.reader_path(m["name"])).read
               for m in cell.per_layer} if args.trace else {}
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell.mix['entry']}.py")
    ctx = harness.Ctx(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    run = driver.run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {bad}: no result", file=sys.stderr)
        return 4
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    if args.trace:
        print(f"device time by layer: {harness.layer_times(run.traces)}", file=sys.stderr)
    out = harness.result_line(cell, run, bool(args.trace), harness.device_info("cuda", chips), readers)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
