"""Grad-dump comparison CLI: the gradient-parity table of two .npz files.

Counterpart of ``dynamictreeattn_tpu/cli/compare_grads.py``; the same two
files give the same text. Per parameter (stacked [L, ...] leaves per layer):
``‖g_exp − g_base‖ / ‖g_base‖`` in float64, sorted descending, then a line
with the max, median and min.

    python -m dynamictreeattn_tpu_torch.cli.compare_grads \\
        --baseline-grad dense.npz --exp-grad tree.npz --out table.txt
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from dynamictreeattn_tpu_torch.cli.common import load_grads_npz
from dynamictreeattn_tpu_torch.utils.compare_grads import format_grad_table


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--baseline-grad", required=True)
    p.add_argument("--exp-grad", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--top", type=int, default=None)
    args = p.parse_args(argv)

    base = load_grads_npz(args.baseline_grad)
    exp = load_grads_npz(args.exp_grad)
    for k in sorted(set(base) - set(exp)):
        print(f"WARNING: missing in exp: {k}", file=sys.stderr)
    for k in sorted(set(exp) - set(base)):
        print(f"WARNING: extra in exp: {k}", file=sys.stderr)

    rows = []
    for k in sorted(set(base) & set(exp)):
        gb, ge = base[k].astype(np.float64), exp[k].astype(np.float64)
        if gb.ndim >= 2 and "layers" in k:  # stacked [L, ...] leaves -> per layer
            rows += [_row(f"{k}[{i}]", gb[i], ge[i]) for i in range(gb.shape[0])]
        else:
            rows.append(_row(k, gb, ge))
    rows.sort(key=lambda r: -r[1])

    rels = [r for _, r, _ in rows if np.isfinite(r)]
    text = (format_grad_table(rows, args.top)
            + f"\n# {len(rows)} params: max {max(rels):.4e} median {np.median(rels):.4e} min {min(rels):.4e}")
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


def _row(name, gb, ge):
    # numpy float64 norms, as the JAX CLI takes them, so that the text agrees
    nb = float(np.linalg.norm(gb))
    diff = float(np.linalg.norm(ge - gb))
    rel = diff / nb if nb > 0 else (0.0 if diff == 0 else float("inf"))
    return (name, rel, nb)


if __name__ == "__main__":
    main()
