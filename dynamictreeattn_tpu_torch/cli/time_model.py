"""TreeTimeModel CLI: fit the NNLS cost model from a stats JSONL and print
its coefficients and average relative error.

Counterpart of ``dynamictreeattn_tpu/cli/time_model.py`` (the same text):

    python -m dynamictreeattn_tpu_torch.cli.time_model --stats stats/tree.jsonl
"""

from __future__ import annotations

import argparse
import json

from dynamictreeattn_tpu_torch.parallel.time_model import FEATURES, TreeTimeModel


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stats", required=True)
    p.add_argument("--min-points", type=int, default=16)
    args = p.parse_args(argv)

    with open(args.stats) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    recs = [r for r in recs if "time" in r and all(k in r for k in FEATURES)]
    tm = TreeTimeModel(min_points=args.min_points)
    tm.add_data(recs)
    if tm.coef is None:
        print(f"only {len(recs)} usable records (< {args.min_points}); not fitted")
        return
    print(json.dumps({
        "n_records": len(recs),
        "coefficients": dict(zip(FEATURES, [float(c) for c in tm.coef])),
        "avg_rel_error": tm.avg_rel_error(),
    }, indent=2))


if __name__ == "__main__":
    main()
