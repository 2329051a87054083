"""Data-parallel binning CLI: load the sequence files of a folder,
optionally fit a TreeTimeModel from a stats JSONL, partition each batch
into K bins with the chosen method, write ``{name}_bin{k}`` files and report
the predicted per-bin times.

Counterpart of ``dynamictreeattn_tpu/cli/data_parallel.py`` (the same files
and text):

    python -m dynamictreeattn_tpu_torch.cli.data_parallel --data-dir data/tau2 \
        --K 4 --method LB_by_DFS_and_TM --stats stats/tree.jsonl --out-dir bins/
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from dynamictreeattn_tpu_torch.data.io import load_sequences, save_sequences
from dynamictreeattn_tpu_torch.parallel import (
    LB_by_DFS_and_TM,
    LB_by_n_tokens,
    LB_by_TM,
    TreeTimeModel,
    eval_bins,
)

METHODS = ["LB_by_n_tokens", "LB_by_TM", "LB_by_DFS_and_TM"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--glob", default="*.pt")
    p.add_argument("--K", type=int, required=True)
    p.add_argument("--method", default="LB_by_DFS_and_TM", choices=METHODS)
    p.add_argument("--mode", default="backward", choices=["forward", "backward"])
    p.add_argument("--block-size", type=int, default=2048)
    p.add_argument("--stats", default=None,
                   help="stats JSONL to fit the TreeTimeModel from")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--eval", action="store_true",
                   help="print predicted per-bin times")
    args = p.parse_args(argv)

    tm = TreeTimeModel()
    if args.stats:
        with open(args.stats) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        tm.add_data([r for r in recs if "time" in r and "n_tree_tokens" in r])
        print(f"time model fitted on {len(recs)} records, "
              f"avg rel err {tm.avg_rel_error():.3f}")

    os.makedirs(args.out_dir, exist_ok=True)
    for f in sorted(glob.glob(os.path.join(args.data_dir, args.glob))):
        seqs = load_sequences(f)
        if args.method == "LB_by_n_tokens":
            bins = LB_by_n_tokens(seqs, args.K)
        elif args.method == "LB_by_TM":
            bins = LB_by_TM(seqs, tm, args.K, mode=args.mode, block_size=args.block_size)
        else:
            bins = LB_by_DFS_and_TM(
                seqs, tm, args.K, mode=args.mode, block_size=args.block_size
            )
        name, ext = os.path.splitext(os.path.basename(f))
        for k, ids in enumerate(bins):
            out = os.path.join(args.out_dir, f"{name}_bin{k}{ext}")
            save_sequences(out, [seqs[i] for i in ids])
        rec = {"file": os.path.basename(f), "method": args.method,
               "K": args.K, "bin_sizes": [len(b) for b in bins]}
        if args.eval:
            rec.update(eval_bins(seqs, bins, tm, mode=args.mode,
                                 block_size=args.block_size))
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
