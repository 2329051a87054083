"""Folder CLI: one engine over every data file of a folder, stats to JSONL.

Counterpart of ``dynamictreeattn_tpu/cli/run_all.py``: per file one JSON
record with the trie's cost features (the execution-time model's training
data), then an aggregate line.

    python -m dynamictreeattn_tpu_torch.cli.run_all --data-dir data/synthetic-tau2 \\
        --glob '*.npz' --run tree_backward --stats-out tree.jsonl
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

from dynamictreeattn_tpu_torch.cli.common import (
    add_engine_args,
    add_model_args,
    append_stats,
    build_engine,
    build_model,
    prepare_trie,
    timed_call,
    weight_fn_from_args,
)
from dynamictreeattn_tpu_torch.cli.run import RUNS
from dynamictreeattn_tpu_torch.data.io import load_sequences
from dynamictreeattn_tpu_torch.engine import pack_sequences_dense
from dynamictreeattn_tpu_torch.tries import flatten_trie, trie_stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    add_engine_args(p)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--glob", default="*.pt")
    p.add_argument("--run", required=True, choices=RUNS)
    p.add_argument("--iters", type=int, default=1)
    p.add_argument("--warmup", type=int, default=1,
                   help="extra timed calls on the first file, to warm the kernels and allocator")
    p.add_argument("--stats-out", default=None)
    args = p.parse_args(argv)

    mc, params = build_model(args)
    engine, ec = build_engine(mc, args)
    kind, mode = args.run.split("_")
    weight_fn = weight_fn_from_args(args)

    files = sorted(glob.glob(os.path.join(args.data_dir, args.glob)))
    if not files:
        sys.exit(f"no files match {args.data_dir}/{args.glob}")

    total_tokens = 0
    total_time = 0.0
    for idx, f in enumerate(files):
        seqs = load_sequences(f)
        if not seqs:
            # a data-parallel partition may leave a bin empty: a 0-time device
            print(f"# skip empty {f}", file=sys.stderr)
            continue
        attachs = [{"w_logprobs": args.w_logprobs, "w_entropy": args.w_entropy} for _ in seqs]
        trie = prepare_trie(seqs, attachs, args, mode)
        if kind == "tree":
            packed = flatten_trie(trie, weight_fn=weight_fn)
        else:
            packed = pack_sequences_dense(seqs, attachs, pad_multiple=ec.pad_multiple, weight_fn=weight_fn)
        batch = engine.prepare(packed)
        n_dense = sum(len(s) for s in seqs)

        iters = args.iters + (args.warmup if idx == 0 else 0)
        if mode == "backward":
            (loss, _, _), dt = timed_call(engine.loss_and_grad, params, batch, iters=iters,
                                          device=engine.device)
            loss_val = float(loss)
        else:
            _, dt = timed_call(engine.forward, params, batch, iters=iters, device=engine.device)
            loss_val = None

        rec = {
            "file": os.path.basename(f),
            "run": args.run,
            "model": args.model,
            "time": dt,
            "loss": loss_val,
            "n_sequences": len(seqs),
            "n_tokens": n_dense,
            "n_padded": batch.n_padded,
            "block_size": ec.block_q,
            **trie_stats(trie.lens, trie.lcp_lens, mode=mode, block_size=ec.block_q),
            "ts": time.time(),
        }
        append_stats(args.stats_out, rec)
        print(json.dumps(rec))
        total_tokens += n_dense
        total_time += dt

    print(json.dumps({
        "aggregate": True,
        "run": args.run,
        "files": len(files),
        "total_tokens": total_tokens,
        "total_time": total_time,
        "tokens_per_s": total_tokens / total_time,
    }))


if __name__ == "__main__":
    main()
