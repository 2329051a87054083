"""Single-run CLI: one forward or training step, tree or dense, one JSON record.

Counterpart of ``dynamictreeattn_tpu/cli/run.py``; its records have the same
keys. On the card:

    python -m dynamictreeattn_tpu_torch.cli.run --model qwen3-0.6b \\
        --data synthetic:n_prompts=2,samples=8 --run tree_backward
    python -m dynamictreeattn_tpu_torch.cli.run --run dense_backward \\
        --data data/synthetic-tau2/call0.npz --iters 1 --grad-out dense.npz
    # grad parity: run tree_backward and dense_backward with --grad-out,
    # then cli.compare_grads

On the CPU add ``--device cpu`` (e.g. ``--model qwen3-tiny --dtype fp32
--attn-backend reference --block-q 32 --block-kv 32``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from dynamictreeattn_tpu_torch.cli.common import (
    add_engine_args,
    add_model_args,
    append_stats,
    build_engine,
    build_model,
    prepare_trie,
    save_grads_npz,
    timed_call,
    weight_fn_from_args,
)
from dynamictreeattn_tpu_torch.data.io import parse_data_spec
from dynamictreeattn_tpu_torch.engine import pack_sequences_dense
from dynamictreeattn_tpu_torch.tries import flatten_trie, trie_stats
from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves
from dynamictreeattn_tpu_torch.utils.profiling import device_memory_stats

RUNS = ["tree_forward", "tree_backward", "dense_forward", "dense_backward"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_model_args(p)
    add_engine_args(p)
    p.add_argument("--data", required=True, help="path (.pt/.npz) or synthetic: spec")
    p.add_argument("--run", required=True, choices=RUNS)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--grad-out", default=None, help="save grads (.npz)")
    p.add_argument("--logprobs-out", default=None,
                   help="save per-sequence logprobs from forward runs (.npz)")
    p.add_argument("--stats-out", default=None, help="append stats JSONL")
    args = p.parse_args(argv)

    mc, params = build_model(args)
    engine, ec = build_engine(mc, args)
    seqs, attachs = parse_data_spec(args.data, mc.vocab_size)
    for a in attachs:
        a.setdefault("w_logprobs", args.w_logprobs)
        a.setdefault("w_entropy", args.w_entropy)

    kind, mode = args.run.split("_")
    trie = prepare_trie(seqs, attachs, args, mode)
    weight_fn = weight_fn_from_args(args)
    if kind == "tree":
        packed = flatten_trie(trie, weight_fn=weight_fn)
        stats = trie_stats(trie.lens, trie.lcp_lens, mode=mode, block_size=ec.block_q)
    else:
        packed = pack_sequences_dense(seqs, attachs, pad_multiple=ec.pad_multiple, weight_fn=weight_fn)
        stats = trie_stats(np.array([len(s) for s in seqs]), np.zeros(len(seqs) - 1, dtype=np.int64),
                           mode=mode, block_size=ec.block_q)
    batch = engine.prepare(packed)

    n_dense = sum(len(s) for s in seqs)
    record = {
        "run": args.run,
        "model": args.model,
        "dtype": args.dtype,
        "attn_backend": args.attn_backend,
        "permute": args.permute,
        "n_sequences": len(seqs),
        "n_tokens": n_dense,
        "n_padded": batch.n_padded,
        "block_size": ec.block_q,
        **stats,
    }

    if mode == "backward":
        (loss, grads, aux), dt = timed_call(engine.loss_and_grad, params, batch, iters=args.iters,
                                            device=engine.device)
        record.update(loss=float(loss), sum_logprob=float(aux["sum_logprob"]),
                      sum_entropy=float(aux["sum_entropy"]))
        if args.grad_out:
            save_grads_npz(args.grad_out, grads)
            print(f"saved grads -> {args.grad_out}", file=sys.stderr)
        else:
            record["grad_norm"] = sum(float(g.float().square().sum())
                                      for _, g in named_leaves(grads)) ** 0.5
    else:
        lp, dt = timed_call(engine.forward, params, batch, iters=args.iters, device=engine.device)
        record["sum_logprobs"] = float(sum(float(v.sum()) for v in lp.values()))
        if args.logprobs_out:
            np.savez(args.logprobs_out, **{str(k): v for k, v in lp.items()})
            print(f"saved logprobs -> {args.logprobs_out}", file=sys.stderr)

    record["time"] = dt
    record["tokens_per_s"] = n_dense / dt
    # the peak is torch.cuda.max_memory_allocated's; no key on the CPU
    mem = device_memory_stats(engine.device)
    if mem.get("peak_bytes_in_use"):
        record["peak_mem_gb"] = round(mem["peak_bytes_in_use"] / 2**30, 3)
    print(json.dumps(record))
    record["ts"] = time.time()
    append_stats(args.stats_out, record)


if __name__ == "__main__":
    main()
