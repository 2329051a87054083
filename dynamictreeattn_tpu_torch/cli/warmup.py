"""warmup — build every CUDA kernel and load each instantiation a model uses.

Counterpart of ``dynamictreeattn_tpu/cli/warmup.py``. The JAX CLI fills the
persistent compile cache with one AOT compile per shape bucket. The port
compiles nothing per shape: its kernels are built once per source by nvcc
(``ops/_build.py``) and take any length. So this warmup does what a fresh
card needs before its first step:

1. builds every ``csrc/`` source not built yet, all nvcc processes at once;
2. loads each kernel instantiation the model's (head_dim, group, hidden
   size, vocabulary) use, by running a one-layer cut of the model at its
   full width (random weights from ``--seed``) on a small synthetic trie:
   the forward, a training step in each backward mode ("cached", "fused",
   "split") and a two-token grouped decode;
3. prints one JSON line: the seconds of each part, the instantiations, and
   the launches of each kernel during the load. An instantiation that did
   not launch raises.

It runs on a card only: without nvcc or a CUDA device it raises and never
reports success. ``--tp`` loads the instantiations of one rank's head and
vocabulary shard; ``--fwd-only`` only the forward's and the sampler's.
JAX's ``--max-len``, ``--min-len`` and ``--widths`` (shape buckets) and
``--dp``, ``--fsdp`` and ``--opt`` (the sharded step's compile) are
accepted and change nothing here.

Example:
    python -m dynamictreeattn_tpu_torch.cli.warmup --model qwen3-0.6b
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from dynamictreeattn_tpu_torch.cli.common import DTYPES, add_engine_args, add_model_args

__all__ = ["instantiations", "main", "parser"]

NO_EFFECT = "accepted for the JAX command line; changes nothing here (the port compiles nothing per shape)"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    add_engine_args(p)
    p.add_argument("--max-len", type=int, default=16384, help=NO_EFFECT)
    p.add_argument("--min-len", type=int, default=0, help=NO_EFFECT)
    p.add_argument("--widths", default="square", help=NO_EFFECT)
    p.add_argument("--fwd-only", action="store_true",
                   help="load only the forward's and the sampler's instantiations")
    p.add_argument("--dp", type=int, default=0, help=NO_EFFECT)
    p.add_argument("--tp", type=int, default=1, help="load the instantiations of one rank's tp-way shard")
    p.add_argument("--fsdp", action="store_true", help=NO_EFFECT)
    p.add_argument("--opt", action="store_true", help=NO_EFFECT)
    return p


def _rank_config(mc, tp: int):
    """One rank's config at tp: its heads and vocabulary shard, one layer."""
    from dynamictreeattn_tpu_torch.parallel.tp_model import local_config, tp_param_shard_info

    tp_param_shard_info(mc, tp)
    return dataclasses.replace(local_config(mc, tp), vocab_size=mc.vocab_size // tp, num_hidden_layers=1)


def instantiations(mc, tp: int = 1, fwd_only: bool = False) -> list[dict]:
    """The kernel instantiations a step of `mc` at `tp` uses: each a
    {"kernels": the launch names that reach it, "shape": ...} (the forward
    and the sampler's only with `fwd_only`)."""
    c = _rank_config(mc, tp)
    dh, hq, hkv = c.head_dim, c.num_attention_heads, c.num_key_value_heads
    attn = {"head_dim": dh, "group": hq // hkv, "kv_heads": hkv}
    qk = {"head_dim": dh, "q_heads": hq, "kv_heads": hkv, "qk_norm": bool(c.use_qk_norm)}
    lm = {"hidden": c.hidden_size, "vocab": c.vocab_size, "tied": bool(c.tie_word_embeddings)}
    out = [("tree_attn_fwd (K1 bound / K2 online)", ("tree_attn_fwd_bound", "tree_attn_fwd_online"), attn),
           ("qk_prep_fwd (K4 q, K5 k/v)", ("qk_prep_fwd_q", "qk_prep_fwd_kv"), qk),
           ("lm_stats_fwd (K8)", ("lm_stats_fwd",), lm),
           ("decode_attn (K13)", ("decode_attn",), attn)]
    if not fwd_only:
        out += [("tree_attn_bwd_kmajor (K3 cached / K10 fused)", ("tree_attn_bwd_cached", "tree_attn_bwd_fused"),
                 attn),
                ("tree_attn_bwd_kmajor (K12 dk/dv)", ("tree_attn_bwd_dkv",), attn),
                ("tree_attn_bwd (K11 dq)", ("tree_attn_bwd_dq",), attn),
                ("qk_prep_bwd (K6 q, K7 k/v)", ("qk_prep_bwd_q", "qk_prep_bwd_kv"), qk),
                ("lm_stats_bwd (K9)", ("lm_stats_bwd",), lm)]
    return [{"name": name, "kernels": list(kernels), "shape": shape} for name, kernels, shape in out]


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from dynamictreeattn_tpu_torch.cli.common import build_engine
    from dynamictreeattn_tpu_torch.data import synthetic_rollout_batch
    from dynamictreeattn_tpu_torch.engine import TreeEngine
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, generate_grouped, init_params
    from dynamictreeattn_tpu_torch.ops import _build
    from dynamictreeattn_tpu_torch.tries import TokenTrie

    dev = torch.device(args.device)
    if dev.type != "cuda":
        raise ValueError(f"warmup builds and loads the CUDA kernels: --device {args.device} is not a card")
    mc = MODEL_CONFIGS[args.model]
    wanted = instantiations(mc, args.tp, args.fwd_only)
    t_run = t0 = time.perf_counter()
    built = _build.build()  # raises without nvcc
    build_s = time.perf_counter() - t0
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernels were built but cannot be loaded")

    t0 = time.perf_counter()
    cut = _rank_config(mc, args.tp)
    params = init_params(cut, torch.Generator(device=dev).manual_seed(args.seed), DTYPES[args.dtype])
    seqs, attachs = synthetic_rollout_batch(seed=args.seed, n_prompts=1, samples_per_prompt=4,
                                            prompt_len=(192, 256), completion_len=(32, 64),
                                            vocab_size=cut.vocab_size)
    trie = TokenTrie(seqs, attachs)
    _, ec = build_engine(cut, args)
    _build.reset_launches()
    engine = TreeEngine(cut, ec, device=dev)
    engine.logprobs(params, engine.prepare(trie))
    if not args.fwd_only:
        for mode in ("cached", "fused", "split"):
            eng = TreeEngine(cut, dataclasses.replace(ec, bwd_mode=mode), device=dev)
            eng.loss_and_grad(params, eng.prepare(trie))
    prompt = np.asarray(seqs[0][:64], np.int32)[None]
    generate_grouped(params, cut, prompt, np.array([64], np.int32), group=2, max_new=2,
                     generator=torch.Generator(device=dev).manual_seed(args.seed))
    torch.cuda.synchronize()
    counts = _build.launches()
    load_s = time.perf_counter() - t0
    missing = [w["name"] for w in wanted if not any(counts.get(k) for k in w["kernels"])]
    if missing:
        raise RuntimeError(f"warmup: these instantiations did not launch: {missing} (launches {counts})")
    out = {"model": args.model, "tp": args.tp, "fwd_only": args.fwd_only, "build_s": build_s,
           "sources_built": sorted(built), "load_s": load_s, "seconds": time.perf_counter() - t_run,
           "instantiations": wanted, "launches": {k: v for k, v in counts.items() if v}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
