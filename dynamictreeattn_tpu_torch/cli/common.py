"""Shared CLI plumbing: model and engine construction, timing, stats, grad IO.

Counterpart of ``dynamictreeattn_tpu/cli/common.py`` with the JAX flags, so
that its command lines run unchanged. Differences:

* ``--device`` (default ``cuda``) places the weights and the engine; the
  weights are random from ``--seed`` through a ``torch.Generator`` on that
  device, so they are not the JAX package's values;
* ``--block-q`` / ``--block-kv`` default to the port's ``EngineConfig``
  block sizes (the JAX 512 is a TPU tuning);
* ``--attn-backend pallas`` means the port's ``"kernel"`` backend;
* ``--bwd-mode`` picks the tree-attention backward (the JAX command lines
  take its default, ``auto``);
* ``--ckpt DIR`` loads HF safetensors weights through
  ``models/hf_compat.py`` ``load_hf_checkpoint`` (in ``--dtype`` on
  ``--device``) in place of the random ones. ``--remat-policy``,
  ``--remat-segments`` and ``--loss-chunk`` reach ``EngineConfig`` as in the
  JAX package (``--loss-chunk`` is read by loss mode ``"rows"`` only).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from dynamictreeattn_tpu_torch.engine import EngineConfig, TreeEngine
from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS, init_params
from dynamictreeattn_tpu_torch.models.hf_compat import load_hf_checkpoint
from dynamictreeattn_tpu_torch.tries import TokenTrie
from dynamictreeattn_tpu_torch.utils.compare_grads import named_leaves

__all__ = [
    "add_model_args",
    "add_engine_args",
    "build_model",
    "build_engine",
    "prepare_trie",
    "timed_call",
    "append_stats",
    "save_grads_npz",
    "load_grads_npz",
    "weight_fn_from_args",
]

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default="qwen3-0.6b",
                   help="model preset name (see models.MODEL_CONFIGS)")
    p.add_argument("--dtype", default="bf16", choices=list(DTYPES))
    p.add_argument("--ckpt", default=None,
                   help="HF safetensors checkpoint dir (default: random weights from --seed)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device of the weights and the engine")


def add_engine_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--block-q", type=int, default=EngineConfig.block_q)
    p.add_argument("--block-kv", type=int, default=EngineConfig.block_kv)
    p.add_argument("--attn-backend", default="kernel", choices=["kernel", "pallas", "reference"],
                   help="kernel (pallas is a synonym): the CUDA kernels on the card, their plain "
                        "versions on the CPU; reference: the dense-mask attention oracle")
    p.add_argument("--no-remat", action="store_true",
                   help="disable activation rematerialization (per-layer recompute)")
    p.add_argument("--remat-policy", default=None, choices=["dots", "attn", "attn_dots"],
                   help="what each remat'd layer keeps: the projection products (dots), the "
                        "tree attention's o and lse (attn: its forward kernel runs once a step), "
                        "or both; default: the layer input only")
    p.add_argument("--remat-segments", type=int, default=0,
                   help="nested checkpointing over this many layer segments (must divide the "
                        "layer count; 0 = off)")
    p.add_argument("--loss-chunk", type=int, default=1024,
                   help="row-chunk size of loss mode 'rows'")
    p.add_argument("--bwd-mode", default="auto", choices=["auto", "cached", "fused", "split"],
                   help="tree-attention backward: auto (= cached, K3), fused (K10) or split "
                        "(K11 + K12, bit-reproducible on the card)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--w-logprobs", type=float, default=-1.0)
    p.add_argument("--w-entropy", type=float, default=0.1)
    p.add_argument("--leafization", dest="leafization", action="store_true", default=True)
    p.add_argument("--no-leafization", dest="leafization", action="store_false")
    p.add_argument("--permute", default="ours", choices=["ours", "idx", "random"],
                   help="DFS leaf order policy")


def build_model(args):
    """(model config, params) on --device in --dtype: the HF checkpoint of
    --ckpt, else random weights from --seed."""
    mc = MODEL_CONFIGS[args.model]
    if args.ckpt:
        return mc, load_hf_checkpoint(args.ckpt, mc, DTYPES[args.dtype], args.device)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    return mc, init_params(mc, gen, dtype=DTYPES[args.dtype])


def build_engine(mc, args):
    ec = EngineConfig(
        block_q=args.block_q,
        block_kv=args.block_kv,
        remat=not args.no_remat,
        remat_policy=args.remat_policy,
        remat_segments=args.remat_segments,
        temperature=args.temperature,
        loss_chunk=args.loss_chunk,
        bwd_mode=args.bwd_mode,
        attn_backend="kernel" if args.attn_backend == "pallas" else args.attn_backend,
    )
    return TreeEngine(mc, ec, device=args.device), ec


def weight_fn_from_args(args):
    w_lp, w_ent = args.w_logprobs, args.w_entropy

    def weight_fn(attachment: dict, length: int):
        return (
            float(attachment.get("w_logprobs", w_lp)),
            float(attachment.get("w_entropy", w_ent)),
        )

    return weight_fn


def prepare_trie(seqs, attachs, args, mode: str):
    """TokenTrie with the requested permute policy applied."""
    trie = TokenTrie(seqs, attachs, leafization=args.leafization)
    if args.permute == "ours":
        if mode == "backward":
            trie.backward_permute()
        else:
            trie.forward_permute()
    elif args.permute == "random":
        trie.random_permute(seed=args.seed)
    return trie


def timed_call(fn, *args, iters: int = 3, device="cpu"):
    """(last output, median seconds) of fn(*args) over `iters` calls after
    one warm-up call; on a CUDA `device` each call ends in
    ``torch.cuda.synchronize``."""
    device = torch.device(device)

    def call():
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    out = call()
    ts = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        out = call()
        ts.append(time.perf_counter() - t0)
    return out, float(np.median(ts))


def append_stats(path: str | None, record: dict) -> None:
    if not path:
        return
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def save_grads_npz(path: str, grads) -> None:
    """fp32 arrays keyed as the JAX package keys them (``['layers']['wq']``)."""
    np.savez(path, **{name: g.detach().float().cpu().numpy() for name, g in named_leaves(grads)})


def load_grads_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
