"""Training-loop CLI: RL-style trie training with checkpointing, one device.

Counterpart of ``dynamictreeattn_tpu/cli/train.py`` with its flags: rollout
stream → cost-model-balanced packing → the tree step → the optimizer →
checkpoints (torch.save). Multi-device flags (``--dp``, ``--tp``, ``--sp``,
``--pp`` above 1, ``--fsdp``, ``--ep``, ``--multihost``) raise
``ValueError`` naming ROADMAP queue 1 item 10. ``--ckpt DIR`` starts
from a HF checkpoint (``models/hf_compat.py``), else the weights are random
from ``--seed``. On the card:

    python -m dynamictreeattn_tpu_torch.cli.train --model qwen3-0.6b \\
        --data synthetic:n_prompts=2,samples=8 --steps 20 \\
        --ckpt-dir ckpt/ --ckpt-every 10
    python -m dynamictreeattn_tpu_torch.cli.train ... --ckpt-dir ckpt/ --resume --steps 5

On the CPU add ``--device cpu`` (e.g. ``--model qwen3-tiny --dtype fp32
--attn-backend reference --block-q 32 --block-kv 32``).
"""

from __future__ import annotations

import argparse
import json

from dynamictreeattn_tpu_torch.cli.common import add_engine_args, add_model_args


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(p)
    add_engine_args(p)
    p.add_argument("--data", required=True,
                   help="path or synthetic: spec; re-sampled per step for synthetic")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1, help="sequence parallelism over the seq axis")
    p.add_argument("--sp-mode", default="ulysses", choices=["ulysses", "ring"])
    p.add_argument("--pp", type=int, default=1, help="pipeline stages (must divide n_layers)")
    p.add_argument("--pp-schedule", default="gpipe", choices=["gpipe", "1f1b"])
    p.add_argument("--microbatches", type=int, default=4, help="microbatches per data rank when --pp > 1")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--ep", action="store_true", help="MoE expert parallelism over the data axis")
    p.add_argument("--multihost", action="store_true", help="one process per host")
    p.add_argument("--fsdp", action="store_true", help="ZeRO-3 over the data axis")
    p.add_argument("--fsdp-min-size", type=int, default=1 << 16,
                   help="per-layer element floor below which a leaf stays replicated")
    p.add_argument("--lb-method", default="LB_by_DFS_and_TM", choices=["LB_by_DFS_and_TM", "LB_by_n_tokens"])
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--stats-out", default=None)
    args = p.parse_args(argv)

    from dynamictreeattn_tpu_torch.cli.common import append_stats, build_engine, build_model
    from dynamictreeattn_tpu_torch.data.io import parse_data_spec
    from dynamictreeattn_tpu_torch.models import MODEL_CONFIGS
    from dynamictreeattn_tpu_torch.training import TrainConfig, Trainer

    mc = MODEL_CONFIGS[args.model]
    _, ec = build_engine(mc, args)
    tc = TrainConfig(
        dp=args.dp, tp=args.tp, sp=args.sp, sp_mode=args.sp_mode, pp=args.pp,
        pp_schedule=args.pp_schedule, microbatches=args.microbatches, learning_rate=args.lr,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip, grad_accum=args.grad_accum,
        warmup_steps=args.warmup_steps, fsdp=args.fsdp, fsdp_min_size=args.fsdp_min_size, ep=args.ep,
        multihost=args.multihost, param_dtype=args.dtype, lb_method=args.lb_method,
        lb_block_size=args.block_q, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
    )
    trainer = Trainer(mc, ec, tc, device=args.device)
    if args.resume and args.ckpt_dir:
        trainer.restore()
        print(f"resumed at step {trainer.step_idx}")
    elif args.ckpt:
        trainer.set_params(build_model(args)[1])
    else:
        trainer.init(seed=args.seed)

    synthetic = args.data.startswith("synthetic:")
    for _ in range(args.steps):
        spec = args.data + (f",seed={args.seed + trainer.step_idx}" if synthetic
                            and "seed=" not in args.data else "")
        seqs, attachs = parse_data_spec(spec, mc.vocab_size)
        rec = trainer.train_step(seqs, attachs)
        print(json.dumps(rec))
        append_stats(args.stats_out, rec)
    if args.ckpt_dir:
        trainer.save()
        print(f"saved checkpoint at step {trainer.step_idx}")
    return trainer


if __name__ == "__main__":
    main()
