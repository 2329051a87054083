"""Training-loop CLI: RL-style trie training with checkpointing.

Counterpart of ``dynamictreeattn_tpu/cli/train.py`` with its flags: rollout
stream → cost-model-balanced packing → the tree step → the optimizer →
checkpoints (torch.save). ``--dp``, ``--tp`` and ``--ep`` run dp × tp ranks,
one process each (``parallel.make_mesh``): under ``torchrun`` (``RANK``
set) the process joins the launcher's group; with no launcher it starts
the dp·tp processes itself (``torch.multiprocessing``, spawn). Only global
rank 0 prints the per-step JSON lines and writes ``--stats-out`` and the
checkpoints. ``--dist-backend`` (a flag the JAX CLI lacks: it has no
backend) picks nccl or gloo; ranks that share a card need gloo, the CPU
takes gloo only. ``--sp``, ``--pp`` above 1, ``--fsdp`` and
``--multihost`` raise ``ValueError`` naming ROADMAP queue 1 item 10.
``--ckpt DIR`` starts from a HF checkpoint (``models/hf_compat.py``), else
the weights are random from ``--seed``. On the card:

    python -m dynamictreeattn_tpu_torch.cli.train --model qwen3-0.6b \\
        --data synthetic:n_prompts=2,samples=8 --steps 20 \\
        --ckpt-dir ckpt/ --ckpt-every 10
    python -m dynamictreeattn_tpu_torch.cli.train ... --ckpt-dir ckpt/ --resume --steps 5
    python -m dynamictreeattn_tpu_torch.cli.train ... --dp 2 --tp 2 --dist-backend gloo  # 4 ranks, one card

On the CPU add ``--device cpu`` (e.g. ``--model qwen3-tiny --dtype fp32
--attn-backend reference --block-q 32 --block-kv 32``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile

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
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of the ranks (default: nccl on cards of their own, gloo "
                        "on the CPU; ranks sharing a card need gloo)")
    args = p.parse_args(argv)
    import torch.distributed as dist

    world = args.dp * args.tp
    if world > 1 and "RANK" not in os.environ and not dist.is_initialized():
        return _spawn(argv, world)
    return _train(args)


def _spawn(argv, world: int) -> None:
    """Run `world` ranks of this CLI as fresh processes, rendezvousing
    through a file store in a temporary directory."""
    import torch.multiprocessing as mp

    store = tempfile.mkdtemp(prefix="cli_train_")
    try:
        mp.start_processes(_rank_main, args=(world, argv, os.path.join(store, "store")), nprocs=world,
                           start_method="spawn")
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _rank_main(rank: int, world: int, argv, store: str) -> None:
    import torch
    import torch.distributed as dist

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      CLI_TRAIN_STORE=store)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _train(args):
    import torch.distributed as dist

    from dynamictreeattn_tpu_torch.cli.common import append_stats, build_engine, build_model
    from dynamictreeattn_tpu_torch.parallel.mesh import make_mesh, pick_backend
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
    mesh = None
    if args.dp * args.tp > 1:
        if not dist.is_initialized() and "CLI_TRAIN_STORE" in os.environ:  # spawned by this CLI
            world = int(os.environ["WORLD_SIZE"])
            dist.init_process_group(pick_backend(args.dist_backend, args.device, world),
                                    store=dist.FileStore(os.environ["CLI_TRAIN_STORE"], world),
                                    rank=int(os.environ["RANK"]), world_size=world)
        mesh = make_mesh(dp=args.dp, tp=args.tp, backend=args.dist_backend, device=args.device)
        if mesh is None:  # a launcher's rank beyond the dp·tp of the mesh: nothing to train
            return None
    trainer = Trainer(mc, ec, tc, mesh=mesh, device=args.device)
    say = print if trainer.lead else (lambda *a: None)
    if args.resume and args.ckpt_dir:
        trainer.restore()
        say(f"resumed at step {trainer.step_idx}")
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
        say(json.dumps(rec))
        if trainer.lead:
            append_stats(args.stats_out, rec)
    if args.ckpt_dir:
        trainer.save()
        say(f"saved checkpoint at step {trainer.step_idx}")
    return trainer


if __name__ == "__main__":
    main()
