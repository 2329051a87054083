"""moe_block_ms: device ms of the MoE block a step (router, dispatch,
experts, combine, over every layer), from the program's CUDA events around
the block in the forward, in the remat recompute and in the backward (part
"moe" of ``Trainer.time_parts``), the mean over the untraced steps of a
traced run's window; None where the program keeps no such part."""


def read(run):
    xs = [u["parts_ms"]["moe"] for u in run.untraced() if "moe" in u.get("parts_ms", {})]
    return sum(xs) / len(xs) if xs else None
