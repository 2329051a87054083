"""mla_latent_ms: device ms of MLA's latent path a step (the q, kv_a and
kv_b projections, the latent's norm, RoPE and the heads' q / k / v, over
every layer), from the program's CUDA events around it in the forward, in
the remat recompute and in the backward (part "mla" of
``Trainer.time_parts``), the mean over the untraced steps of a traced run's
window; None where the program keeps no such part."""


def read(run):
    xs = [u["parts_ms"]["mla"] for u in run.untraced() if "mla" in u.get("parts_ms", {})]
    return sum(xs) / len(xs) if xs else None
