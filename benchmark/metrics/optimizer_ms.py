"""optimizer_ms: device ms of the clip and the AdamW update, from the
Trainer's CUDA events (parts "clip" and "adamw"), the mean over the
untraced steps of a traced run's window."""


def read(run):
    xs = [u["parts_ms"]["clip"] + u["parts_ms"]["adamw"] for u in run.untraced()
          if {"clip", "adamw"} <= set(u.get("parts_ms", {}))]
    return sum(xs) / len(xs) if xs else None
