"""engine_ms: device ms of the engine's forward and backward, from the
Trainer's CUDA events (part "engine" of ``Trainer.time_parts``), the mean
over the untraced steps of a traced run's window."""


def read(run):
    xs = [u["parts_ms"]["engine"] for u in run.untraced() if "engine" in u.get("parts_ms", {})]
    return sum(xs) / len(xs) if xs else None
