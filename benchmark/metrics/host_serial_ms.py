"""host_serial_ms: host ms between two training steps, from the step
before's one host read returning to this step's first launch, while the
device has nothing queued (part "host_serial" of ``Trainer.time_parts``,
on the Trainer's clock). Its parts are spans: "step.record" of the step
before, this step's "prepare.*". The mean over the untraced steps whose
step before was untraced too (the step after a traced one carries the
profiler's export); None where the program keeps no such part."""


def read(run):
    xs = [u["parts_ms"]["host_serial"] for before, u in zip(run.units, run.units[1:])
          if not before.get("traced") and not u.get("traced") and "host_serial" in u.get("parts_ms", {})]
    return sum(xs) / len(xs) if xs else None
