"""moe_drop_share: percent of the (row, choice) pairs routed to an expert
that the program's capacity dispatch drops, from its counters "moe.pairs"
and "moe.dropped" (summed over the layers, read in each step's one host
read; ``Trainer.time_parts``): 100 x the dropped over the pairs, summed
over the untraced steps of a traced run's window; None where the program
keeps no such counter."""


def read(run):
    parts = [u["parts_ms"] for u in run.untraced() if "moe.pairs" in u.get("parts_ms", {})]
    pairs = sum(p["moe.pairs"] for p in parts)
    return 100.0 * sum(p["moe.dropped"] for p in parts) / pairs if pairs else None
