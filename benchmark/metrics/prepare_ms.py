"""prepare_ms: host ms in ``Trainer.prepare_step`` (partition, trie build,
flatten, block metadata, work lists, upload), the mean over the untraced
steps of a traced run's window."""


def read(run):
    xs = [u["prepare_s"] for u in run.untraced() if "prepare_s" in u]
    return 1e3 * sum(xs) / len(xs) if xs else None
