"""mfu.rollout: percent of the rollout's roofline reached: the least time
each rollout could take at the H100's published peaks, prefills and decode
steps each bound by operations or by bytes (``work.rollout_bound_s``: the
weights once a pass plus the K/V it must read), over its wall time, summed
over the untraced rollouts of a traced run's window."""

from work import rollout_bound_s


def read(run):
    units = run.untraced()
    wall = sum(u["wall_s"] for u in units)
    if not wall:
        return None
    return 100.0 * sum(rollout_bound_s(run.cfg, u["plens"], u["group"], u["max_new"]) for u in units) / wall
