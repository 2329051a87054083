"""device_idle_share.<kind>: percent of a unit's wall time in which no
operation ran on the device. The busy time is the union of the device
operations' intervals in the traced units; the wall time is the median of
the untraced units of the same work, since the profiler's host cost
stretches a traced unit (``harness.Run.idle_share``). Serves
``device_idle_share.train`` and ``device_idle_share.rollout``."""


def read(run):
    return run.idle_share()
