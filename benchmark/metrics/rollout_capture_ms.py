"""rollout_capture_ms: host ms a rollout spends setting up its decode graph:
the program's "generate.capture" spans (the eager first decode step and
the CUDA graph capture, ``models/generate.py``) in the traced rollout,
read from the trace's host events, the mean over the traced rollouts. The
profiler's own host cost inside the span is included: the figure is a
traced one, above what an untraced rollout spends. None where the program
has no such span."""

SPAN = "generate.capture"


def read(run):
    per_unit = [sum(e - s for name, s, e in tr.host if name == SPAN) / 1e6 for tr in run.traces
                if any(name == SPAN for name, _, _ in tr.host)]
    return sum(per_unit) / len(per_unit) if per_unit else None
