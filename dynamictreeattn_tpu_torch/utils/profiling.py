"""Spans and counters at the port's layer boundaries; device memory statistics.

Counterpart of ``dynamictreeattn_tpu/utils/profiling.py`` (whose
``device_memory_stats`` this module keeps):

* ``span(name)`` — a host span. In a ``torch.profiler`` trace it is a host
  event named `name`, on the profiler's own clock, nested in the spans and
  ops around it. It is a function-scope record (``_RecordFunctionFast``),
  which the profiler keeps off the device's timeline, where
  ``record_function``'s user scope would get a ``gpu_user_annotation`` copy
  there. While a ``Parts`` collects (``collect``), the span's host ms are
  added to the part `name`.
* ``device_region(name, fn, x)`` — ``fn(x)``; while a ``Parts`` collects
  on a card, the region's device time is added to the part `name`: CUDA
  events around it in the forward and in a checkpoint's recompute, and
  around its backward (identity marks at its input and output).
* ``counter()`` — the collecting ``Parts`` where a training forward's count
  belongs (``Parts.count``), else None: nothing collects, gradients are off
  (an inference forward, or 1F1B's forward that keeps no graph and runs
  again to recompute), the caller runs inside a backward (a checkpoint's
  recompute counts nothing again), or a CUDA graph is being captured.
* ``device_memory_stats(device)`` — live, peak and total device memory of a
  CUDA device from ``torch.cuda.memory_stats``; ``{}`` for the CPU.

With nothing collecting, a span is one record-function call (~0.2 us) and
nothing else runs: no CUDA event, no counter op, no autograd node. One
``Parts`` collects at a time, for the whole process (``Trainer.time_parts``
installs it); autograd's threads add to it under its lock.
"""

from __future__ import annotations

import threading
import time

import torch

__all__ = ["Parts", "collect", "collecting", "counter", "device_memory_stats", "device_region", "span"]

_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


class Parts:
    """What the spans, regions and counters record while this collects:
    host ms by span name, device intervals (pairs of CUDA events, when
    `device_events`) by region name, and counters (0-d tensors) by name."""

    def __init__(self, device_events: bool):
        self.device_events = device_events
        self._lock = threading.Lock()
        self._host: dict[str, float] = {}
        self._intervals: list = []  # (name, start event, end event)
        self._open: dict = {}  # a region's backward under way: key -> its start event
        self._counts: dict[str, torch.Tensor] = {}

    def add_host(self, name: str, ms: float) -> None:
        with self._lock:
            self._host[name] = self._host.get(name, 0.0) + ms

    def count(self, name: str, value: torch.Tensor) -> None:
        """Adds `value` (a 0-d tensor on the step's device) to the counter."""
        with self._lock:
            prev = self._counts.get(name)
            self._counts[name] = value if prev is None else prev + value

    @staticmethod
    def _event() -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add_interval(self, name: str, start: torch.cuda.Event) -> None:
        """Closes a device interval of part `name` opened by `start` now."""
        end = self._event()
        with self._lock:
            self._intervals.append((name, start, end))

    def backward_event(self, name: str, key, opens: bool) -> None:
        """A region's backward reached its output (`opens`) or its input."""
        ev = self._event()
        with self._lock:
            if opens:
                self._open[key] = ev
            elif key in self._open:
                self._intervals.append((name, self._open.pop(key), ev))

    def take_counts(self) -> dict[str, torch.Tensor]:
        """The counters since the last call, which start again from none."""
        with self._lock:
            out, self._counts = self._counts, {}
        return out

    def take(self) -> dict[str, float]:
        """{part: ms} since the last call: the host spans' ms and the device
        regions' (their events must be complete: call it after a host read
        that follows them). Collection starts again from nothing."""
        with self._lock:
            out, intervals = self._host, self._intervals
            self._host, self._intervals, self._open = {}, [], {}
        for name, start, end in intervals:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


# the spans sit deep in the model's and the engine's calls, which pass no
# collector: the one that collects is the process's
_PARTS: Parts | None = None


def collect(parts: Parts | None) -> None:
    """Makes `parts` the process's collector (None: nothing collects)."""
    global _PARTS
    _PARTS = parts


def collecting() -> Parts | None:
    return _PARTS


class _Timed:
    """A span while a Parts collects: the record plus its host ms."""

    __slots__ = ("name", "parts", "record", "t0")

    def __init__(self, name: str, parts: Parts):
        self.name, self.parts, self.record = name, parts, _RecordFunctionFast(name)

    def __enter__(self):
        self.record.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.parts.add_host(self.name, (time.perf_counter() - self.t0) * 1e3)
        self.record.__exit__(*exc)
        return False


def span(name: str):
    """A host span named `name` (module docstring): ``with span(name): ...``."""
    parts = _PARTS
    return _RecordFunctionFast(name) if parts is None else _Timed(name, parts)


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def counter() -> Parts | None:
    """The collecting Parts where a training forward's count belongs, or
    None (module docstring)."""
    parts = _PARTS
    if (parts is None or not torch.is_grad_enabled() or torch._C._current_graph_task_id() != -1
            or _capturing()):
        return None
    return parts


class _Mark(torch.autograd.Function):
    """Identity whose backward records a CUDA event of a region's backward:
    at the region's output (`anchor` given) the interval opens, at its
    input it closes. The output's mark saves the region's input as its
    anchor: under checkpointing, unpacking it runs the layer's pending
    recompute first, so the recompute, timed as a forward, stays out of
    the backward's interval."""

    @staticmethod
    def forward(ctx, x, anchor, parts, name, key):
        ctx.parts, ctx.name, ctx.key, ctx.opens = parts, name, key, anchor is not None
        if anchor is not None:
            ctx.save_for_backward(anchor)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors  # noqa: B018 (a checkpoint's pending recompute runs here)
        ctx.parts.backward_event(ctx.name, ctx.key, ctx.opens)
        return g, None, None, None, None


def device_region(name: str, fn, x: torch.Tensor):
    """``fn(x)``, whose device time goes to part `name` while a Parts
    collects on a card (module docstring). `fn` returns a tensor or a tuple
    whose first item is the region's output; the backward's interval runs
    from that output's gradient to `x`'s."""
    parts = _PARTS
    if parts is None or not parts.device_events or _capturing():
        return fn(x)
    key = object()
    grad = torch.is_grad_enabled() and x.requires_grad
    if grad:
        x = _Mark.apply(x, None, parts, name, key)
    start = Parts._event()
    try:
        out = fn(x)
    finally:
        parts.add_interval(name, start)
    if not grad:
        return out
    if isinstance(out, tuple):
        return (_Mark.apply(out[0], x, parts, name, key), *out[1:])
    return _Mark.apply(out, x, parts, name, key)


def device_memory_stats(device=None) -> dict:
    """{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} of a CUDA device
    (default: the current one); {} for a CPU device."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current"),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }
