"""Profiling and timing helpers.

Counterpart of ``dynamictreeattn_tpu/utils/profiling.py``:

* ``trace(dir)`` — a ``torch.profiler`` trace of the host and, on a card,
  the device, written as a Chrome trace under `dir`;
* ``device_memory_stats(device)`` — live, peak and total device memory of a
  CUDA device from ``torch.cuda.memory_stats``; ``{}`` for the CPU;
* ``StepTimer`` — wall-clock statistics of steps whose ends the caller
  synchronises.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["trace", "device_memory_stats", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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


class StepTimer:
    """Collects per-step wall times; the body of each ``step()`` must end in
    a synchronisation (e.g. ``torch.cuda.synchronize()``) so that the time
    covers the device's work."""

    def __init__(self):
        self.times: list[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    def stats(self) -> dict:
        a = np.asarray(self.times)
        if not len(a):
            return {}
        return {
            "n": len(a),
            "median_s": float(np.median(a)),
            "mean_s": float(a.mean()),
            "p90_s": float(np.percentile(a, 90)),
            "total_s": float(a.sum()),
        }
