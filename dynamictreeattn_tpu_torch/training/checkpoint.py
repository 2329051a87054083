"""Checkpoint and resume of params and optimizer state on torch.save.

Counterpart of ``dynamictreeattn_tpu/training/checkpoint.py`` (orbax there):
one file per step, ``step_<N>.pt`` under the directory, holding
{"params", "opt_state", "extra"} as ``torch.save`` writes them (storage
sharing and strides kept, so an untied head stays a view of [V, d]
storage). A save writes a temporary name and renames it over the final
one (``os.replace``), so a reader never sees half a file; the oldest steps
past `max_to_keep` are removed. Orbax checkpoints of the JAX package are
not read.
"""

from __future__ import annotations

import os
import re
from typing import Any

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, params: Any, opt_state: Any = None, extra: dict | None = None) -> None:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"params": params, "opt_state": opt_state, "extra": extra}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep] if self.max_to_keep else ():
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, map_location=None) -> dict:
        """{params, opt_state, extra} of `step` (default: the latest), its
        tensors on `map_location` (default: where they were saved)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def close(self) -> None:
        """Nothing to flush: every save has been renamed into place."""
