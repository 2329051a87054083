"""Learned linear cost model of tree-engine execution time.

Counterpart of ``dynamictreeattn_tpu/parallel/time_model.py`` (host numpy and
scipy, the same arithmetic): time ≈ c · features with non-negative
coefficients (NNLS), refitted online from stats records over a window of the
most recent 1024 points once there are 16; before the first fit the
prediction is ``n_tree_tokens``. The load balancers bin tries by predicted
time, not token count.
"""

from __future__ import annotations

import numpy as np

# imported at module load, not inside fit(): a lazy import would land in
# the training stream at the step whose record makes the first refit
from scipy.optimize import nnls

__all__ = ["TreeTimeModel", "FEATURES"]

FEATURES = (
    "n_leaf_sequences",
    "n_tree_tokens",
    "n_f1_tokens",
    "sum_prefix_len",
    "sum_depth",
)


class TreeTimeModel:
    def __init__(self, window: int = 1024, min_points: int = 16, features=FEATURES):
        self.window = window
        self.min_points = min_points
        self.features = tuple(features)
        self._X: list[list[float]] = []
        self._y: list[float] = []
        self.coef: np.ndarray | None = None

    def _vec(self, stats: dict) -> list[float]:
        return [float(stats[f]) for f in self.features]

    def add_data(self, stats_list) -> None:
        """Add {feature..., "time"} records; refit if enough points."""
        if isinstance(stats_list, dict):
            stats_list = [stats_list]
        for s in stats_list:
            self._X.append(self._vec(s))
            self._y.append(float(s["time"]))
        self._X = self._X[-self.window :]
        self._y = self._y[-self.window :]
        if len(self._y) >= self.min_points:
            self.fit()

    def fit(self) -> None:
        X = np.asarray(self._X, dtype=np.float64)
        y = np.asarray(self._y, dtype=np.float64)
        self.coef, _ = nnls(X, y)

    def pred(self, stats: dict) -> float:
        if self.coef is None:
            return float(stats["n_tree_tokens"])  # cold-start proxy
        return float(np.dot(self.coef, self._vec(stats)))

    def avg_rel_error(self) -> float:
        if self.coef is None or not self._y:
            return float("nan")
        X = np.asarray(self._X)
        y = np.asarray(self._y)
        pred = X @ self.coef
        return float(np.mean(np.abs(pred - y) / np.maximum(np.abs(y), 1e-12)))
