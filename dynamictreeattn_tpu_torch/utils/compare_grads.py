"""Gradient parity comparison — the system's correctness oracle.

Counterpart of ``dynamictreeattn_tpu/utils/compare_grads.py``: per-parameter
relative gradient deviation ``‖g_exp − g_base‖ / ‖g_base‖``, sorted
descending. Grads are nested dicts of tensors with the parameters' layout;
the norms are taken in float64 on the tensors' own device.
"""

from __future__ import annotations

import torch

__all__ = ["compare_grads", "format_grad_table", "named_leaves"]


def named_leaves(tree, prefix=""):
    """(path, tensor) of each leaf of a nested dict, the path written as the
    JAX package's keystr writes it (``['layers']['wq']``)."""
    for key, val in tree.items():
        name = f"{prefix}['{key}']"
        if isinstance(val, dict):
            yield from named_leaves(val, name)
        else:
            yield name, val


def compare_grads(base_grads, exp_grads) -> list[tuple[str, float, float]]:
    """[(param_path, rel_err, base_norm)], sorted by rel_err descending.

    Leaves with a stacked leading layer axis are split per layer so the table
    resolution matches the reference's per-parameter dump. Paths are written
    as the JAX package writes them (``['layers']['wq'][3]``)."""
    base, exp = list(named_leaves(base_grads)), list(named_leaves(exp_grads))
    if [name for name, _ in base] != [name for name, _ in exp]:
        raise ValueError("the two gradient trees differ in structure")
    rows = []
    for (name, gb), (_, ge) in zip(base, exp):
        if gb.ndim >= 2 and "layers" in name:
            rows += [_row(f"{name}[{i}]", gb[i], ge[i]) for i in range(gb.shape[0])]
        else:
            rows.append(_row(name, gb, ge))
    rows.sort(key=lambda r: -r[1])
    return rows


def _row(name, gb, ge):
    gb = gb.detach().double()
    nb = float(torch.linalg.vector_norm(gb))
    diff = float(torch.linalg.vector_norm(ge.detach().double().to(gb.device) - gb))
    rel = diff / nb if nb > 0 else (0.0 if diff == 0 else float("inf"))
    return (name, rel, nb)


def format_grad_table(rows, top: int | None = None) -> str:
    """The rows of ``compare_grads`` as the JAX package prints them."""
    out = [f"{'param':60s} {'rel_err':>12s} {'base_norm':>12s}"]
    out += [f"{name:60s} {rel:12.4e} {nb:12.4e}" for name, rel, nb in rows[:top]]
    return "\n".join(out)
