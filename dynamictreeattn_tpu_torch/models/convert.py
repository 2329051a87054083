"""Parameters from numpy: load a JAX-layout parameter dict into the port.

The port keeps the JAX package's parameter layout (``x @ W`` with W
[in, out], per-layer weights stacked [L, ...], tied LM head = embedding), so
conversion is a leaf-by-leaf copy of the same values and shapes (a MoE
model's router and [L, E, ...] expert leaves included). A dict of
numpy arrays, such as ``jax.tree.map(np.asarray, params)``, becomes the same
dict of torch tensors on `device`. One leaf changes its strides, not its
values: an untied ``lm_head`` [d, V] becomes a view of [V, d] storage, the
layout the LM-stats kernel reads.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def _tensor(a, device, dtype) -> torch.Tensor:
    # a writable C-order copy: arrays exported by JAX are read-only
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, device="cuda", dtype: torch.dtype | None = None):
    """Nested dict of arrays -> the same nested dict of tensors on `device`
    (cast to `dtype` when given, else keeping each array's own dtype)."""
    if isinstance(tree, dict):
        return {k: _tensor(np.asarray(v).T, device, dtype).t() if k == "lm_head"
                else params_from_numpy(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)
