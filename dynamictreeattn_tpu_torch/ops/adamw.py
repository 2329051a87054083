"""The optimizer layer's two passes, the clip's global sum of squares and the
AdamW update: CUDA kernels + plain versions.

No counterpart among the JAX package's kernels: the JAX Trainer runs
optax's ``clip_by_global_norm`` → ``adamw`` chain, which XLA fuses on the
TPU. Eager PyTorch runs the same chain (``training.trainer.OptaxAdamW``)
as about twenty passes over memory a leaf; the kernels
(``csrc/adamw.cu``) read each element once and write it once.

* ``sum_squares_plain``: Σ g² over the leaves in fp32, each leaf's fp32 norm
  squared, summed in leaf order (the eager clip's);
* ``adamw_update_plain``: the eager chain, in place: the clip's scale
  ``g <- (g / div) * mul`` applied to the grads themselves, then each leaf
  updated in slices of at most ``CHUNK`` elements (to bound the
  temporaries), every op in the leaf's dtype, and the results kept where
  the 0-d bool ``commit`` is true;
* CUDA: one launch for the sum of squares (fp64 partials, one a CTA) and a
  one-CTA launch that sums them in a fixed order; one launch for the update,
  which applies the clip's scale to each gradient it loads and leaves the
  grads unchanged. The update repeats the eager ops one for one, each
  rounded to the leaf's dtype where the eager op rounds, so given the same
  clip factors it is bit-equal to the plain version; the sum of squares
  differs from the plain one by its order of summation only. A launch takes
  at most ``MAX_LEAVES`` leaves of one dtype (bf16 or fp32); more leaves
  take more launches (:func:`plan`).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernels or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from dynamictreeattn_tpu_torch.ops import _build

__all__ = ["CHUNK", "MAX_LEAVES", "adamw_update", "adamw_update_plain", "plan", "sum_squares",
           "sum_squares_plain"]

CHUNK = 1 << 25  # the plain version's slice of a leaf
MAX_LEAVES = 64  # the leaves one launch's parameter table holds (csrc/adamw.cu)
NT = 256  # threads a CTA
CTAS_PER_SM = 4  # the grid: SMs x this (csrc/adamw.cu __launch_bounds__)
VEC_BYTES = 16  # a vector load or store
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


# --------------------------------------------------------------------- plain


def sum_squares_plain(gs: list) -> torch.Tensor:
    """Σ g² over the leaves `gs`: a 0-d fp32 tensor."""
    return sum(torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 for g in gs)


def _slices(shape, chunk: int) -> list:
    """Index tuples cutting a tensor of `shape` along dim 0 into pieces of
    at most ~`chunk` elements (one piece for a small leaf)."""
    numel = int(np.prod(shape)) if len(shape) else 1
    if numel <= chunk or len(shape) == 0:
        return [(slice(None),)] if len(shape) else [()]
    rows = max(1, chunk // (numel // shape[0]))
    return [(slice(r, min(r + rows, shape[0])),) for r in range(0, shape[0], rows)]


def adamw_update_plain(ps: list, gs: list, mus: list, nus: list, *, lr, bc1, bc2, commit, clip=None,
                       b1: float, b2: float, eps: float, weight_decay: float) -> None:
    """The eager chain, in place on ps, mus, nus and (with `clip`) gs; see
    :func:`adamw_update`."""
    if clip is not None:
        div, mul = clip
        for g in gs:
            g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
    for p, g, m, v in zip(ps, gs, mus, nus):
        for sl in _slices(p.shape, CHUNK):
            pc, gc, mc, nc = p[sl], g[sl], m[sl], v[sl]
            mu = (1 - b1) * gc + b1 * mc
            nu = (1 - b2) * (gc * gc) + b2 * nc
            u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + eps)
            u = (u + weight_decay * pc) * lr.to(u.dtype)
            torch.where(commit, (pc + u).to(pc.dtype), pc, out=pc)
            torch.where(commit, mu, mc, out=mc)
            torch.where(commit, nu, nc, out=nc)


# -------------------------------------------------------------------- kernel


def plan(leaves: list, threads: int) -> list:
    """The kernels' walk: [(element bytes, [(leaf index, head, nvec, tail,
    rot), ...]), ...], one entry a launch.

    `leaves[i]` = (addresses of leaf i's tensors, numel, element bytes);
    `threads` the launch's threads. Leaves of one element size, in order,
    go to launches of at most MAX_LEAVES; empty leaves to none. A leaf is
    cut into `head` scalar elements up to the first 16-byte boundary,
    `nvec` 16-byte vectors and `tail` scalar elements; where its tensors'
    addresses differ modulo 16 it is all head. The kernel deals a launch's
    units (vectors, then the head's and the tail's scalars, leaf by leaf)
    round-robin to its threads: unit u of a leaf to thread (u + rot) %
    threads, rot the launch's earlier units modulo `threads`."""
    by_size: dict[int, list] = {}
    for i, (addrs, numel, size) in enumerate(leaves):
        if numel:
            by_size.setdefault(size, []).append(i)
    out = []
    for size, idx in by_size.items():
        vec = VEC_BYTES // size
        for start in range(0, len(idx), MAX_LEAVES):
            walks, base = [], 0
            for i in idx[start:start + MAX_LEAVES]:
                addrs, numel, _ = leaves[i]
                offsets = {a % VEC_BYTES for a in addrs}
                if len(offsets) == 1:
                    head = min(numel, (-offsets.pop() % VEC_BYTES) // size)
                    nvec = (numel - head) // vec
                    tail = numel - head - nvec * vec
                else:
                    head, nvec, tail = numel, 0, 0
                walks.append((i, head, nvec, tail, base % threads))
                base += head + nvec + tail
            out.append((size, walks))
    return out


def _lib():
    lib = _build.load("adamw")
    if lib.adamw_update.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        table = [p, p, p, p, p, i, i, i]  # ptrs, nvec, head, tail, rot, n, dtype, grid
        lib.adamw_update.argtypes = table + [p] * 6 + [f] * 6 + [p]
        lib.adamw_sumsq.argtypes = table + [p, p]
        lib.adamw_sumsq_finish.argtypes = [p, i, p, p]
        for fn in (lib.adamw_update, lib.adamw_sumsq, lib.adamw_sumsq_finish):
            fn.restype = i
    return lib


def _grid(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count * CTAS_PER_SM


def _dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill exactly numel slots from its data pointer."""
    want = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda s: s[1]):
        if size != 1:
            if stride != want:
                return False
            want *= size
    return True


def _layout(t: torch.Tensor) -> tuple:
    return tuple(stride for stride, size in zip(t.stride(), t.shape) if size != 1)


def _checked(leaves: list, device: torch.device) -> list:
    """Each leaf's tuple of tensors as the kernels take them: on the CUDA
    `device`, one shape and a dtype of _DTYPES, the first tensor dense and
    the others of its layout. A gradient (the second tensor of a four) of
    another layout is copied into the first's; otherwise raises."""
    out = []
    for ts in leaves:
        first = ts[0]
        if first.dtype not in _DTYPES:
            raise TypeError(f"the AdamW kernels take bf16 and fp32 leaves, not {first.dtype}")
        if not _dense(first):
            raise ValueError(f"a leaf of shape {tuple(first.shape)} and strides {first.stride()} is not dense")
        fixed = []
        for j, t in enumerate(ts):
            if t.device != device or t.dtype != first.dtype or t.shape != first.shape:
                raise ValueError(f"a leaf's tensors differ: {t.dtype} {tuple(t.shape)} on {t.device} against "
                                 f"{first.dtype} {tuple(first.shape)} on {device}")
            if _layout(t) != _layout(first):
                if j != 1 or len(ts) != 4:
                    raise ValueError(f"the moments must have their param's layout: strides {t.stride()} against "
                                     f"{first.stride()}")
                t = torch.empty_like(first).copy_(t)
            fixed.append(t)
        out.append(tuple(fixed))
    return out


def _scalar(t: torch.Tensor, dtype: torch.dtype, device: torch.device, name: str) -> int:
    if t.dtype != dtype or t.numel() != 1 or t.device != device:
        raise ValueError(f"{name} must be one {dtype} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def _tables(walks: list, leaves: list) -> tuple:
    """The ctypes arrays of one launch: pointers (each tensor slot of every
    leaf, slot by slot), nvec, head, tail, rot."""
    n = len(walks)
    slots = len(leaves[walks[0][0]])
    ptrs = [leaves[i][s].data_ptr() for s in range(slots) for i, *_ in walks]
    return ((ctypes.c_void_p * (slots * n))(*ptrs), (ctypes.c_longlong * n)(*(w[2] for w in walks)),
            (ctypes.c_int * n)(*(w[1] for w in walks)), (ctypes.c_int * n)(*(w[3] for w in walks)),
            (ctypes.c_int * n)(*(w[4] for w in walks)), n)


def _launches(leaves: list, grid: int) -> list:
    dtype_of = {t.element_size(): _DTYPES[t.dtype] for t, *_ in leaves}
    walk = plan([(tuple(t.data_ptr() for t in ts), ts[0].numel(), ts[0].element_size()) for ts in leaves],
                grid * NT)
    return [(dtype_of[size], _tables(walks, leaves)) for size, walks in walk]


def sum_squares(gs: list) -> torch.Tensor:
    """Σ g² over the leaves `gs`: a 0-d fp32 tensor on their device."""
    device = gs[0].device
    if device.type == "cpu":
        return sum_squares_plain(gs)
    leaves = _checked([(g if _dense(g) else g.contiguous(),) for g in gs], device)
    grid = _grid(device)
    launches = _launches(leaves, grid)
    if not launches:
        return torch.zeros((), dtype=torch.float32, device=device)
    partials = torch.empty(len(launches) * grid, dtype=torch.float64, device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    lib, stream = _lib(), torch.cuda.current_stream(device).cuda_stream
    for j, (dtype, table) in enumerate(launches):
        _build.check(lib.adamw_sumsq(*table, dtype, grid, partials[j * grid:].data_ptr(), stream), "adamw_sumsq")
        _build.count_launch("adamw_sum_squares")
    _build.check(lib.adamw_sumsq_finish(partials.data_ptr(), partials.numel(), out.data_ptr(), stream),
                 "adamw_sumsq_finish")
    _build.count_launch("adamw_sum_squares")
    return out


def adamw_update(ps: list, gs: list, mus: list, nus: list, *, lr, bc1, bc2, commit, clip=None,
                 b1: float, b2: float, eps: float, weight_decay: float) -> None:
    """One AdamW step with optax's arithmetic, in place on the params `ps`
    and the moments `mus`, `nus` (one list entry a leaf, in the params'
    dtype), from the grads `gs`: mu <- (1 - b1) g + b1 mu, nu <- (1 - b2)
    g² + b2 nu, p <- p + lr ((mu / bc1) / (sqrt(nu / bc2) + eps) +
    weight_decay p). `lr` (negative: the step's -lr), `bc1`, `bc2` are 0-d
    fp32 tensors; `clip` None or the clip's 0-d fp32 (div, mul), g read as
    (g / div) * mul; `commit` a 0-d bool tensor: where it is False nothing
    changes. The plain version (CPU tensors) writes the clipped grads back
    into `gs`; the kernel leaves them unchanged."""
    kw = dict(lr=lr, bc1=bc1, bc2=bc2, commit=commit, clip=clip, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    device = ps[0].device
    if device.type == "cpu":
        return adamw_update_plain(ps, gs, mus, nus, **kw)
    scalars = [_scalar(t, torch.float32, device, name) for name, t in (("lr", lr), ("bc1", bc1), ("bc2", bc2))]
    div, mul = (None, None) if clip is None else (_scalar(t, torch.float32, device, "the clip's factor")
                                                    for t in clip)
    flag = _scalar(commit, torch.bool, device, "commit")
    leaves = _checked(list(zip(ps, gs, mus, nus)), device)
    grid = _grid(device)
    lib, stream = _lib(), torch.cuda.current_stream(device).cuda_stream
    # the Python doubles the eager ops take, as the fp32 the card's ops compute with
    consts = (1 - b1, b1, 1 - b2, b2, eps, weight_decay)
    for dtype, table in _launches(leaves, grid):
        _build.check(lib.adamw_update(*table, dtype, grid, *scalars, div, mul, flag, *consts, stream), "adamw_update")
        _build.count_launch("adamw_update")
