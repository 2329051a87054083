"""Collectives over a mesh axis, with the gradients tensor parallelism wants.

Counterpart of ``dynamictreeattn_tpu/parallel/collectives.py``. A plain
all-reduce whose backward is another all-reduce double-counts when the
cotangent is already replicated (every rank of the group holds the same
gradient, and the sum multiplies it by the group's size). Tensor
parallelism wants the Megatron f/g operator pair instead, here as
``torch.autograd.Function``s over a process group:

* ``mpar_in`` (f): identity forward, all-reduce backward — placed where a
  replicated activation enters rank-local compute, restoring the full input
  gradient before it flows upstream;
* ``mpar_out`` (g): all-reduce forward, identity backward — placed where
  rank-local partial sums are combined into a replicated activation; since
  ∂(Σ_j x_j)/∂x_local = 1, identity is the exact gradient;
* ``const_pmax``: an all-reduce max treated as a constant (a softmax
  stabiliser only: its gradient cancels analytically);
* ``all_to_all``: equal splits of dim 0 exchanged over the group; its
  backward is the reverse exchange, which for equal splits is the same
  exchange of the cotangent (JAX gets it by transposing ``lax.all_to_all``).

A group of None (an axis of size 1) makes every operator the identity.
Every collective of the port goes through ``_call``, one place to count or
time them. gloo and NCCL both take ``all_to_all_single``, the one
all-to-all used here (gloo has no list ``all_to_all``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_dim", "all_reduce_", "all_to_all", "broadcast_", "const_pmax", "mpar_in", "mpar_out"]


def _call(name: str, *args, **kwargs) -> None:
    """Run ``torch.distributed.<name>`` (synchronously: the tensors are
    ready when it returns)."""
    getattr(dist, name)(*args, **kwargs)


def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """`x` reduced over `group` in place ("sum" or "max"), and returned."""
    if group is not None:
        _call("all_reduce", x, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX, group=group)
    return x


def broadcast_(x: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """`x` of global rank `src` on every rank of `group` (default: the world), in place."""
    _call("broadcast", x, src=src, group=group)
    return x


def all_gather_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ranks' `x` concatenated along `dim`, in rank order."""
    if group is None:
        return x
    parts = x.movedim(dim, 0).contiguous()
    out = torch.empty((dist.get_world_size(group) * parts.shape[0], *parts.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _call("all_gather_into_tensor", out, parts, group=group)
    return out.movedim(0, dim)


class _MparIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _MparOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    _call("all_to_all_single", out, x, group=group)
    return out


def mpar_in(x: torch.Tensor, group) -> torch.Tensor:
    """f: identity forward, all-reduce backward."""
    return x if group is None else _MparIn.apply(x, group)


def mpar_out(x: torch.Tensor, group) -> torch.Tensor:
    """g: all-reduce forward, identity backward."""
    return x if group is None else _MparOut.apply(x, group)


def const_pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The group's elementwise max of `x`, without gradient."""
    return x if group is None else all_reduce_(x.detach().clone(), group, "max")


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Equal splits of dim 0: split j goes to the group's rank j, and the
    result holds rank i's split in place i. Differentiable (float `x`);
    an integer `x` is exchanged without autograd."""
    if group is None:
        return x
    if not x.is_floating_point():
        return _exchange(x, group)
    return _AllToAll.apply(x, group)
