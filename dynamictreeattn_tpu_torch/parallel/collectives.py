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
  exchange of the cotangent (JAX gets it by transposing ``lax.all_to_all``);
* ``psum``: all-reduce forward and backward, JAX's ``psum`` as it transposes
  under ``shard_map(check_vma=False)``: where every rank of the group goes on
  to use the sum, each rank's loss carrying 1/size of the total (the
  sequence-parallel MoE statistics and custom-loss log-probs);
* ``ring_shift``: each rank's tensor to the next rank of the group (JAX's
  ``ppermute`` to me + 1, the ring attention's rotation); its backward shifts
  the cotangent back;
* ``fsdp_gather``: all-gather of a ZeRO-3 shard forward, reduce-scatter of
  the cotangent backward (JAX's ``all_gather`` and its transpose,
  ``psum_scatter``), keeping the shard's layout (an untied head's [d, V]
  view of [V, d] storage gathers in storage order);
* ``reduce_scatter_dim``: the reduce-scatter alone.

A group of None (an axis of size 1) makes every operator the identity.
Every collective of the port goes through ``_call``, one place to count or
time them. gloo and NCCL both take ``all_to_all_single``, the one
all-to-all used here (gloo has no list ``all_to_all``), and it carries the
ring's rotation (uneven splits: all of the buffer to one rank) and the
reduce-scatter (gloo has none: the blocks exchanged, then summed here in
rank order), so that both backends run one code path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather_dim", "all_reduce_", "all_to_all", "broadcast_", "const_pmax", "fsdp_gather", "mpar_in",
           "mpar_out", "psum", "reduce_scatter_dim", "ring_shift"]


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


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of `x`; its backward sums the cotangents too."""
    if group is None:
        return x
    if not x.is_floating_point() or not torch.is_grad_enabled():
        return all_reduce_(x.contiguous().clone(), group)
    return _Psum.apply(x, group)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """`x` of group rank (me - shift) mod size, on this rank."""
    size, me = dist.get_world_size(group), dist.get_rank(group)
    flat = x.contiguous().reshape(-1)
    send, recv = [0] * size, [0] * size
    send[(me + shift) % size] = recv[(me - shift) % size] = flat.numel()
    out = torch.empty_like(flat)
    _call("all_to_all_single", out, flat, output_split_sizes=recv, input_split_sizes=send, group=group)
    return out.view(x.shape)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Each rank's `x` on group rank me + `shift` (mod the group's size): the
    result on this rank is rank me - `shift`'s. Differentiable (float `x`)."""
    if group is None:
        return x
    if not x.is_floating_point() or not torch.is_grad_enabled():
        return _shift(x, group, shift)
    return _RingShift.apply(x, group, shift)


def _storage_order(t: torch.Tensor) -> list:
    """t's dims from the largest stride to the smallest (its storage order)."""
    return sorted(range(t.dim()), key=lambda i: -t.stride(i))


def _gather_blocks(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of `x` concatenated along `dim` in rank order, in
    x's storage order (dense)."""
    perm = _storage_order(x)
    xs = x.permute(perm).contiguous()
    ds = perm.index(dim)
    size = dist.get_world_size(group)
    out = torch.empty((size * xs.shape[0], *xs.shape[1:]), dtype=x.dtype, device=x.device)
    _call("all_gather_into_tensor", out, xs, group=group)
    full = out.view(size, *xs.shape).movedim(0, ds).reshape(*xs.shape[:ds], -1, *xs.shape[ds + 1:])
    return full.permute(sorted(range(len(perm)), key=perm.__getitem__))


def reduce_scatter_dim(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along `dim` of the group's sum of `x` (blocks in
    rank order; each block's sum added in rank order), in x's storage
    order."""
    if group is None:
        return x
    size = dist.get_world_size(group)
    perm = _storage_order(x)
    xs = x.permute(perm)
    ds = perm.index(dim)
    blocks = xs.reshape(*xs.shape[:ds], size, xs.shape[ds] // size, *xs.shape[ds + 1:]).movedim(ds, 0).contiguous()
    got = torch.empty_like(blocks)
    _call("all_to_all_single", got, blocks, group=group)
    acc = got[0]
    for part in got[1:]:
        acc = acc + part
    return acc.permute(sorted(range(len(perm)), key=perm.__getitem__))


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_blocks(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


def fsdp_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The whole of a ZeRO-3 leaf from the group's shards along `dim`; the
    backward reduce-scatters its cotangent, so each rank's shard gets the
    group's summed gradient (no all-reduce of it afterwards)."""
    if group is None or dim < 0:
        return x
    if not torch.is_grad_enabled() or not x.requires_grad:
        return _gather_blocks(x, group, dim)
    return _FsdpGather.apply(x, group, dim)
