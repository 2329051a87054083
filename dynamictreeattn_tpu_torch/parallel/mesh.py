"""The device mesh over torch.distributed: one process per rank.

Counterpart of ``dynamictreeattn_tpu/parallel/mesh.py``. The JAX mesh is a
4-D array of devices ("data", "seq", "pipe", "model"); here each rank is a
process, and its coordinates come from its global rank in the same order,
"model" innermost: rank = ((data · seq + s) · pipe + p) · model + m. For
each axis of size above 1 the mesh holds the process group of the ranks
that share this rank's other coordinates (``group(axis)``), its members in
the order of that axis (a group rank is the rank's coordinate on it); an
axis of size 1 has no group and costs nothing. A "pipe" group is one stage
row: the ranks that share (data, model), in stage order. Pipeline and
sequence parallelism both cut the token work and exclude each other (as in
JAX's pipeline): sp > 1 with pp > 1 raises.

The backend follows one rule, never switched silently:

* NCCL when every rank has a card of its own;
* when ranks would share a card (more ranks on this host than cards), NCCL
  refuses two ranks of one communicator on one device, so ``make_mesh``
  raises unless the caller passes ``backend="gloo"``;
* gloo on the CPU (``device="cpu"``), where NCCL does not run.

A rank's device is ``cuda:(local_rank % device_count)`` unless the caller
asks for the CPU. ``make_mesh`` joins the default process group if it is
up (a launcher's script, ``torchrun``, or a test's ``FileStore``), checking
its backend against the rule, and otherwise starts it from the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).
"""

from __future__ import annotations

import itertools
import os

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "pick_backend"]


class Mesh:
    """This rank's place in a (data, seq, pipe, model) mesh of processes."""

    def __init__(self, shape: dict, coords: dict, groups: dict, backend: str, device: torch.device, everyone):
        self.shape = shape  # {axis: size}
        self.coords = coords  # {axis: this rank's index on it}
        self.groups = groups  # {axis: ProcessGroup} for the axes of size > 1
        self.backend = backend
        self.device = device
        self.everyone = everyone  # the group of every rank of the mesh (global ranks 0 .. world - 1)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def rank(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of `axis` (None for an axis of size 1)."""
        return self.groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords}, backend={self.backend!r}, device={self.device})"


def _local_ranks() -> tuple[int, int]:
    """(local rank, ranks on this host) from the launcher's environment
    (torchrun sets LOCAL_RANK and LOCAL_WORLD_SIZE); one host by default."""
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0"))
    return int(os.environ.get("LOCAL_RANK", rank)), int(os.environ.get("LOCAL_WORLD_SIZE", world))


def pick_backend(backend: str | None, device: str | torch.device, local_world: int) -> str:
    """The backend the rule gives (module docstring); raises where it
    refuses the caller's."""
    device = torch.device(device)
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if device.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL does not run on the CPU: backend='gloo'")
        return "gloo"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    if local_world > cards and backend != "gloo":
        raise ValueError(f"{local_world} ranks would share {cards} card(s): NCCL refuses two ranks of one "
                         "communicator on one device; pass backend='gloo' to run them over gloo")
    return backend or "nccl"


def make_mesh(dp: int | None = None, tp: int = 1, sp: int = 1, pp: int = 1, backend: str | None = None,
              device: str | torch.device = "cuda") -> Mesh | None:
    """The mesh of the first dp·sp·pp·tp ranks (`dp` None: every rank).
    Every rank of the world must call it (process groups are made
    collectively); a rank outside the mesh gets None."""
    if pp > 1 and sp > 1:
        raise ValueError("pipeline and sequence parallelism are exclusive")
    local_rank, local_world = _local_ranks()
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise ValueError("torch.distributed is not initialised and no launcher environment (RANK, "
                             "WORLD_SIZE, MASTER_ADDR, MASTER_PORT) says how to start it")
        dist.init_process_group(pick_backend(backend, device, local_world), init_method="env://")
    actual = dist.get_backend()
    if backend is not None and actual != backend:
        raise ValueError(f"the process group runs {actual!r}, not the {backend!r} asked for")
    pick_backend(actual, device, local_world)  # raises for NCCL on the CPU or on a shared card
    world = dist.get_world_size()
    if dp is None:
        dp = world // (tp * sp * pp)
    shape = {"data": dp, "seq": sp, "pipe": pp, "model": tp}
    need = dp * sp * pp * tp
    if need > world or need < 1:
        raise ValueError(f"need {need} ranks, have {world}")
    rank = dist.get_rank()
    coords = {"data": rank // (tp * pp * sp), "seq": rank // (tp * pp) % sp, "pipe": rank // tp % pp,
              "model": rank % tp}

    def at(data, seq, pipe, model):
        return ((data * sp + seq) * pp + pipe) * tp + model

    def rows(axis):  # the member lists of `axis`'s groups: the other coordinates fixed
        others = [a for a in shape if a != axis]
        return [[at(**dict(zip(others, fixed)), **{axis: i}) for i in range(shape[axis])]
                for fixed in itertools.product(*(range(shape[a]) for a in others))]

    groups = {}
    # every rank makes every group, in one order (new_group is collective)
    for axis, members in ((a, rows(a)) for a in ("data", "seq", "model", "pipe")):
        if shape[axis] == 1:
            continue
        for ranks in members:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    everyone = dist.new_group(list(range(need))) if need < world else dist.group.WORLD
    if rank >= need:
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(shape, coords, groups, actual, dev, everyone)
