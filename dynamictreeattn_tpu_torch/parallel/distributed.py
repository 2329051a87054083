"""Multi-host bring-up over torch.distributed.

Counterpart of ``dynamictreeattn_tpu/parallel/distributed.py``. The port
runs one process per rank on one host or on many, so a multi-host run is
the same code path as a one-host run: every rank joins one default process
group, ``parallel.make_mesh`` lays the ranks out in the same order, and each
rank builds and uploads only its own data row. The math is therefore
identical to a one-host run of the same mesh; only the transport between
hosts differs (NCCL across nodes where every rank has a card of its own;
gloo otherwise). NCCL across hosts runs on no machine this package was
tested on: its tests run several "hosts" as groups of processes on one
machine, with the environment a two-node ``torchrun`` launch gives.

Usage (the same script on every host, e.g. under ``torchrun --nnodes``)::

    from dynamictreeattn_tpu_torch.parallel.distributed import initialize_multihost, local_data_ranks
    info = initialize_multihost()          # a lone process: does nothing
    mesh = make_mesh(dp=..., tp=...)       # every rank of every host
    my_rows = local_data_ranks(mesh)       # the data ranks this host feeds
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from dynamictreeattn_tpu_torch.parallel.mesh import _local_ranks, pick_backend
from dynamictreeattn_tpu_torch.parallel.train import _cut

__all__ = ["HostInfo", "global_placer", "initialize_multihost", "local_data_ranks", "put_global"]


@dataclasses.dataclass(frozen=True)
class HostInfo:
    process_index: int  # the global rank
    process_count: int  # the world size
    local_devices: int  # this host's cards (its ranks, on the CPU)
    global_devices: int  # the sum of local_devices over the hosts


def _host_id() -> str:
    """This process's host: the launcher's node rank (``GROUP_RANK``), else
    the host name."""
    return os.environ.get("GROUP_RANK") or socket.gethostname()


def initialize_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, *, backend: str | None = None,
                         device: str | torch.device = "cuda") -> HostInfo:
    """Start the default process group (idempotent; a lone process starts
    none) and describe this process's place. With arguments: the
    coordinator's ``host:port`` (TCP) or a ``file://`` URL (a shared file,
    no port), the world size and this rank. Without: the launcher's
    environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``).
    The backend follows ``mesh.pick_backend`` for `device`; the ranks of a
    host share its cards."""
    if not dist.is_initialized():
        env = os.environ
        if coordinator_address is not None or num_processes is not None or process_id is not None:
            if coordinator_address is None or num_processes is None or process_id is None:
                raise ValueError("coordinator_address, num_processes and process_id go together")
            url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
            world, rank = int(num_processes), int(process_id)
            local_world = int(env.get("LOCAL_WORLD_SIZE", "1"))
        elif "RANK" in env and "WORLD_SIZE" in env:
            url, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
            local_world = _local_ranks()[1]
        else:
            world = 1
        if world > 1:
            dist.init_process_group(pick_backend(backend, device, local_world), init_method=url,
                                    world_size=world, rank=rank)
    dev = torch.device(device)
    local = torch.cuda.device_count() if dev.type == "cuda" else _local_ranks()[1]
    if not dist.is_initialized():
        return HostInfo(0, 1, local, local)
    table = [None] * dist.get_world_size()
    dist.all_gather_object(table, (_host_id(), local))
    return HostInfo(dist.get_rank(), dist.get_world_size(), local, sum(dict(table).values()))


def local_data_ranks(mesh) -> list[int]:
    """The data coordinates of the mesh's ranks on this host (every rank of
    the mesh calls it): the data rows this host's input pipeline builds."""
    if mesh is None or not dist.is_initialized():
        return [0]
    table = [None] * dist.get_world_size(mesh.everyone)
    dist.all_gather_object(table, (_host_id(), mesh.rank("data")), group=mesh.everyone)
    return sorted({d for host, d in table if host == _host_id()})


# This rank's slices of host-replicated full values (every process holds
# the same tree), per specs ({leaf name: ((dim, axes), ...)}, as
# ``parallel.pp_param_specs`` / ``fsdp_param_specs`` give), on the mesh's
# device: what ``shard_params`` does with the mesh's own layout. JAX places
# one leaf per call with ``global_placer``; here one function places the tree.
put_global = global_placer = _cut
