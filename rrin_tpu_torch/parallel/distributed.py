"""Multi-process bring-up: ``torch.distributed`` where the JAX package uses
``jax.distributed``.

``initialize`` reads the same three settings as the JAX package's
(arguments first, then ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
and ``JAX_PROCESS_ID``) and with more than one process joins the process
group at ``tcp://<coordinator>``: NCCL where CUDA is available, gloo on a
CPU-only host. On one process it is a no-op that reports local facts, so
every entry point can call it unconditionally.

A mesh (``parallel.sharding``) holds the devices of this process only. With
CUDA, the processes of one host share its cards out: each takes an equal
run of ``cuda:0 .. device_count() - 1`` by its rank among the processes of
its host (one card each where there are as many processes as cards, or
where each sees only its own card), makes the first its current device, and
``make_mesh()`` lists those. A multi-process run serves one stream per
process; training averages its gradients over the process group
(``rrin_tpu_torch.train``).
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DistributedContext:
    initialized: bool
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> DistributedContext:
    """Join the process group when configured; harmless on one process.

    Explicit args win; else the JAX package's env vars
    (``JAX_COORDINATOR_ADDRESS`` as ``host:port``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``). ``local_device_count`` counts this process's CUDA
    devices (:func:`local_devices`; 1 on a CPU-only host);
    ``global_device_count`` is it times the process count.
    """
    coordinator = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes or _int_env("JAX_NUM_PROCESSES")
    pid = process_id if process_id is not None else _int_env("JAX_PROCESS_ID")

    global _LOCAL
    did_init = False
    if coordinator is not None and nproc and nproc > 1 and not dist.is_initialized():
        cuda = torch.cuda.is_available()
        dist.init_process_group(
            backend="nccl" if cuda else "gloo",
            init_method=f"tcp://{coordinator}",
            world_size=nproc,
            rank=pid or 0,
        )
        did_init = True
        if cuda:
            # which ranks share this host: over gloo, before NCCL touches a card
            hosts: List[Optional[str]] = [None] * nproc
            dist.all_gather_object(hosts, socket.gethostname(),
                                   group=dist.new_group(backend="gloo"))
            _LOCAL = host_share(hosts, dist.get_rank(), torch.cuda.device_count())
            torch.cuda.set_device(_LOCAL[0])

    on = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if on else 1
    local = len(local_devices()) if torch.cuda.is_available() else 1
    return DistributedContext(
        initialized=did_init,
        process_index=dist.get_rank() if on else 0,
        process_count=count,
        local_device_count=local,
        global_device_count=local * count,
    )


# This process's CUDA devices once ``initialize`` has shared a host's cards
# out among its processes (None: every card of the host).
_LOCAL: Optional[List[torch.device]] = None


def host_share(hosts: List[str], rank: int, n_devices: int) -> List[torch.device]:
    """The CUDA devices of process ``rank`` when ``hosts[r]`` names the host
    of each rank and each host has ``n_devices`` cards: an equal run of them
    by the process's rank among those of its host."""
    peers = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    per = n_devices // len(peers)
    if per < 1:
        raise RuntimeError(
            f"{len(peers)} processes on host {hosts[rank]!r} share {n_devices} CUDA "
            "device(s): NCCL needs a device of its own for each process")
    first = peers.index(rank) * per
    return [torch.device("cuda", i) for i in range(first, first + per)]


def local_devices() -> List[torch.device]:
    """This process's CUDA devices: its share of the host's cards in a
    process group that ``initialize`` joined, else every card."""
    if _LOCAL is not None and dist.is_available() and dist.is_initialized():
        return list(_LOCAL)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def world_size() -> int:
    """Processes in the initialised group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _int_env(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val else None
