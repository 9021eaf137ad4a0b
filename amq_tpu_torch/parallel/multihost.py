"""Multi-host start-up and the ('data', 'tensor') process layout.

The port of the JAX package's ``parallel/multihost.py``.
:func:`initialize` joins this process to the group
(``torch.distributed.init_process_group``, one process per shard) with a
backend the caller names; :func:`pod_mesh` lays the group's ranks out as
``('data', 'tensor')`` with every 'tensor' row inside one host, so the
row-parallel all-reduces stay on a host's own links and only the
data-parallel reductions cross hosts.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import List, Optional, Sequence

import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               init_method: Optional[str] = None) -> None:
    """Join the process group (a no-op for one process).

    ``backend`` ("nccl" or "gloo") must be named: it is never picked for
    the caller.  The rendezvous is ``init_method`` when given (e.g. a
    ``file://`` store), else ``tcp://coordinator_address``."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        raise ValueError("name the process group's backend ('nccl' or "
                         "'gloo')")
    if init_method is None:
        if coordinator_address is None:
            raise ValueError("give coordinator_address (host:port) or "
                             "init_method")
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def pod_rows(hosts: Sequence[str],
             tensor_per_host: Optional[int] = None) -> List[List[int]]:
    """Ranks laid out as rows of the 'tensor' axis, one row per 'data'
    index: ``hosts[r]`` names rank r's host; each host's ranks, in rank
    order, are cut into rows of ``tensor_per_host`` (default: all of
    them), hosts in order of their first rank.  Refuses hosts with
    unequal rank counts and a ``tensor_per_host`` that does not divide a
    host's count (a 'tensor' row across hosts defeats the layout)."""
    by_host: dict = {}
    for r, h in enumerate(hosts):
        by_host.setdefault(h, []).append(r)
    counts = {len(v) for v in by_host.values()}
    if len(counts) != 1:
        raise ValueError(f"uneven local rank counts: {by_host}")
    n_local = counts.pop()
    tensor = tensor_per_host or n_local
    if n_local % tensor:
        raise ValueError(f"tensor_per_host={tensor} must divide the "
                         f"{n_local} local ranks of each host")
    rows = []
    for ranks in by_host.values():
        rows.extend(ranks[i:i + tensor] for i in range(0, n_local, tensor))
    return rows


@dataclasses.dataclass
class PodMesh:
    """This rank's place in a two-axis layout of the group's ranks and
    its two groups: its row (the 'tensor' axis) and its column (the
    other axis: 'data' here, 'stage' for ``parallel.pp``)."""

    rows: List[List[int]]        # global ranks, [data][tensor]
    data_index: int
    tensor_index: int
    tensor_group: object         # this rank's row
    data_group: object           # this rank's column

    @property
    def shape(self) -> dict:
        return {"data": len(self.rows), "tensor": len(self.rows[0])}


def grid(rows: Sequence[Sequence[int]]) -> PodMesh:
    """Groups for ``rows`` (global ranks, every row one 'tensor' group,
    every column one 'data' group).  Every rank of the group calls it:
    the groups are made in the same order everywhere, on the default
    group's backend."""
    rows = [list(r) for r in rows]
    me = dist.get_rank()
    backend = dist.get_backend()
    t_groups = [dist.new_group(row, backend=backend) for row in rows]
    d_groups = [dist.new_group([row[j] for row in rows], backend=backend)
                for j in range(len(rows[0]))]
    d = next(i for i, row in enumerate(rows) if me in row)
    t = rows[d].index(me)
    return PodMesh(rows=rows, data_index=d, tensor_index=t,
                   tensor_group=t_groups[d], data_group=d_groups[t])


def pod_mesh(tensor_per_host: Optional[int] = None,
             host: Optional[str] = None) -> PodMesh:
    """The ('data', 'tensor') layout of the whole group, every 'tensor'
    row inside one host (:func:`pod_rows`).  Every rank calls it (it
    gathers the ranks' host names, then :func:`grid`).  ``host`` names
    this rank's host (default ``socket.gethostname()``)."""
    hosts: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, host or socket.gethostname())
    return grid(pod_rows(hosts, tensor_per_host))
