"""The collectives the parallel forms use, over one process group.

The JAX package's ``psum``, ``all_gather`` and ``ppermute`` run inside
``shard_map``; here every shard is a process and they are
``torch.distributed`` calls on the group the caller passes.  Sums run in
the tensor's own dtype, as ``psum`` sums in the output's dtype: each
addition is rounded to it (bf16 over two ranks is the correctly rounded
sum, the same bits as ``psum``; over more ranks the order of the
roundings is the backend's).

gloo keeps its buffers in host memory: under gloo a CUDA tensor is copied
to the host, reduced or sent there, and copied back
(:func:`_via_host`), for every collective alike.  NCCL takes the CUDA
tensor itself, so only NCCL collectives can sit inside a captured CUDA
graph (``serving.engine.Engine`` refuses ``graphs=True`` on any other).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def backend(group) -> str:
    """The group's backend name (``"gloo"``, ``"nccl"``)."""
    return str(dist.get_backend(group))


def _via_host(t: torch.Tensor, group) -> bool:
    """True when ``t`` must be staged through host memory for ``group``:
    a CUDA tensor on a gloo group."""
    return t.is_cuda and backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group in place (``psum``)."""
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from group rank ``src`` into every rank's ``t``, in place."""
    src = dist.get_global_rank(group, src)
    if _via_host(t, group):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in group-rank order."""
    src = t.cpu() if _via_host(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts]


def send(t: torch.Tensor, dst: int, group) -> None:
    """``t`` to group rank ``dst`` (pairs with :func:`recv_`)."""
    dst = dist.get_global_rank(group, dst)
    dist.send(t.cpu() if _via_host(t, group) else t.contiguous(), dst,
              group=group)


def recv_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s :func:`send` into ``t``, in place."""
    src = dist.get_global_rank(group, src)
    if _via_host(t, group):
        host = torch.empty_like(t, device="cpu")
        dist.recv(host, src, group=group)
        t.copy_(host)
    else:
        dist.recv(t, src, group=group)
    return t
