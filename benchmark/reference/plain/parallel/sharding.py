"""Process groups for multi-GPU training and rendering on ``torch.distributed``.

Counterpart of ``geosplatting_tpu/parallel/sharding.py``. Where the JAX
package builds a device mesh with a ``dp`` axis in one process, the port
runs one process per GPU (``torchrun``), each holding the whole train
state, and splits the camera batch by rank:

- ``init_from_env``: the rank, world size and device of this process, from
  a group that is already initialised or from ``torchrun``'s variables;
- ``shard_batch``: this rank's contiguous slice of a batch, the split of
  the JAX ``P("dp")``;
- ``replicate``: rank 0's values broadcast into every rank's tensors;
- ``all_reduce_`` / ``all_gather_rows``: the collectives of the sharded
  paths. Under gloo a CUDA tensor goes through a host copy (gloo reduces
  host memory), so two gloo ranks can share one card;
- ``sum_grad_over_ranks`` / ``gather_rows``: the autograd pieces of the
  sharded renders (``tile_sharding.py``, ``gs_sharding.py``);
- ``spawn_gloo``: ranks in fresh processes of one machine over a gloo
  group (the CPU tests; two ranks sharing one card).

Importing this module starts no process group and touches no device.
"""
from __future__ import annotations

import datetime
import os
from typing import Any

import torch
import torch.distributed as dist

from .. import _kernels


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


# how long a collective waits for the slowest rank (rank 0 validates and
# writes while the others wait at a barrier)
TIMEOUT = datetime.timedelta(seconds=1800)


def init_from_env(device: str | torch.device | None = None) -> tuple[int, int, torch.device]:
    """(rank, world size, device) of this process. Uses the process group
    that is already initialised, else starts one from ``torchrun``'s
    ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (and ``MASTER_ADDR`` /
    ``MASTER_PORT``) when ``WORLD_SIZE`` > 1: NCCL on CUDA, gloo on the CPU.
    With no group and ``WORLD_SIZE`` unset or 1 it returns (0, 1, device)
    and starts nothing. A CUDA device without an index becomes the card of
    ``LOCAL_RANK`` (the rank where that is unset), modulo the cards
    present."""
    device = _kernels.resolve_device(device)
    if is_distributed():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", "0"))
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1 and not is_distributed():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", rank=rank,
                                world_size=world, timeout=TIMEOUT)
    return rank, world, device


def rank_and_world(group=None) -> tuple[int, int]:
    if not is_distributed():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_batch(batch: Any, rank: int, world: int) -> Any:
    """This rank's contiguous slice of ``batch`` along its leading axis:
    rows [rank * B / world, (rank + 1) * B / world). ``batch`` is a tensor,
    ``Cameras``, a list, or a tuple or dict of those (each sliced alike).
    Raises where the world size does not divide B."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(shard_batch(v, rank, world) for v in batch)
    lo, hi = shard_range(len(batch), rank, world)
    return batch[lo:hi]


def shard_range(n: int, rank: int, world: int) -> tuple[int, int]:
    """[lo, hi): the rows of a batch of ``n`` that are ``rank``'s. Raises
    where the world size does not divide ``n``."""
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks; "
                         f"give a batch size divisible by {world}")
    b = n // world
    return rank * b, (rank + 1) * b


def _gloo_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


@torch.no_grad()
def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce of ``t``; returns ``t``."""
    if _gloo_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


@torch.no_grad()
def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along axis 0, in rank order (all
    ranks pass the same shape)."""
    world = dist.get_world_size(group)
    src = t.detach().contiguous()
    if _gloo_host(t, group):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


@torch.no_grad()
def replicate(tensors, group=None, src: int = 0) -> None:
    """Overwrite every rank's ``tensors`` (an iterable, or a module's
    parameters and buffers) with rank ``src``'s values."""
    if isinstance(tensors, torch.nn.Module):
        tensors = [*tensors.parameters(), *tensors.buffers()]
    for t in tensors:
        if _gloo_host(t, group):
            host = t.detach().cpu()
            dist.broadcast(host, src=src, group=group)
            t.copy_(host)
        else:
            dist.broadcast(t.detach(), src=src, group=group)


class _SumGrad(torch.autograd.Function):
    """Identity forward; the gradient summed over the ranks backward (the
    transpose of replicating a tensor on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), group=ctx.group), None


class _GatherRows(torch.autograd.Function):
    """Every rank's rows concatenated forward. Backward, this rank's rows of
    the gradient: as they are (``summed`` False: every rank holds the same
    loss of the gathered tensor, so each rank's rows are counted once), or
    summed over the ranks (``summed`` True: each rank differentiates its own
    loss term of the whole gathered tensor). The sum is a reduce-scatter,
    written as an all-reduce of the whole gradient and a slice, which every
    backend has."""

    @staticmethod
    def forward(ctx, x, group, summed):
        ctx.group, ctx.summed, ctx.rows = group, summed, x.shape[0]
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        rank = dist.get_rank(ctx.group)
        if ctx.summed:
            g = all_reduce_(g.contiguous().clone(), group=ctx.group)
        return g[rank * ctx.rows:(rank + 1) * ctx.rows], None, None


def sum_grad_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x``, its gradient summed over the ranks (``x`` itself with no
    group)."""
    return _SumGrad.apply(x, group) if is_distributed() else x


def gather_rows(x: torch.Tensor, group=None, summed: bool = False) -> torch.Tensor:
    """Every rank's ``x`` concatenated along axis 0, differentiable
    (``_GatherRows``; ``x`` itself with no group)."""
    return _GatherRows.apply(x, group, summed) if is_distributed() else x


def _gloo_rank(rank: int, fn, world: int, rendezvous: str, args: tuple) -> None:
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_gloo(fn, world: int, rendezvous: str | os.PathLike, *args, join: bool = True):
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (the
    ``spawn`` start method: CUDA does not survive ``fork``) that share a gloo
    group, rendezvousing through the file ``rendezvous`` (which must not
    exist yet). ``fn`` must be importable by name. Returns when every rank
    has returned, raising if any rank raised, after stopping the others;
    with ``join`` False at once, with the process context whose ``join()``
    does that. Build the kernels before: a rank then finds them built."""
    return torch.multiprocessing.spawn(_gloo_rank, args=(fn, world, str(rendezvous), args),
                                       nprocs=world, join=join)
