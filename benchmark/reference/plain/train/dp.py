"""Data-parallel (camera-batch) gradients for the trainers on
``torch.distributed``.

Counterpart of ``geosplatting_tpu/train/dp.py``. The JAX package runs each
device's cameras under ``shard_map`` and merges the gradients with one
``pmean``; the port runs one process per GPU, each rendering its shard of
the camera batch, and all-reduces the gradients after the backward.

Exactness contract (``geosplatting_tpu/train/dp.py:10-15``): every
batch-dependent term of a rank's loss is a mean over its own cameras, the
shards are of equal size, and every parameter-only term (the regularizers)
is the same on every rank. The mean over the ranks of their gradients is
then the whole batch's gradient up to float reassociation:

- ``reduce_grads``: each parameter's ``.grad`` all-reduced to its mean, in
  a few flat buckets (not one call per tensor);
- ``reduce_aux``: the mean auxiliaries (loss, MSE, regularization) to
  their mean, the max auxiliaries (pair and face counts, fills) with MAX,
  as the single process takes the largest over its cameras.

Randomness is the trainers' business (their ``train_step_dp``): every rank
seeds its generator alike and draws the whole batch's noise, then keeps its
shard, so a rank's draws are bit for bit what one process draws for those
cameras.
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from ..parallel.sharding import all_reduce_, rank_and_world

# bytes of gradients gathered into one flat buffer a collective
BUCKET_BYTES = 1 << 25


@torch.no_grad()
def reduce_grads(params: Iterable[torch.Tensor], group=None) -> int:
    """Replace every parameter's ``.grad`` with its mean over the ranks:
    the gradients are copied into flat buffers of up to ``BUCKET_BYTES``
    (a larger gradient takes a buffer of its own), each buffer all-reduced
    once. Returns the bytes all-reduced (0 with no group: nothing to do)."""
    world = rank_and_world(group)[1]
    if world == 1:
        return 0
    buckets, size = [[]], 0
    for g in (p.grad for p in params if p.grad is not None):
        nbytes = g.numel() * g.element_size()
        if buckets[-1] and size + nbytes > BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    total = 0
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        all_reduce_(flat, group=group).div_(world)
        total += flat.numel() * flat.element_size()
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return total


@torch.no_grad()
def reduce_aux(mean_aux: tuple, max_aux: dict, group=None) -> tuple[tuple, dict]:
    """(mean_aux averaged over the ranks, max_aux with each entry's largest
    value over the ranks), each entry of the type it came in (a 0-d tensor
    or a Python number). Two all-reduces; with no group, both as given."""
    world = rank_and_world(group)[1]
    if world == 1:
        return tuple(mean_aux), dict(max_aux)
    device = next((v.device for v in (*mean_aux, *max_aux.values())
                   if isinstance(v, torch.Tensor)), torch.device("cpu"))
    means = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device).reshape(())
                         for v in mean_aux])
    all_reduce_(means, group=group).div_(world)
    keys = list(max_aux)
    maxes = torch.stack([torch.as_tensor(max_aux[k], dtype=torch.float64, device=device)
                         .reshape(()) for k in keys])
    all_reduce_(maxes, op=dist.ReduceOp.MAX, group=group)
    host = maxes.tolist()
    out = {}
    for k, v, h in zip(keys, maxes, host):
        orig = max_aux[k]
        out[k] = v.to(orig.dtype) if isinstance(orig, torch.Tensor) else type(orig)(h)
    return tuple(means.unbind()), out
