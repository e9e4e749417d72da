"""Rank and world helpers (the port's counterpart of
``cap2det_tpu/parallel/mesh.py``).

The JAX package builds a 1-D mesh over its chips, replicates the params
on it (``replicated``), shards the batch's leading axis across it
(``shard_batch``) and lets XLA insert the gradient ``pmean``. In the port
each process of a ``torch.distributed`` group drives one card and feeds
its own slice of the global batch; these helpers are the collectives the
trainer needs:

* ``broadcast_params``: rank 0's tensors to every rank (``replicated``);
* ``all_reduce_mean``: the mean across ranks (``jax.lax.pmean``);
* ``all_gather_ints``: small host integers from every rank
  (``multihost_utils.process_allgather``).

``usable_device_count`` has no counterpart: a process group's world is
the number of processes the launcher started, one card each.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


def world_size(group=None):
    """The group's size; 1 outside a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None):
    """This process's rank in the group; 0 outside a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in _leaves(value)]
    return [tree]


def _flat_by_dtype(tensors):
    """{(dtype, device): (indices, one flat buffer of those tensors)}: one
    collective per dtype and device instead of one per tensor."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    return {key: (idx, torch.cat([tensors[i].detach().reshape(-1)
                                  for i in idx]))
            for key, idx in groups.items()}


def _split(flat, idx, tensors, out):
    offset = 0
    for i in idx:
        n = tensors[i].numel()
        out[i] = flat[offset:offset + n].view(tensors[i].shape)
        offset += n


def all_reduce_mean(tensors, group=None):
    """The mean of each tensor across the group's ranks, as new tensors in
    the order given: one flat buffer per dtype is summed across ranks,
    then divided by the world size as a tensor on the buffer's device (a
    Python scalar divides as a reciprocal multiply on CUDA, one ulp off
    IEEE division). A world of one sums over itself, which changes no
    bit, and divides by nothing."""
    world = dist.get_world_size(group)
    out = [None] * len(tensors)
    for (dtype, device), (idx, flat) in _flat_by_dtype(tensors).items():
        dist.all_reduce(flat, group=group)
        if world > 1:
            flat = flat / torch.tensor(world, dtype=dtype, device=device)
        _split(flat, idx, tensors, out)
    return out


@torch.no_grad()
def broadcast_params(tree, src=0, group=None):
    """Overwrites every tensor of a nested dict, in place, with rank
    `src`'s. Returns the tree."""
    leaves = _leaves(tree)
    for idx, flat in _flat_by_dtype(leaves).values():
        dist.broadcast(flat, src=src, group=group)
        out = [None] * len(leaves)
        _split(flat, idx, leaves, out)
        for i in idx:
            leaves[i].copy_(out[i])
    return tree


def all_gather_ints(values, group=None):
    """[world, len(values)] int64 numpy array of every rank's `values`,
    row r from rank r. Gloo gathers host tensors only, NCCL card ones."""
    device = "cpu"
    if dist.get_backend(group) == dist.Backend.NCCL:
        device = torch.device("cuda", torch.cuda.current_device())
    mine = torch.tensor(list(values), dtype=torch.int64, device=device)
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, mine, group=group)
    return torch.stack(rows).cpu().numpy().astype(np.int64)
