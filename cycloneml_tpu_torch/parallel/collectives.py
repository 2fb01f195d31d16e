"""``tree_aggregate`` — the treeAggregate replacement of the port.

The port's counterpart of ``cycloneml_tpu/parallel/collectives.py:
tree_aggregate``: a per-shard call of ``fn`` over the row shards of the
dataset's arrays, then a sum of the partials over the data shards in a
fixed (shard) order, so a reduction is deterministic. On this slice's
one-device mesh the sum has one term; the hierarchical replica/data
reduction over ``torch.distributed`` (``cyclone.treeAggregate.depth``) is
ROADMAP slice 8.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from cycloneml_tpu_torch.mesh import MeshRuntime


def _sum_trees(parts: List):
    """Sum pytrees (dicts/tuples of tensors) elementwise, in list order."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _sum_trees([p[k] for p in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_sum_trees([p[i] for p in parts])
                           for i in range(len(first)))
    total = first
    for p in parts[1:]:
        total = total + p
    return total


def tree_aggregate(fn: Callable, runtime: MeshRuntime, *arrays: torch.Tensor,
                   auto_psum: bool = True):
    """Aggregate ``fn(local_rows..., extras...) -> pytree`` over row-sharded
    arrays.

    ``arrays`` fixes how many leading arguments are row-sharded; the
    returned callable takes ``(*arrays, *extras)``. ``fn`` sees each
    shard's rows plus the (replicated) extras and returns a pytree of
    partial sums, which are summed over the shards. With
    ``auto_psum=False`` ``fn``'s partial is returned as it is, which is
    only defined on a one-shard mesh (``fn``'s own max/min combines across
    devices come with the multi-device runtime, ROADMAP slice 8).
    """
    n_sharded = len(arrays)

    def call(*args):
        sharded, extras = args[:n_sharded], args[n_sharded:]
        blocks = [runtime.row_shards(a) for a in sharded]
        parts = [fn(*[b[i] for b in blocks], *extras)
                 for i in range(runtime.data_parallelism)]
        if not auto_psum and len(parts) != 1:
            raise NotImplementedError(
                "tree_aggregate(auto_psum=False) over several shards is "
                "ROADMAP slice 8")
        return _sum_trees(parts)

    return call


def tree_aggregate_with_state(fn: Callable, runtime: MeshRuntime,
                              *arrays: torch.Tensor):
    """:func:`tree_aggregate` for an ``fn`` that returns ``(stats, rows)``:
    the stats pytree is summed over the shards in shard order, the
    per-row state stays row-sharded (the shards' rows concatenated in
    shard order, the shard itself on this one-shard mesh). The reference's
    ``tree_aggregate(..., with_state=True)`` (its ``:375``); BisectingKMeans'
    level program carries each row's new tree node this way."""
    n_sharded = len(arrays)

    def call(*args):
        sharded, extras = args[:n_sharded], args[n_sharded:]
        blocks = [runtime.row_shards(a) for a in sharded]
        parts = [fn(*[b[i] for b in blocks], *extras)
                 for i in range(runtime.data_parallelism)]
        return (_sum_trees([p[0] for p in parts]),
                _cat_trees([p[1] for p in parts]))

    return call


def _cat_trees(parts: List):
    """Concatenate the shards' row-state pytrees (tuples of tensors, or
    tensors) along the rows, in list order."""
    first = parts[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_cat_trees([p[i] for p in parts])
                           for i in range(len(first)))
    return first if len(parts) == 1 else torch.cat(parts)
