"""GSPMD sharding of the multigrid hierarchy.

Layout policy (SURVEY.md section 2.3):
- fine levels: 2D block sharding over the ('x','y') mesh axes; XLA's
  SPMD partitioner turns the stencil pad/shift ops into one-cell halo
  exchanges (collective-permutes) between neighbouring devices.
- levels at or below spec.replicate_below: fully replicated — every
  device redundantly computes the tiny coarse subtree, avoiding
  collective latency.  This is the reference hybrid's cpuDepth
  handoff reborn (`cpu-gpu.lua:17-52`): the reference moves
  small grids to the CPU because they are launch-latency-bound on GPU;
  here they are collective-latency-bound when sharded.

The transition happens naturally at the restrict/prolong ops under a
single jit: XLA inserts an all-gather on the way down and re-partitions
on the way up.
"""

from __future__ import annotations

from typing import Callable

import jax
from jax.sharding import NamedSharding, PartitionSpec as P


def level_partition_spec(side: int, ndim: int, mesh: jax.sharding.Mesh,
                         replicate_below: int) -> P:
    """PartitionSpec for a level array of the given side length."""
    mx = mesh.shape.get("x", 1)
    my = mesh.shape.get("y", 1)
    # shard only if every device row/col gets at least 2 cells and the
    # side divides evenly (power-of-two sides and meshes always do)
    if (side > replicate_below and side % mx == 0 and side % my == 0
            and side // mx >= 2 and side // my >= 2):
        axes = ("x", "y") + (None,) * (ndim - 2)
        return P(*axes)
    return P(*(None,) * ndim)


def make_constrain(mesh: jax.sharding.Mesh, spec) -> Callable:
    """Return constrain(arr) applying the level-dependent layout."""

    def constrain(arr: jax.Array) -> jax.Array:
        ps = level_partition_spec(arr.shape[0], arr.ndim, mesh,
                                  spec.replicate_below)
        return jax.lax.with_sharding_constraint(
            arr, NamedSharding(mesh, ps))

    return constrain
