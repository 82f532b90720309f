"""Multi-host entry points (grids beyond one slice).

The reference is single-process/single-device; this is the scale-out
path SURVEY.md section 2.3 plans: `jax.distributed` across hosts, with
the same 2D mesh semantics - the fast links inside a host, the network
across hosts.

It has not run on more than one GPU host; kept thin and documented.
The mesh returned here plugs directly into MultigridPoisson(spec, mesh).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax

from mgpoisson.shard.mesh import mesh_shape_for


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed (no-op if already initialized or
    running single-process)."""
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError:
        pass  # already initialized


def global_mesh(mesh_shape: Optional[Tuple[int, int]] = None,
                axis_names: Sequence[str] = ("x", "y")) -> jax.sharding.Mesh:
    """Mesh over ALL global devices (every process's chips).

    Device order follows jax.devices(), which groups by process; a 2D
    factorization keeps each host's chips contiguous along one axis so
    halo exchanges mostly stay inside a host and only the mesh-axis
    seams cross the network.
    """
    devices = jax.devices()
    if mesh_shape is None:
        mesh_shape = mesh_shape_for(len(devices))
    import numpy as np
    return jax.sharding.Mesh(
        np.asarray(devices).reshape(mesh_shape), tuple(axis_names))


def make_global_array(local_np, mesh, spec_like=None):
    """Assemble a global jax.Array from per-process local blocks via
    jax.make_array_from_process_local_data.

    The partition matches the solver's layout (mgpoisson.shard.spmd):
    the first two array axes ride the ('x', 'y') mesh axes and any
    trailing axes stay local — so a 3D grid gets P('x', 'y', None).
    spec_like is unused (the rank comes from local_np) and kept only
    for call-site compatibility."""
    del spec_like
    from jax.sharding import NamedSharding, PartitionSpec as P
    ndim = local_np.ndim
    axes = ["x", "y"][:min(2, ndim)] + [None] * (ndim - 2)
    sharding = NamedSharding(mesh, P(*axes))
    return jax.make_array_from_process_local_data(sharding, local_np)
