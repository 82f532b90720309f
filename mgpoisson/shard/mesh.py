"""Device-mesh construction for domain-decomposed solves.

The reference is single-device (its only 'distribution' is the CPU/GPU
hybrid handoff, `cpu-gpu.lua:17-52`).  Here grid size scales by 2D
block sharding of the grid over a device mesh, with XLA collectives
between neighbouring blocks (SURVEY.md section 2.3 / section 5).  On
cards joined all to all the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np


def mesh_shape_for(n_devices: int, ndim: int = 2) -> Tuple[int, ...]:
    """Balanced 2-axis factorization of n_devices (e.g. 8 -> (4, 2)).

    The grid is sharded over 2 mesh axes regardless of ndim (3D grids
    shard their first two axes; the innermost stays contiguous).
    """
    best = (n_devices, 1)
    a = int(np.sqrt(n_devices))
    while a > 0:
        if n_devices % a == 0:
            b = n_devices // a
            best = (max(a, b), min(a, b))
            break
        a -= 1
    return best


def build_mesh(mesh_shape: Optional[Tuple[int, ...]] = None,
               axis_names: Sequence[str] = ("x", "y"),
               devices=None) -> jax.sharding.Mesh:
    """Build a Mesh; defaults to all devices in a balanced 2D shape."""
    devices = list(jax.devices()) if devices is None else list(devices)
    if mesh_shape is None:
        mesh_shape = mesh_shape_for(len(devices))
    n = int(np.prod(mesh_shape))
    if n > len(devices):
        raise ValueError(f"mesh {mesh_shape} needs {n} devices, "
                         f"have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(mesh_shape)
    return jax.sharding.Mesh(dev_array, tuple(axis_names))
