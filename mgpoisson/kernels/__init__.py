"""Kernel layer: the grid-point operations of the reference's L1
(OpenCL kernels `gpu.lua:37-202`, FFI loops `cpu-raw.lua:8-114`),
behind one interface implemented two ways:

- `mgpoisson.kernels.xla`    - pure jnp, rank-polymorphic (2D/3D), runs
  on every backend; XLA fuses the pad/shift stencils.
- `mgpoisson.kernels.hopper` - the 2D temporally blocked smoother as a
  Pallas kernel for NVIDIA GPUs (Triton route); every other op is
  XLA's.

`get_ops(spec, level_size)` is the one place that decides which a level
runs - the analog of the reference hybrid's cpuDepth switch
(`cpu-gpu.lua:17-52`): small grids are launch-bound, so the kernel only
takes levels at least `spec.pallas_min_size` wide.
"""

from __future__ import annotations

import jax

from mgpoisson.kernels import xla


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def get_ops(spec, level_size: int):
    """Return the op module to use for a level of side `level_size`.

    backend='xla' always gets XLA.  backend='pallas' asks for the
    kernel and fails off a GPU (the kernel has no compiled form
    elsewhere).  On a GPU both 'auto' and 'pallas' take the kernel for
    unsharded 2D levels of side >= spec.pallas_min_size whose dtype,
    smoother and sweep counts it was measured to win
    (`hopper.preferred`); every other level runs XLA."""
    if spec.backend == "xla":
        return xla
    if not on_gpu():
        if spec.backend == "pallas":
            raise ValueError("backend='pallas' needs a GPU; the platform "
                             f"is {jax.default_backend()!r}")
        return xla
    from mgpoisson.kernels import hopper
    if (spec.ndim != 2 or spec.mesh_shape is not None
            or level_size < spec.pallas_min_size
            or not all(hopper.preferred(spec.dtype,
                                        spec.smoother_resolved, nu)
                       for nu in (spec.nu_pre, spec.nu_post))):
        # Under a mesh the partitioner cannot split a pallas_call, and
        # shard/spmd.py runs its own per-shard XLA sweeps.
        return xla
    return hopper
