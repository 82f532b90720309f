"""mgpoisson — geometric multigrid Poisson solver in JAX.

A JAX/XLA/Pallas framework with the capabilities of
thenumbernine/lua-multigrid-poisson: a cell-centered geometric-multigrid
solver for the Poisson equation ``del^2 u = f`` on power-of-two grids
(reference `cpu.lua:1-9`), running on NVIDIA GPUs (and on the CPU for
tests):

- fixed-depth jit-compatible V-cycle over a static level pytree
  (the reference's host-recursive ``twoGrid``, `cpu.lua:70-165`)
- Jacobi and red-black Gauss-Seidel smoothers as XLA-fused stencils,
  with a temporally blocked Pallas smoother for Hopper on the fine
  levels where it is faster (reference OpenCL kernels, `gpu.lua:61-102`)
- 4-cell full-weighting restriction / constant-injection prolongation
  (`gpu.lua:126-161`)
- on-device RMS-update and residual-norm reductions (the reference sums
  on host, `gpu.lua:361-369`)
- 2D/3D, f32/f64, sharded execution over a device mesh with halo
  exchange, switching to replicated coarse levels (the hybrid CPU/GPU
  ``cpuDepth`` handoff reborn, `cpu-gpu.lua:17-52`)
- a multigrid-vs-Krylov convergence harness as the correctness gate
  (`test/converge-multigrid-vs-krylov.lua`)
"""

from mgpoisson.core.spec import Spec
from mgpoisson.core.rhs import point_charge_rhs, initial_guess
from mgpoisson.solver.multigrid import MultigridPoisson, SolveResult

__version__ = "0.1.0"

__all__ = [
    "Spec",
    "point_charge_rhs",
    "initial_guess",
    "MultigridPoisson",
    "SolveResult",
]
