"""Problem / solver configuration.

The reference scatters tunables over class attributes (``smooth = 7``,
`cpu.lua:20`; ``epsilon = 1e-10``, `cpu.lua:21`; ``maxiter = 1000``,
`cpu.lua:22`; ``debug`` flags) and positional constructor args
(``(size, real, cpuDepth)``, `cpu-gpu.lua:61`).  Here everything lives in
one frozen dataclass so it can be closed over by ``jax.jit`` as static
configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# scheme -> (coarse-level bc, prolongation kind, default smoother,
#            default pre/post sweeps)
SCHEMES = {
    "reference": ("ghost0", "inject", "jacobi", 7),
    "tuned": ("face", "bilinear", "wjacobi", 3),
    "fast": ("face", "bilinear", "rbgs", 1),
}


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class Spec:
    """Static configuration for a multigrid Poisson solve.

    Attributes:
      size: grid side length; must be a power of two (the reference's
        hierarchy halves down to 1x1, `cpu-raw.lua:155-171`).
      ndim: 2 or 3 (reference is 2D only; 3D is a capability extension —
        BASELINE.json config 4).
      dtype: 'float32' | 'float64' | 'bfloat16'.  The reference prefers
        fp64 devices and falls back to fp32 (`gpu.lua:7-15,32`); f32 is
        the default, f64 is there for oracle-parity runs (it needs
        jax_enable_x64).
      sweep_dtype: optional narrower dtype for the V-cycle itself
        (mixed-precision iterative refinement).  When set and different
        from dtype, each solver step computes the true residual
        r = f - A psi in `dtype`, runs one full V-cycle on the error
        equation A e = r entirely in `sweep_dtype` (bf16 halves the
        HBM bytes per sweep — the sweeps are bandwidth-bound), and
        applies the correction in `dtype`.  Residuals and stopping
        metrics never leave `dtype`, so the refinement loop converges
        to `dtype` accuracy even though nearly all the work runs in
        bf16 — a pure-bf16 solve, by contrast, stalls immediately: the
        fine-level residual of a smoothed iterate is all cancellation
        below bf16's ~3 decimal digits.  Works on the single-device,
        gspmd, and explicit-spmd paths.
      scheme:
        'reference' — exact parity with the reference algorithm:
          zero-ghost Dirichlet at every level, constant-injection
          prolongation, rediscretized coarse operators, Jacobi 7+7
          (`cpu.lua:20,57,139,142-151`).  Converges, but its rate
          degrades with grid size — a property of the reference scheme
          itself (undamped Jacobi + misscaled coarse correction; see
          mgpoisson/oracle.py).
        'tuned' (default) — identical fine-level problem and fixed point
          (zero-ghost operator on the fine grid), but face-Dirichlet
          coarse operators, face-adapted bilinear prolongation, and
          damped Jacobi 3+3: level-independent V-cycle factor ~0.10
          (2D), <10 cycles to 1e-10 relative residual (the BASELINE.json
          north star).
        'fast' — same transfer operators as 'tuned' but red-black
          Gauss-Seidel 1+1: each sweep costs ~2 stencil passes yet the
          cycle COUNT collapses on spike-dominated starts at scale (the
          reference's point-charge problem converges to 1e-10 relative
          residual in 2 cycles at 4096^2 vs 9 for 'tuned'; see
          tools/tune_scheme.py).
          The collapse is a large-grid effect: r0 ~ ||f||*4/h^2, so
          the relative gate loosens as h shrinks (at 64^2 'fast' needs
          ~9 cycles).  Prefer 'tuned' for smooth broad-spectrum
          right-hand sides, where the wjacobi 3+3 rate is the proven
          level-independent one.
      smoother: 'auto' (scheme default) | 'jacobi' (undamped, the
        reference default, `cpu.lua:57`) | 'wjacobi' (damped Jacobi,
        omega = 2d/(2d+1) — the tuned default: the cheapest sweep with a
        level-independent rate (~0.10 at 3+3); prefer 'rbgs'
        to minimize cycle COUNT on spike-dominated starts — it needs
        fewer cycles but each sweep costs ~2x) | 'rbgs' (red-black
        Gauss-Seidel — the deterministic parallel form of the
        Gauss-Seidel the reference documents as racy on parallel
        hardware, `gpu.lua:61-62`).
      pre_smooth / post_smooth: smoother sweeps before/after coarse-grid
        correction; None = scheme default (reference: 7+7, `cpu.lua:20`).
      tol: convergence tolerance (`cpu.lua:21`).
      stop: 'update' — RMS of the iterate update, the reference's
        criterion (`cpu.lua:203`); 'residual' — relative true-residual
        norm ||r||/||r0||, the BASELINE.json metric.
      stop_check: how often the stopping metric is evaluated when
        stop='residual'.  'every' — exact ||r|| each cycle (one extra
        residual pass over the post-smooth iterate, fused by XLA into
        the up-leg's epilogue where it can).  'adaptive' —
        cycles whose *predicted* residual (last measured ||r|| times a
        learned per-cycle contraction factor) is far above tol skip the
        metric pass entirely; the exact norm is computed only when the
        prediction comes within a safety factor of tol or every
        ADAPTIVE_MAX_SKIP cycles (bounds both mis-prediction and NaN
        detection latency).  Stopping decisions use only MEASURED
        values, so the converged answer is identical; skipped entries
        in the error history hold the model's estimate.  Supported on
        the single-device, gspmd, and explicit-spmd paths; rejected
        under mixed-precision refinement (whose step computes the
        full-precision residual every cycle anyway).
      maxiter: outer V-cycle budget (`cpu.lua:22`).
      h: grid spacing at the finest level.  The reference uses 1/size
        (`cpu.lua:198`, `cpu-raw.lua:242`); its cl.obj variant uses
        1/(size+1) (`test/test-gpu-obj.lua:252`) — pass explicitly to
        reproduce that variant.
      cycle: 'v' (the reference's only cycle, named twoGrid) | 'w' | 'fmg'.
      backend: 'auto' | 'xla' | 'pallas'.  'auto' runs the Hopper
        smoother kernel (mgpoisson.kernels.hopper) on a GPU for the
        levels where it was measured faster - unsharded 2D f32 Jacobi
        and damped Jacobi with 3+ sweeps, side >= pallas_min_size - and
        XLA ops everywhere else (the hybrid variant's cpuDepth switch,
        `cpu-gpu.lua:17-52`, in another guise: small grids are
        launch-bound).  'pallas' is the same dispatch but fails off a
        GPU; 'xla' never uses the kernel.
      pallas_min_size: level side below which the kernel is not used
        (4096: at 2048^2 and below it measured no faster than XLA on an
        H100; PERF.md).
      coarse_size: side length of the coarsest level; the reference
        recurses to 1x1 and applies a single smoother step there
        (`cpu.lua:76-94`).
      mesh_shape: device mesh shape for sharded execution (None = single
        device).
      partition: how sharded execution is expressed — 'gspmd' (layout
        constraints per level; XLA's SPMD partitioner inserts the halo
        collectives), 'spmd' (explicit shard_map with hand-written
        ppermute halo exchange, one deep halo per smoothing phase,
        mgpoisson.shard.spmd), or 'auto' (the default: 'spmd' whenever
        the mesh has the ('x','y') axes its collectives address, else
        'gspmd').
      replicate_below: level side at or below which sharded execution
        switches to replicated arrays (the cpuDepth handoff reborn:
        coarse grids are collective-latency-bound; `test/test.lua:42`
        uses cpuDepth=3 i.e. 8x8).
    """

    size: int
    ndim: int = 2
    dtype: str = "float32"
    sweep_dtype: Optional[str] = None
    scheme: str = "tuned"
    smoother: str = "auto"
    pre_smooth: Optional[int] = None
    post_smooth: Optional[int] = None
    tol: float = 1e-10
    stop: str = "update"
    stop_check: str = "every"
    maxiter: int = 1000
    h: Optional[float] = None
    cycle: str = "v"
    backend: str = "auto"
    pallas_min_size: int = 4096
    coarse_size: int = 1
    mesh_shape: Optional[Tuple[int, ...]] = None
    partition: str = "auto"
    replicate_below: int = 64

    def __post_init__(self):
        if not _is_pow2(self.size):
            raise ValueError(f"size must be a power of two, got {self.size}")
        if self.ndim not in (2, 3):
            raise ValueError(f"ndim must be 2 or 3, got {self.ndim}")
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.smoother not in ("auto", "jacobi", "wjacobi", "rbgs",
                                 "gs_lex"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if self.smoother == "gs_lex" and self.mesh_shape is not None:
            # plain lexicographic GS is inherently sequential — exactly
            # the race the reference documents on parallel hardware
            # (`gpu.lua:61-62`); it exists for reference-trajectory
            # reproduction on the XLA/CPU path, not for sharded runs
            raise ValueError("smoother='gs_lex' is sequential; use "
                             "'rbgs' under a device mesh")
        if self.smoother == "gs_lex" and self.scheme != "reference":
            # gs_lex is ghost0-only (like the reference); the tuned
            # scheme's face-Dirichlet coarse levels would need a bc it
            # does not implement
            raise ValueError("smoother='gs_lex' requires "
                             "scheme='reference' (ghost0 bc only)")
        if self.cycle not in ("v", "w", "fmg"):
            raise ValueError(f"unknown cycle {self.cycle!r}")
        if self.stop not in ("update", "residual"):
            raise ValueError(f"unknown stop criterion {self.stop!r}")
        if self.stop_check not in ("every", "adaptive"):
            raise ValueError(f"unknown stop_check {self.stop_check!r}")
        if self.stop_check == "adaptive" and self.stop != "residual":
            raise ValueError("stop_check='adaptive' requires "
                             "stop='residual' (the update metric is a "
                             "byproduct of the cycle, never worth "
                             "skipping)")
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.partition not in ("auto", "gspmd", "spmd"):
            raise ValueError(f"unknown partition {self.partition!r}")
        if not _is_pow2(self.coarse_size) or self.coarse_size > self.size:
            raise ValueError(f"bad coarse_size {self.coarse_size}")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        if self.sweep_dtype not in (None, "float32", "float64", "bfloat16"):
            raise ValueError(f"unsupported sweep_dtype {self.sweep_dtype!r}")

    # ------------------------------------------------- resolved parameters

    @property
    def coarse_bc(self) -> str:
        return SCHEMES[self.scheme][0]

    @property
    def prolong_kind(self) -> str:
        return SCHEMES[self.scheme][1]

    @property
    def smoother_resolved(self) -> str:
        return SCHEMES[self.scheme][2] if self.smoother == "auto" else self.smoother

    @property
    def nu_pre(self) -> int:
        return SCHEMES[self.scheme][3] if self.pre_smooth is None else self.pre_smooth

    @property
    def nu_post(self) -> int:
        return SCHEMES[self.scheme][3] if self.post_smooth is None else self.post_smooth

    @property
    def fine_h(self) -> float:
        """Grid spacing at the finest level (reference: 1/size, `cpu.lua:198`)."""
        return self.h if self.h is not None else 1.0 / self.size

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.size,) * self.ndim

    def with_(self, **kw) -> "Spec":
        return dataclasses.replace(self, **kw)
