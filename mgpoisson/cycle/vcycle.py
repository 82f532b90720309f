"""Multigrid cycles as jit-compatible fixed-depth programs.

The reference's `twoGrid` is host-recursive with per-level buffers keyed
by side length (`cpu.lua:70-165`, `gpu.lua:296-346`).  Under jit the
recursion unrolls at trace time over the static level list — shapes
differ per level so a dynamic loop is impossible, and depth is only
log2(size) <= 14 stages (SURVEY.md section 7).

Rediscretized coarse operators: h doubles per level (`cpu.lua:139`).
The coarsest level gets a single smoother application (`cpu.lua:76-94`),
exact at 1x1.  The fine level always uses the reference's zero-ghost
operator (the problem definition); coarse-level bc and the prolongation
kind come from spec.scheme (see mgpoisson.oracle for the analysis).

Beyond the reference's V-cycle, `w_cycle` and `fmg` (full multigrid) are
provided — the standard stronger cycles.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp

from mgpoisson.kernels import get_ops

Trace = List[Tuple[str, int, jax.Array]]


def _cycle(u, f, h, spec, gamma: int, fine_level: bool, trace: Optional[Trace],
           constrain=None, rnorm: bool = False):
    """gamma=1 -> V-cycle, gamma=2 -> W-cycle.  `constrain` (from
    mgpoisson.shard.gspmd.make_constrain) applies the level-dependent
    sharding layout at each level transition.

    rnorm (fine level only): additionally return sum(r^2) of the
    result, computed inside the same jitted program as the up-leg so
    XLA can fuse it into the up-leg's epilogue.

    u=None means u IS IDENTICALLY ZERO (every coarse V-cycle entry):
    the down-leg starts from zeros that XLA folds into the first sweep
    (the values are the same either way, so iterates are unchanged)."""
    n = f.shape[0]
    ops = get_ops(spec, n)
    bc = "ghost0" if fine_level else spec.coarse_bc
    smoother = spec.smoother_resolved
    rnorm = rnorm and fine_level

    def rec(name, arr):
        if trace is not None:
            trace.append((name, arr.shape[0], arr))

    if n <= spec.coarse_size:
        rec("f", f)
        if u is None:
            u = jnp.zeros_like(f)
        u = ops.coarse_solve(u, f, h, smoother, bc)
        rec("u", u)
        if rnorm:
            from mgpoisson.kernels import xla as _xla
            return u, _xla.residual_sq_sum(u, f, h)
        return u

    if trace is not None:
        # granular path with per-stage snapshots (the reference's debug
        # dump mode, `cpu-raw.lua:126-140`)
        if u is None:
            u = jnp.zeros_like(f)
        u = ops.smooth(u, f, h, spec.nu_pre, smoother, bc)
        rec("u_pre", u)
        R = ops.residual_restrict(u, f, h, bc)
        rec("r", ops.residual(u, f, h, bc))
        rec("R", R)
    elif u is None:
        u, R = ops.smooth_residual_restrict_zero(f, h, spec.nu_pre,
                                                 smoother, bc)
    else:
        u, R = ops.smooth_residual_restrict(u, f, h, spec.nu_pre,
                                            smoother, bc)
    if constrain is not None:
        R = constrain(R)

    # first coarse visit starts from V=0 (from-zero down-leg); a
    # W-cycle's second visit carries the first's result
    V = _cycle(None, R, 2 * h, spec, gamma, False, trace, constrain)
    for _ in range(gamma - 1):
        V = _cycle(V, R, 2 * h, spec, gamma, False, trace, constrain)
    rec("V", V)

    r2 = None
    if trace is not None:
        u = ops.prolong_correct(u, V, spec.prolong_kind)
        rec("v", ops.prolong(V, spec.prolong_kind))
        rec("u_corr", u)
        u = ops.smooth(u, f, h, spec.nu_post, smoother, bc)
    elif rnorm:
        u, r2 = ops.prolong_correct_smooth_rnorm(
            u, f, V, h, spec.nu_post, smoother, bc, spec.prolong_kind)
    else:
        u = ops.prolong_correct_smooth(u, f, V, h, spec.nu_post,
                                       smoother, bc, spec.prolong_kind)
    if constrain is not None:
        u = constrain(u)
    rec("u_post", u)
    if rnorm:
        if r2 is None:     # trace path: separate pass, correctness only
            from mgpoisson.kernels import xla as _xla
            r2 = _xla.residual_sq_sum(u, f, h)
        return u, r2
    return u


def v_cycle(u, f, h, spec, trace: Optional[Trace] = None, constrain=None):
    """One V-cycle — the reference's twoGrid (`cpu.lua:70-165`)."""
    return _cycle(u, f, h, spec, gamma=1, fine_level=True, trace=trace,
                  constrain=constrain)


def v_cycle_rnorm(u, f, h, spec, constrain=None):
    """One V-cycle returning (u, sum(r^2)) with the squared residual
    norm fused into the fine-level up-leg (free stop='residual')."""
    return _cycle(u, f, h, spec, gamma=1, fine_level=True, trace=None,
                  constrain=constrain, rnorm=True)


def w_cycle(u, f, h, spec, trace: Optional[Trace] = None, constrain=None):
    """One W-cycle (two coarse-grid visits per level)."""
    return _cycle(u, f, h, spec, gamma=2, fine_level=True, trace=trace,
                  constrain=constrain)


def fmg(f, h, spec, n_vcycles: int = 1, constrain=None):
    """Full multigrid: solve coarsest first, prolong up, V-cycle(s) per
    level.  Reaches discretization accuracy in one O(N) pass.

    `constrain` (mgpoisson.shard.gspmd.make_constrain) pins the
    level-dependent sharding layout at every level transition of the
    FMG pass itself — without it the pass's intermediates are left to
    XLA's layout whims under a mesh while the V-cycle loop is
    constrained."""
    c = (lambda x: x) if constrain is None else constrain
    fs = [c(f)]
    while fs[-1].shape[0] > spec.coarse_size:
        fs.append(c(get_ops(spec, fs[-1].shape[0]).restrict(fs[-1])))
    hs = [h * (2 ** i) for i in range(len(fs))]

    u = jnp.zeros_like(fs[-1])
    bc = "ghost0" if len(fs) == 1 else spec.coarse_bc
    u = c(get_ops(spec, u.shape[0]).coarse_solve(
        u, fs[-1], hs[-1], spec.smoother_resolved, bc))
    for lvl in range(len(fs) - 2, -1, -1):
        u = c(get_ops(spec, fs[lvl].shape[0]).prolong(u, spec.prolong_kind))
        for _ in range(n_vcycles):
            u = _cycle(u, fs[lvl], hs[lvl], spec, 1, lvl == 0, None,
                       constrain=constrain)
    return u


def make_cycle(spec, constrain=None, rnorm: bool = False):
    """Return the per-step cycle function selected by spec.cycle,
    signature (u, f, h) -> u, or (u, f, h) -> (u, sum(r^2)) with
    rnorm=True (residual norm fused into the fine up-leg).  'fmg'
    iterates V-cycles after the FMG initialization pass the solver
    applies (see MultigridPoisson)."""
    gamma = {"v": 1, "fmg": 1, "w": 2}.get(spec.cycle)
    if gamma is None:
        raise ValueError(f"unknown cycle {spec.cycle!r}")
    return lambda u, f, h: _cycle(u, f, h, spec, gamma=gamma,
                                  fine_level=True, trace=None,
                                  constrain=constrain, rnorm=rnorm)
