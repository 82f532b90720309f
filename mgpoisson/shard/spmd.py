"""Explicit SPMD multigrid: shard_map + ppermute halo exchange.

The hand-scheduled counterpart to the GSPMD path (mgpoisson.shard.gspmd):
the whole V-cycle runs inside one `jax.shard_map` over a 2D ('x','y')
mesh, with the communication written out explicitly —

- deep-halo exchange per smoother PHASE: one radius*nu-deep
  `jax.lax.ppermute` neighbor shift per phase (f exchanged once per
  level), halo cells recomputed locally - the deep-halo trapezoid of
  docs/KERNELS.md applied across devices.  Same lines cross the
  interconnect as with a per-sweep exchange, in 1/nu the messages,
  which is what counts in the latency-bound small-halo regime; the
  residual keeps its own 1-cell exchange.  Non-wrapping permutes
  deliver zeros to edge devices,
  which IS the reference's zero-ghost Dirichlet boundary
  (`cpu.lua:28-31`) — the boundary condition falls out of the
  collective's semantics.  Face-Dirichlet (tuned scheme's coarse
  levels) overrides the received halo with -edge on boundary devices.
- restriction and injection prolongation are halo-free (local 2^ndim
  blocks); bilinear prolongation exchanges one coarse halo cell per
  sharded axis.
- below spec.replicate_below the level is all-gathered and every device
  redundantly computes the coarse subtree, then slices its shard back —
  the reference hybrid's cpuDepth handoff (`cpu-gpu.lua:17-52`) reborn:
  tiny grids are collective-latency-bound, so stop communicating.
- error reductions are local sums + psum.

Every per-shard op is XLA's: inside `shard_map` each device runs its
block's stencils as ordinary fused XLA ops.

Rank-polymorphic: 2D grids shard both axes; 3D grids shard axes 0 and 1
over the same ('x','y') mesh with axis 2 kept local (contiguous lanes).
Both schemes and all smoothers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from mgpoisson.cycle.vcycle import _cycle as _replicated_cycle
from mgpoisson.kernels import xla


# mesh axis name per sharded array axis; array axes >= 2 are local
_AXIS_NAMES = ("x", "y")


def _edge(u, ax, side):
    """One-cell-thick boundary slice of u along ax ('lo' or 'hi')."""
    idx = [slice(None)] * u.ndim
    idx[ax] = slice(0, 1) if side == "lo" else slice(-1, None)
    return u[tuple(idx)]


def _build_parts(spec, mesh):
    """Shared closures for the explicit-SPMD step and FMG entry points."""
    # cycle='fmg' means the FMG pass initializes (see build_spmd_fmg);
    # the per-step cycle is then a V-cycle, like make_cycle's mapping
    gamma = 2 if spec.cycle == "w" else 1
    mesh_sizes = {"x": mesh.shape["x"], "y": mesh.shape["y"]}
    ndim = spec.ndim
    sharded_axes = list(range(min(2, ndim)))
    h0 = spec.fine_h
    smoother = spec.smoother_resolved

    def shift(x, axis_name, direction):
        """Neighbor transfer along a mesh axis; zeros arrive at the
        global boundary (non-wrapping permute == zero-ghost bc)."""
        n = mesh_sizes[axis_name]
        if n == 1:
            return jnp.zeros_like(x)
        if direction > 0:      # receive from the lower-index neighbor
            perm = [(i, i + 1) for i in range(n - 1)]
        else:
            perm = [(i + 1, i) for i in range(n - 1)]
        return jax.lax.ppermute(x, axis_name, perm)

    def axis_halos(u, ax, bc):
        """(lo_halo, hi_halo) line pair for array axis ax."""
        if ax in sharded_axes:
            name = _AXIS_NAMES[ax]
            lo = shift(_edge(u, ax, "hi"), name, +1)
            hi = shift(_edge(u, ax, "lo"), name, -1)
            if bc == "face":
                aidx = jax.lax.axis_index(name)
                lo = jnp.where(aidx == 0, -_edge(u, ax, "lo"), lo)
                hi = jnp.where(aidx == mesh_sizes[name] - 1,
                               -_edge(u, ax, "hi"), hi)
            return lo, hi
        # local axis: the global boundary is in-block
        if bc == "face":
            return -_edge(u, ax, "lo"), -_edge(u, ax, "hi")
        z = jnp.zeros_like(_edge(u, ax, "lo"))
        return z, z

    def nbr(u, bc):
        s = None
        for ax in range(ndim):
            lo, hi = axis_halos(u, ax, bc)
            idx_lo = [slice(None)] * ndim
            idx_lo[ax] = slice(None, -1)
            idx_hi = [slice(None)] * ndim
            idx_hi[ax] = slice(1, None)
            up = jnp.concatenate([lo, u[tuple(idx_lo)]], axis=ax)
            dn = jnp.concatenate([u[tuple(idx_hi)], hi], axis=ax)
            term = up + dn
            s = term if s is None else s + term
        return s

    def sweep(u, f, h, bc):
        hsq = h * h
        adiag = -2.0 * ndim / hsq
        if smoother == "jacobi":
            return (f - nbr(u, bc) / hsq) / adiag
        if smoother == "wjacobi":
            omega = 2.0 * ndim / (2.0 * ndim + 1.0)
            return u + omega * ((f - nbr(u, bc) / hsq) / adiag - u)
        # red-black: local sizes are even, so local parity == global parity
        parity = jax.lax.broadcasted_iota(jnp.int32, u.shape, 0)
        for ax in range(1, ndim):
            parity = parity + jax.lax.broadcasted_iota(jnp.int32, u.shape, ax)
        parity = parity % 2
        for p in (0, 1):
            upd = (f - nbr(u, bc) / hsq) / adiag
            u = jnp.where(parity == p, upd, u)
        return u

    # ---------------- deep-halo smoothing phase (comm aggregation) ----
    # One r-deep halo exchange per smooth PHASE instead of a 1-cell
    # exchange per sweep (r = per-sweep dependency radius x nu): the
    # same total lines cross the interconnect, but in one message per
    # neighbor per phase instead of nu.  Halo cells are recomputed
    # redundantly and lose one ring of exactness per sweep; values are
    # bit-identical to the per-sweep exchange (same stencil on the same
    # neighbor data).

    def _lines(u, ax, side, r):
        idx = [slice(None)] * u.ndim
        idx[ax] = slice(0, r) if side == "lo" else slice(-r, None)
        return u[tuple(idx)]

    def deep_halos(u, r):
        """Extend u with r-deep neighbor halos along every sharded axis
        (sequential per-axis extension carries the corners); zeros
        arrive at global edges (non-wrapping ppermute)."""
        for ax in sharded_axes:
            name = _AXIS_NAMES[ax]
            lo = shift(_lines(u, ax, "hi", r), name, +1)
            hi = shift(_lines(u, ax, "lo", r), name, -1)
            u = jnp.concatenate([lo, u, hi], axis=ax)
        return u

    def fix_ghost(ue, r, bc):
        """Per-sweep global-boundary fixup on an r-extended block: on
        edge devices the halo region lies OUTSIDE the grid and must
        hold boundary data every sweep (ghost0: zeros; face: the
        adjacent line = -edge)."""
        for ax in sharded_axes:
            name = _AXIS_NAMES[ax]
            aidx = jax.lax.axis_index(name)
            first = aidx == 0
            last = aidx == mesh_sizes[name] - 1
            n_ax = ue.shape[ax]
            shape = [1] * ue.ndim
            shape[ax] = n_ax
            idx = jax.lax.iota(jnp.int32, n_ax).reshape(shape)
            if bc == "ghost0":
                ue = jnp.where(first & (idx < r), 0.0, ue)
                ue = jnp.where(last & (idx >= n_ax - r), 0.0, ue)
            else:  # face: ghost = -edge on the adjacent line, 0 beyond
                sl = [slice(None)] * ue.ndim
                sl[ax] = slice(r, r + 1)
                lo_edge = ue[tuple(sl)]
                sl[ax] = slice(n_ax - r - 1, n_ax - r)
                hi_edge = ue[tuple(sl)]
                ue = jnp.where(first & (idx == r - 1), -lo_edge, ue)
                ue = jnp.where(first & (idx < r - 1), 0.0, ue)
                ue = jnp.where(last & (idx == n_ax - r), -hi_edge, ue)
                ue = jnp.where(last & (idx > n_ax - r), 0.0, ue)
        return ue

    def _center(ue, r):
        idx = tuple(slice(r, -r) if ax in sharded_axes else slice(None)
                    for ax in range(ue.ndim))
        return ue[idx]

    def _shrink(xe, d):
        """Trim d halo lines off each sharded axis of an extended block."""
        if d == 0:
            return xe
        idx = tuple(slice(d, -d) if ax in sharded_axes else slice(None)
                    for ax in range(xe.ndim))
        return xe[idx]

    def _deep_ok(u, r):
        """Can a depth-r halo be taken from the immediate neighbors?"""
        min_local = min(u.shape[ax] for ax in sharded_axes)
        return r <= min_local and not all(
            mesh_sizes[_AXIS_NAMES[ax]] == 1 for ax in sharded_axes)

    _RADIUS = 2 if smoother == "rbgs" else 1

    def smooth_phase(u, f, h, nu, bc, fe=None, fe_r=0):
        """nu sweeps with ONE halo exchange (falls back to per-sweep
        exchange when the halo depth would exceed the local block).

        fe/fe_r: optionally a pre-extended RHS block with fe_r-deep
        halos — f is level-invariant, so the caller exchanges it once
        per level and both smooth phases slice from it."""
        if nu == 0:
            return u
        r = _RADIUS * nu
        if not _deep_ok(u, r):
            for _ in range(nu):
                u = sweep(u, f, h, bc)
            return u
        ue = deep_halos(u, r)
        fe = deep_halos(f, r) if fe is None or fe_r < r \
            else _shrink(fe, fe_r - r)

        # local neighbor sum on the extended block: value-edge zeros on
        # SHARDED axes (that is halo degradation, not a bc), the real
        # bc on LOCAL axes (their global boundary is in-block)
        def nbr_ext(x):
            s = xla.neighbor_sum(x, "ghost0")
            if bc == "face":
                for ax in range(ndim):
                    if ax in sharded_axes:
                        continue
                    first = tuple(slice(None) if a != ax else slice(0, 1)
                                  for a in range(ndim))
                    last = tuple(slice(None) if a != ax else
                                 slice(-1, None) for a in range(ndim))
                    s = s.at[first].add(-x[first])
                    s = s.at[last].add(-x[last])
            return s

        hsq = h * h
        adiag = -2.0 * ndim / hsq
        # sharded-axis real BCs applied by fix_ghost per sweep (and per
        # rbgs color); rbgs parity is preserved because r is even for
        # rbgs and the local origin shifts by r per sharded axis
        if smoother == "rbgs":
            parity = jax.lax.broadcasted_iota(jnp.int32, ue.shape, 0)
            for ax in range(1, ndim):
                parity = parity + jax.lax.broadcasted_iota(
                    jnp.int32, ue.shape, ax)
            parity = parity % 2
            for _ in range(nu):
                for p in (0, 1):
                    # ghosts must hold boundary data before EACH color:
                    # the second color's boundary cells read ghosts the
                    # first color just overwrote
                    ue = fix_ghost(ue, r, bc)
                    upd = (fe - nbr_ext(ue) / hsq) / adiag
                    ue = jnp.where(parity == p, upd, ue)
        else:
            omega = 2.0 * ndim / (2.0 * ndim + 1.0)
            for _ in range(nu):
                ue = fix_ghost(ue, r, bc)
                jac = (fe - nbr_ext(ue) / hsq) / adiag
                ue = jac if smoother == "jacobi" \
                    else ue + omega * (jac - ue)
        return _center(ue, r)

    def residual(u, f, h, bc):
        hsq = h * h
        return f - (nbr(u, bc) / hsq + (-2.0 * ndim / hsq) * u)

    def prolong_correct(u, V, kind):
        if kind == "inject":
            v = V
            for ax in range(ndim):
                v = jnp.repeat(v, 2, axis=ax)
            return u + v
        # bilinear with face-adapted global-edge weights: fine-space
        # blend per axis (see kernels/xla.py); the +-2 fine shift needs
        # the neighbor's edge coarse line, fetched with one ppermute on
        # sharded axes (zero-filled on local axes / at global edges)
        v = V
        for ax in range(ndim):
            R = jnp.repeat(v, 2, axis=ax)
            lo_h, hi_h = axis_halos(v, ax, "ghost0")
            lo_h = jnp.repeat(lo_h, 2, axis=ax)   # 2 fine halo lines
            hi_h = jnp.repeat(hi_h, 2, axis=ax)
            idx_m = [slice(None)] * ndim
            idx_m[ax] = slice(None, -2)
            idx_p = [slice(None)] * ndim
            idx_p[ax] = slice(2, None)
            Rm = jnp.concatenate([lo_h, R[tuple(idx_m)]], axis=ax)
            Rp = jnp.concatenate([R[tuple(idx_p)], hi_h], axis=ax)
            idx = jax.lax.broadcasted_iota(jnp.int32, R.shape, ax)
            out = 0.75 * R + 0.25 * jnp.where(idx % 2 == 0, Rm, Rp)
            nloc = R.shape[ax]
            if ax in sharded_axes:
                name = _AXIS_NAMES[ax]
                aidx = jax.lax.axis_index(name)
                first = (aidx == 0) & (idx == 0)
                last = (aidx == mesh_sizes[name] - 1) & (idx == nloc - 1)
            else:
                first = idx == 0
                last = idx == nloc - 1
            v = jnp.where(first | last, 0.5 * R, out)
        return u + v

    def gather_full(x):
        full = jax.lax.all_gather(x, "x", axis=0, tiled=True)
        if 1 in sharded_axes:
            full = jax.lax.all_gather(full, "y", axis=1, tiled=True)
        return full

    def slice_local(full, local_shape):
        starts = [jnp.int32(0)] * ndim
        starts[0] = jax.lax.axis_index("x") * local_shape[0]
        if 1 in sharded_axes:
            starts[1] = jax.lax.axis_index("y") * local_shape[1]
        return jax.lax.dynamic_slice(full, tuple(starts), local_shape)

    def shardable(g):
        # every device keeps an even block of at least 2 cells per axis
        for name in ("x", "y"):
            m = mesh_sizes[name]
            if g % m != 0 or g // m < 2 or (g // m) % 2 != 0:
                return False
        return True

    def cycle(u, f, h, global_size, fine_level):
        bc = "ghost0" if fine_level else spec.coarse_bc

        if global_size <= spec.replicate_below \
                or not shardable(global_size // 2):
            # replicated handoff: gather once, run the remaining subtree
            # redundantly on every device, slice back
            u_full = gather_full(u)
            f_full = gather_full(f)
            u_full = _replicated_cycle(u_full, f_full, h, spec, gamma,
                                       fine_level, None)
            return slice_local(u_full, u.shape)

        # exchange the level-invariant RHS halo ONCE for both phases
        rmax = _RADIUS * max(spec.nu_pre, spec.nu_post)
        fe = deep_halos(f, rmax) \
            if rmax > 0 and _deep_ok(u, rmax) else None
        u = smooth_phase(u, f, h, spec.nu_pre, bc, fe, rmax)
        R = xla.restrict(residual(u, f, h, bc))   # local 2^ndim blocks
        V = jnp.zeros_like(R)
        for _ in range(gamma):
            V = cycle(V, R, 2 * h, global_size // 2, False)
        u = prolong_correct(u, V, spec.prolong_kind)
        return smooth_phase(u, f, h, spec.nu_post, bc, fe, rmax)

    def local_r2(psi, f):
        """LOCAL sum of squared fine-level residuals, accumulated in at
        least f32 and never below the solve dtype."""
        r = residual(psi, f, h0, "ghost0")
        r = r.astype(jnp.promote_types(r.dtype, jnp.float32))
        return jnp.sum(r * r)

    def step_local(psi, f):
        """Returns (psi_new, rms_update, residual_norm) — the solver
        picks the stopping metric.  Only the metric spec.stop selects
        is computed (spec.stop is static at build time); the other slot
        is a zero scalar, so stop='update' never pays the extra
        full-grid residual pass and stop='residual' never pays the
        update reduction."""
        zero = jnp.zeros((), psi.dtype)
        if spec.stop == "update":
            psi_new = cycle(psi, f, h0, spec.size, True)
            d = psi_new - psi
            sq = jax.lax.psum(jnp.sum(d * d), ("x", "y"))
            err_upd = jnp.sqrt(sq / (spec.size ** ndim))
            rn = zero
        else:
            psi_new = cycle(psi, f, h0, spec.size, True)
            err_upd = zero
            rn = jnp.sqrt(jax.lax.psum(local_r2(psi_new, f),
                                       ("x", "y"))).astype(psi.dtype)
        return psi_new, err_upd, rn

    # -------- mixed-precision refinement step (spec.sweep_dtype) ------
    sweep_dt = None
    if spec.sweep_dtype is not None and \
            jnp.dtype(spec.sweep_dtype) != jnp.dtype(spec.dtype):
        sweep_dt = jnp.dtype(spec.sweep_dtype)

    def step_mixed_local(psi, f):
        """Iterative-refinement step under the explicit partition (the
        shard-local twin of solver/multigrid.py's gspmd mixed step):
        the V-cycle runs on the error equation A e = r entirely in
        sweep_dtype while the residual, correction, and stopping
        metric stay in dtype.  All extra work is elementwise plus the one halo exchange `residual`
        already performs.  With stop='residual' the reported err is
        ||r|| of the INCOMING iterate (same convention as the gspmd
        path: the residual is in hand before the correction)."""
        zero = jnp.zeros((), psi.dtype)
        r = residual(psi, f, h0, "ghost0")
        e = cycle(jnp.zeros(r.shape, sweep_dt), r.astype(sweep_dt),
                  h0, spec.size, True)
        psi_new = psi + e.astype(psi.dtype)
        if spec.stop == "residual":
            acc = jnp.promote_types(psi.dtype, jnp.float32)
            ra = r.astype(acc)
            rn = jnp.sqrt(jax.lax.psum(jnp.sum(ra * ra), ("x", "y"))
                          ).astype(psi.dtype)
            err_upd = zero
        else:
            d = psi_new - psi
            sq = jax.lax.psum(jnp.sum(d * d), ("x", "y"))
            err_upd = jnp.sqrt(sq / (spec.size ** ndim))
            rn = zero
        return psi_new, err_upd, rn

    # -------- bare cycles for the adaptive solve loop ------------------
    def cycle_plain_local(psi, f):
        return cycle(psi, f, h0, spec.size, True)

    def cycle_rnorm_local(psi, f):
        psi_new = cycle(psi, f, h0, spec.size, True)
        return psi_new, jax.lax.psum(local_r2(psi_new, f), ("x", "y"))

    def fmg_local(f):
        """Full-multigrid initialization (`cycle/vcycle.py::fmg`) under
        the explicit partition: restrict f shard-locally down to the
        replicated-handoff level, gather once, finish the down sweep and
        coarse solve replicated, then prolong back up — slicing local at
        the handoff — with one sharded V-cycle per sharded level."""
        # down sweep: (f_block, h, global_size, sharded?) finest first
        g, h, cur = spec.size, h0, f
        shd = g > spec.replicate_below and shardable(g)
        if not shd:
            cur = gather_full(cur)
        levels = [(cur, h, g, shd)]
        while g > spec.coarse_size:
            gn = g // 2
            if shd and (gn <= spec.replicate_below or not shardable(gn)):
                cur = gather_full(cur)
                shd = False
            cur = xla.restrict(cur)            # local 2^ndim blocks
            g, h = gn, 2 * h
            levels.append((cur, h, g, shd))

        fL, hL, gL, shdL = levels[-1]
        if shdL:                                # only if size == coarse_size
            fL = gather_full(fL)
        bcL = "ghost0" if len(levels) == 1 else spec.coarse_bc
        u = xla.coarse_solve(jnp.zeros_like(fL), fL, hL, smoother, bcL)
        if shdL:
            u = slice_local(u, levels[-1][0].shape)

        for lvl in range(len(levels) - 2, -1, -1):
            f_l, h_l, g_l, shd_l = levels[lvl]
            shd_child = levels[lvl + 1][3]
            if shd_l and not shd_child:
                # replicated -> sharded handoff: prolong the full coarse
                # solution, then keep only this device's block
                u = xla.prolong(u, spec.prolong_kind)
                u = slice_local(u, f_l.shape)
            elif shd_l:
                u = prolong_correct(jnp.zeros_like(f_l), u,
                                    spec.prolong_kind)
            else:
                u = xla.prolong(u, spec.prolong_kind)
            fine = lvl == 0
            if shd_l:
                u = cycle(u, f_l, h_l, g_l, fine)
            else:
                u = _replicated_cycle(u, f_l, h_l, spec, 1, fine, None)
        if not levels[0][3]:
            # finest level ran replicated (size <= replicate_below or
            # unshardable on this mesh): u is the FULL grid here, but
            # the shard_map out_spec expects this device's local block
            u = slice_local(u, f.shape)
        return u

    pspec = P(*(_AXIS_NAMES[ax] for ax in sharded_axes),
              *([None] * (ndim - len(sharded_axes))))
    return {"step_local": step_local, "fmg_local": fmg_local,
            "step_mixed_local": step_mixed_local,
            "cycle_plain_local": cycle_plain_local,
            "cycle_rnorm_local": cycle_rnorm_local,
            "pspec": pspec}


def build_spmd_step(spec, mesh, mixed: bool = False):
    """step(psi, f) -> (psi_new, rms_update, residual_norm) with the
    whole V-cycle inside one shard_map.  mixed=True selects the
    sweep_dtype iterative-refinement step (spec.sweep_dtype set)."""
    parts = _build_parts(spec, mesh)
    pspec = parts["pspec"]
    fn = parts["step_mixed_local"] if mixed else parts["step_local"]
    return jax.shard_map(fn, mesh=mesh,
                         in_specs=(pspec, pspec),
                         out_specs=(pspec, P(), P()),
                         check_vma=False)


def build_spmd_cycles(spec, mesh):
    """(plain, rnorm) global-array cycle functions for the adaptive
    solve loop (stop_check='adaptive' under the explicit partition):
    plain(psi, f) -> psi_new runs the metric-free V-cycle; rnorm
    additionally returns the psum'd global sum(r^2)."""
    parts = _build_parts(spec, mesh)
    pspec = parts["pspec"]
    plain = jax.shard_map(parts["cycle_plain_local"], mesh=mesh,
                          in_specs=(pspec, pspec), out_specs=pspec,
                          check_vma=False)
    rnorm = jax.shard_map(parts["cycle_rnorm_local"], mesh=mesh,
                          in_specs=(pspec, pspec),
                          out_specs=(pspec, P()), check_vma=False)
    return plain, rnorm


def build_spmd_fmg(spec, mesh):
    """fmg(f) -> u0: full-multigrid initialization under the explicit
    partition (sharded fine levels, replicated coarse subtree)."""
    parts = _build_parts(spec, mesh)
    pspec = parts["pspec"]
    return jax.shard_map(parts["fmg_local"], mesh=mesh,
                         in_specs=(pspec,), out_specs=pspec,
                         check_vma=False)
