"""Pure-jnp kernel implementations (rank-polymorphic 2D/3D).

Each function mirrors one reference grid-point op (SURVEY.md section 2.2
N1-N10) with identical semantics; XLA fuses the pad/shift stencils into
single bandwidth-bound loops.  This is the backend every level runs
unless `kernels.get_ops` hands a fine 2D level to the Hopper smoother
(kernels/hopper.py), which calls back into these ops for everything but
the sweeps.

All stencil ops take `bc`:
  'ghost0' — out-of-range neighbors read 0 (`cpu.lua:28-31`): the
             reference's operator; always used on the fine level.
  'face'   — ghost = -u_edge (Dirichlet at the cell face): the tuned
             scheme's coarse-level operator (see mgpoisson.oracle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def neighbor_sum(u: jax.Array, bc: str = "ghost0") -> jax.Array:
    """Zero-ghost / face-Dirichlet sum of the 2*ndim face neighbors
    (`gpu.lua:72-75`)."""
    pad = jnp.pad(u, 1)
    s = None
    for ax in range(u.ndim):
        idx_lo = tuple(slice(1, -1) if a != ax else slice(0, -2)
                       for a in range(u.ndim))
        idx_hi = tuple(slice(1, -1) if a != ax else slice(2, None)
                       for a in range(u.ndim))
        term = pad[idx_lo] + pad[idx_hi]
        s = term if s is None else s + term
        if bc == "face":
            first = tuple(slice(None) if a != ax else slice(0, 1)
                          for a in range(u.ndim))
            last = tuple(slice(None) if a != ax else slice(-1, None)
                         for a in range(u.ndim))
            s = s.at[first].add(-u[first])
            s = s.at[last].add(-u[last])
    return s


def jacobi_sweep(u: jax.Array, f: jax.Array, h, bc: str = "ghost0") -> jax.Array:
    """One out-of-place Jacobi sweep (Jacobi kernel, `gpu.lua:83-102`)."""
    hsq = h * h
    askew = neighbor_sum(u, bc) / hsq
    adiag = -2.0 * u.ndim / hsq
    return (f - askew) / adiag


def wjacobi_sweep(u: jax.Array, f: jax.Array, h, bc: str = "ghost0") -> jax.Array:
    """Damped Jacobi, omega = 2d/(2d+1) (see mgpoisson.oracle)."""
    omega = 2.0 * u.ndim / (2.0 * u.ndim + 1.0)
    return u + omega * (jacobi_sweep(u, f, h, bc) - u)


def _parity_mask(shape, ndim):
    idx = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    for ax in range(1, ndim):
        idx = idx + jax.lax.broadcasted_iota(jnp.int32, shape, ax)
    return idx % 2


def rbgs_sweep(u: jax.Array, f: jax.Array, h, bc: str = "ghost0") -> jax.Array:
    """Red-black Gauss-Seidel sweep: the deterministic parallel GS (the
    reference notes plain GS "doesn't guarantee order" on parallel
    hardware and defaults to Jacobi, `gpu.lua:61-62`)."""
    hsq = h * h
    adiag = -2.0 * u.ndim / hsq
    parity = _parity_mask(u.shape, u.ndim)
    for p in (0, 1):
        upd = (f - neighbor_sum(u, bc) / hsq) / adiag
        u = jnp.where(parity == p, upd, u)
    return u


def gs_lex_sweep(u: jax.Array, f: jax.Array, h, bc: str = "ghost0") -> jax.Array:
    """Lexicographic Gauss-Seidel in the reference's exact loop order
    (`cpu.lua:24-37`: in-place, last axis innermost — the smoother every
    reference variant offers, `gpu.lua:63-81`).  Inherently sequential:
    jittable via lax.scan over leading axes and a first-order linear
    recurrence along the last axis (u_k = c_k + u_{k-1}/(2*ndim),
    solved with an associative scan).  XLA/CPU parity path — use
    'rbgs' for the deterministic PARALLEL Gauss-Seidel; plain GS
    on parallel hardware is the race the reference documents
    (`gpu.lua:61-62`).  bc='ghost0' only (like the oracle's
    gs_lex_sweep; the reference has no other bc)."""
    if bc != "ghost0":
        raise ValueError("gs_lex supports bc='ghost0' only")
    nd = u.ndim
    hsq = h * h
    adiag = -2.0 * nd / hsq
    kk = jnp.asarray(1.0 / (2.0 * nd), u.dtype)   # -(1/hsq)/adiag

    def comb(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    def solve_row(c):
        """u_k = kk * u_{k-1} + c_k with zero left ghost."""
        a = jnp.full_like(c, kk).at[..., 0].set(0.0)
        _, b = jax.lax.associative_scan(comb, (a, c), axis=c.ndim - 1)
        return b

    def shifted_old(row):
        """old right neighbor along the last axis (zero ghost)."""
        z = jnp.zeros_like(row[..., :1])
        return jnp.concatenate([row[..., 1:], z], axis=-1)

    zrow = jnp.zeros_like(u[(0,) * (nd - 1)])

    if nd == 2:
        def body(up_new, xs):
            f_row, old_row, old_down = xs
            c = (f_row - (up_new + old_down + shifted_old(old_row))
                 / hsq) / adiag
            new_row = solve_row(c)
            return new_row, new_row

        old_down = jnp.concatenate([u[1:], zrow[None]], axis=0)
        _, out = jax.lax.scan(body, zrow, (f, u, old_down))
        return out

    assert nd == 3
    zplane = jnp.zeros_like(u[0])

    def plane_body(plane_up_new, xs):
        f_pl, old_pl, old_pl_down = xs

        def row_body(row_up_new, xs_r):
            f_row, pu_row, pd_row, old_row, old_row_down = xs_r
            c = (f_row - (row_up_new + pu_row + pd_row + old_row_down
                          + shifted_old(old_row)) / hsq) / adiag
            new_row = solve_row(c)
            return new_row, new_row

        old_row_down = jnp.concatenate([old_pl[1:], zrow[None]], axis=0)
        _, new_pl = jax.lax.scan(
            row_body, zrow,
            (f_pl, plane_up_new, old_pl_down, old_pl, old_row_down))
        return new_pl, new_pl

    old_pl_down = jnp.concatenate([u[1:], zplane[None]], axis=0)
    _, out = jax.lax.scan(plane_body, zplane, (f, u, old_pl_down))
    return out


_SWEEPS = {"jacobi": jacobi_sweep, "wjacobi": wjacobi_sweep,
           "rbgs": rbgs_sweep, "gs_lex": gs_lex_sweep}


def smooth(u: jax.Array, f: jax.Array, h, nu: int,
           smoother: str = "jacobi", bc: str = "ghost0") -> jax.Array:
    """nu smoother sweeps (the reference's smooth loop, `cpu.lua:96-106`)."""
    sweep = _SWEEPS[smoother]
    for _ in range(nu):
        u = sweep(u, f, h, bc)
    return u


def residual(u: jax.Array, f: jax.Array, h, bc: str = "ghost0") -> jax.Array:
    """r = f - A u (calcResidual, `gpu.lua:104-124`)."""
    hsq = h * h
    askew = neighbor_sum(u, bc) / hsq
    adiag = -2.0 * u.ndim / hsq
    return f - (askew + adiag * u)


def apply_operator(u: jax.Array, h, bc: str = "ghost0") -> jax.Array:
    """Matrix-free A u = (sum nbrs - 2*ndim*u)/h^2
    (`test/converge-multigrid-vs-krylov.lua:46-58`)."""
    hsq = h * h
    return (neighbor_sum(u, bc) - 2.0 * u.ndim * u) / hsq


def restrict(r: jax.Array) -> jax.Array:
    """2^ndim-cell average restriction, exact 1/4 / 1/8 weights
    (reduceResidual, `gpu.lua:126-137`), as one reduce_window."""
    s = jax.lax.reduce_window(r, jnp.zeros((), r.dtype), jax.lax.add,
                              (2,) * r.ndim, (2,) * r.ndim, "VALID")
    return s * (0.5 ** r.ndim)


def prolong(V: jax.Array, kind: str = "inject") -> jax.Array:
    """Prolongation coarse -> fine.

    kind='inject': piecewise-constant 2x upsample (expandResidual,
    `gpu.lua:139-161`) — the reference's operator (NOT bilinear);
    required for convergence-count parity.

    kind='bilinear': cell-centered bi/trilinear with face-Dirichlet
    boundary weights (tuned scheme).
    """
    nd = V.ndim
    if kind == "inject":
        for ax in range(nd):
            V = jnp.repeat(V, 2, axis=ax)
        return V
    assert kind == "bilinear"
    # Fine-space formulation on the injected array R = inject(V): per
    # axis, out = a*R + b*S(R) with S the parity-dependent +-2 shift
    # (S R[2I] = R[2I-2] = V[I-1], S R[2I+1] = R[2I+3] = V[I+1]), and
    # per-index weights a/b = (0.75, 0.25) interior, (0.5, 0) at the
    # global edges (interpolating to zero at the cell face).  Expanding
    # the axis product gives ONE fused elementwise pass over R with
    # 3^nd static-offset taps — the same shape as the neighbor-sum
    # stencil (a sequential per-axis blend would materialize the
    # intermediate once per axis).
    for ax in range(nd):
        V = jnp.repeat(V, 2, axis=ax)
    R = V

    def shifted(x, ax):
        """Parity-dependent +-2 shift along ax with zero fill."""
        sl = lambda a, b: tuple(slice(None) if i != ax else slice(a, b)
                                for i in range(nd))
        pad_lo = [(0, 0)] * nd
        pad_lo[ax] = (2, 0)
        pad_hi = [(0, 0)] * nd
        pad_hi[ax] = (0, 2)
        xm = jnp.pad(x, pad_lo)[sl(0, -2)]
        xp = jnp.pad(x, pad_hi)[sl(2, None)]
        idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, ax)
        return jnp.where(idx % 2 == 0, xm, xp)

    def weights(ax):
        n2 = R.shape[ax]
        shape = [1] * nd
        shape[ax] = n2
        idx = jax.lax.iota(jnp.int32, n2).reshape(shape)
        bdry = (idx == 0) | (idx == n2 - 1)
        a = jnp.where(bdry, 0.5, 0.75).astype(R.dtype)
        b = jnp.where(bdry, 0.0, 0.25).astype(R.dtype)
        return a, b

    # accumulate the 3^nd-tap expansion: for each subset of axes the
    # term is prod(a or b) * (composed shifts)(R)
    out = None
    import itertools
    ws = [weights(ax) for ax in range(nd)]
    for picks in itertools.product((0, 1), repeat=nd):
        term = R
        w = None
        for ax, p in enumerate(picks):
            if p:
                term = shifted(term, ax)
            wax = ws[ax][p]
            w = wax if w is None else w * wax
        t = w * term
        out = t if out is None else out + t
    return out


def prolong_correct(u: jax.Array, V: jax.Array, kind: str = "inject") -> jax.Array:
    """Fused prolongation + coarse-grid correction u += P(V)
    (expandResidual + addTo, `gpu.lua:139-171`); XLA fuses the upsample
    into the add so v never hits HBM."""
    return u + prolong(V, kind)


def residual_restrict(u: jax.Array, f: jax.Array, h,
                      bc: str = "ghost0") -> jax.Array:
    """Fused residual + restriction (the r buffer never hits HBM)."""
    return restrict(residual(u, f, h, bc))


def coarse_solve(u: jax.Array, f: jax.Array, h, smoother: str = "jacobi",
                 bc: str = "ghost0") -> jax.Array:
    """Coarsest-level solve: single smoother application (`cpu.lua:76-94`),
    exact at 1x1 for bc='ghost0'; exact 1x1 solve u = f*h^2/(-4*ndim)
    for bc='face' (ghost = -u)."""
    if bc == "face" and u.shape[0] == 1:
        return f * (h * h) / (-4.0 * u.ndim)
    return _SWEEPS[smoother](u, f, h, bc)


# ------------------------------------------------- composite (fused) ops
# One call per V-cycle half-level; kernels/hopper.py has the same four
# around its own smoother.

def smooth_residual_restrict(u, f, h, nu, smoother="jacobi", bc="ghost0"):
    """pre-smooth x nu, then R = restrict(residual). Returns (u, R)."""
    u = smooth(u, f, h, nu, smoother, bc)
    return u, residual_restrict(u, f, h, bc)


def smooth_residual_restrict_zero(f, h, nu, smoother="jacobi",
                                  bc="ghost0"):
    """Down-leg from u IDENTICALLY ZERO — every coarse V-cycle entry
    (cycle/vcycle.py).  Values identical to passing an explicit zeros
    array; XLA's algebraic simplifier folds the first sweep's
    zero-operand stencil."""
    return smooth_residual_restrict(jnp.zeros_like(f), f, h, nu,
                                    smoother, bc)


def prolong_correct_smooth(u, f, V, h, nu, smoother="jacobi", bc="ghost0",
                           kind="inject"):
    """u += P(V), then post-smooth x nu."""
    u = prolong_correct(u, V, kind)
    return smooth(u, f, h, nu, smoother, bc)


def residual_sq_sum(u, f, h):
    """sum(r^2) of the fine-level zero-ghost operator, accumulated in
    at least f32 (bf16 squared residuals underflow/cancel) — THE
    stopping-metric accumulation rule, shared by every path that
    computes it (fused rnorm composites, trace fallbacks, coarse-only
    early return)."""
    r = residual(u, f, h, "ghost0")
    acc = jnp.float32 if r.dtype == jnp.bfloat16 else r.dtype
    r = r.astype(acc)
    return jnp.sum(r * r)


def prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother="jacobi",
                                 bc="ghost0", kind="inject"):
    """Up-leg + the squared residual norm of the result: (u, sum(r^2)).

    Fine-level-only composite that makes stop='residual' (nearly) free:
    the solver's convergence metric comes out of the half-level that
    already has u and f at hand instead of a separate full-grid pass
    (the N9 host-sync elimination of `gpu.lua:361-369` taken to its
    conclusion).  The residual always uses the fine-level zero-ghost
    operator, matching residual_norm."""
    u = prolong_correct_smooth(u, f, V, h, nu, smoother, bc, kind)
    return u, residual_sq_sum(u, f, h)


# ------------------------------------------------------------------- metrics
# On-device reductions — the reference computes per-cell error buffers on
# device and sums on HOST (`gpu.lua:361-369`); here the whole reduction is
# fused on device (SURVEY.md N9/N10).

def rms_update(psi: jax.Array, psi_old: jax.Array) -> jax.Array:
    """sqrt(sum((psi-psi_old)^2)/N) (calcFrobErr, `gpu.lua:361-369`)."""
    acc = jnp.float32 if psi.dtype == jnp.bfloat16 else psi.dtype
    d = (psi - psi_old).astype(acc)
    return jnp.sqrt(jnp.sum(d * d) / psi.size)


def rel_err(psi: jax.Array, psi_old: jax.Array) -> jax.Array:
    """Masked mean |1 - psi/psi_old| (calcRelErr `gpu.lua:173-187` with
    the cl.obj count normalization `test/test-gpu-obj.lua:236-243`)."""
    mask = (psi_old != 0) & (psi_old != psi)
    vals = jnp.where(mask, jnp.abs(1.0 - psi / jnp.where(mask, psi_old, 1.0)),
                     0.0)
    cnt = jnp.sum(mask)
    return jnp.where(cnt > 0, jnp.sum(vals) / jnp.maximum(cnt, 1), 0.0)


def residual_norm(u: jax.Array, f: jax.Array, h) -> jax.Array:
    """L2 norm of the true fine-level residual (zero-ghost operator)."""
    r = residual(u, f, h, "ghost0")
    return jnp.sqrt(jnp.sum(r * r))
