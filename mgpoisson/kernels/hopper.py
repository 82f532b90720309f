"""Temporally blocked 2D smoother for NVIDIA Hopper (Pallas, Triton route).

`xla.smooth` runs its nu sweeps as separate stencil passes, each of
which can cost a full HBM round trip (read u, read f, write u).  This
kernel runs all nu sweeps of one call on chip: every program loads a
power-of-two tile of u and f with a halo of nu*radius rings (radius 1
for jacobi/wjacobi, 2 for rbgs, whose two colours each consume a ring),
sweeps it nu times, and writes back only the interior that is still
exact.  Neighbouring tiles overlap by the halo; the array is read and
written once per call instead of once per sweep (the "deep-halo"
trapezoid of docs/KERNELS.md).

Between sweeps the tile's neighbours are exchanged through a small
per-program scratch buffer in global memory (one tile per program, so
it stays in L2), fenced by block barriers.  The grid is persistent:
`programs` programs each walk over every `programs`-th tile, so the
scratch is `programs` tiles large however big the grid is.

Boundary conditions follow `kernels/xla.py`:
  ghost0 - out-of-domain neighbours read 0 (masked loads);
  face   - ghost = -edge, i.e. the zero-ghost neighbour sum minus the
           centre value once per domain face the cell touches.
Red-black colour is the global parity (i+j) % 2.  bf16 arrays are
loaded and stored as bf16 and computed in f32; the scratch holds the
array dtype, so each sweep rounds like the XLA sweeps do.

Everything besides `smooth` delegates to `kernels/xla.py`; the
composites below call this `smooth` so the V-cycle picks it up.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from mgpoisson.kernels import xla

RADIUS = {"jacobi": 1, "wjacobi": 1, "rbgs": 2}
BLOCK = (32, 128)        # extended tile (rows, cols), halo included
NUM_WARPS = 4
PROGRAMS = 132 * 8       # persistent programs: 8 per H100 SM
DTYPES = (jnp.float32, jnp.bfloat16)


def supports(shape, dtype, smoother: str, nu: int) -> bool:
    """True when the kernel can run this smoothing call."""
    return (len(shape) == 2 and jnp.dtype(dtype) in DTYPES
            and smoother in RADIUS and nu >= 1
            and 2 * _halo(smoother, nu)[1] < BLOCK[1]
            and 2 * _halo(smoother, nu)[0] < BLOCK[0])


def preferred(dtype, smoother: str, nu: int) -> bool:
    """True where the kernel measured faster than `xla.smooth` on an
    H100 (PERF.md, "Kernel decisions"): f32 Jacobi and damped Jacobi
    with 3 or more sweeps (measured at 3 and 7).  In bf16, and for
    red-black Gauss-Seidel (two exchanges per sweep), XLA's separate
    passes are faster; fewer sweeps were not measured."""
    return (jnp.dtype(dtype) == jnp.float32
            and smoother in ("jacobi", "wjacobi") and nu >= 3)


def _halo(smoother: str, nu: int):
    """(row, col) halo depth.  Columns round up to a multiple of 4 so
    every tile's first column stays 16-byte aligned for f32."""
    hr = RADIUS[smoother] * nu
    return hr, -(-hr // 4) * 4


def _plan(shape, smoother, nu, block, programs):
    bm, bn = block
    hr, hc = _halo(smoother, nu)
    tm, tn = bm - 2 * hr, bn - 2 * hc
    if tm < 1 or tn < 1:
        raise ValueError(f"block {block} too small for {smoother} nu={nu}")
    tiles = (-(-shape[0] // tm), -(-shape[1] // tn))
    ntiles = tiles[0] * tiles[1]
    nprog = min(ntiles, programs)
    return hr, hc, tm, tn, tiles, nprog, -(-ntiles // nprog)


def _kernel(u_ref, f_ref, o_ref, s_ref, *, shape, h, nu, smoother, bc,
            block, plan, interpret):
    n, m = shape
    bm, bn = block
    hr, hc, tm, tn, (_, tiles_c), nprog, steps = plan
    ntiles = plan[4][0] * tiles_c
    dt = o_ref.dtype
    hsq = h * h
    adiag = -4.0 / hsq
    omega = 0.8
    pid = pl.program_id(0)
    li = jnp.arange(bm, dtype=jnp.int32)
    lj = jnp.arange(bn, dtype=jnp.int32)
    srow = pid * bm + li                     # this program's scratch rows

    def barrier():
        if not interpret:                    # the interpreter runs serially
            plt.debug_barrier()

    def tile(k):
        t = pid + k * nprog
        live = t < ntiles
        rows = (t // tiles_c) * tm - hr + li
        cols = (t % tiles_c) * tn - hc + lj
        return live, rows, cols

    def in_grid(rows, cols):
        return (((rows >= 0) & (rows < n))[:, None]
                & ((cols >= 0) & (cols < m))[None, :])

    def gload(ref, rows, cols, live):
        mask = in_grid(rows, cols) & live
        v = plt.load(ref.at[rows[:, None], cols[None, :]], mask=mask,
                     other=0.0)
        return v.astype(jnp.float32)

    def sload(di, dj):
        r, c = li + di, lj + dj
        mask = (((r >= 0) & (r < bm))[:, None]
                & ((c >= 0) & (c < bn))[None, :])
        v = plt.load(s_ref.at[(srow + di)[:, None], c[None, :]],
                     mask=mask, other=0.0)
        return v.astype(jnp.float32)

    def body(k, carry):
        live, rows, cols = tile(k)
        dom = in_grid(rows, cols)
        f = gload(f_ref, rows, cols, live)
        if bc == "face":
            nface = (((rows == 0).astype(jnp.float32)
                      + (rows == n - 1).astype(jnp.float32))[:, None]
                     + ((cols == 0).astype(jnp.float32)
                        + (cols == m - 1).astype(jnp.float32))[None, :])
        if smoother == "rbgs":
            parity = ((rows[:, None] + cols[None, :]) & 1)

        def neighbours(u, first):
            """Sum of the four face neighbours of the current iterate."""
            if first:
                s = (gload(u_ref, rows - 1, cols, live)
                     + gload(u_ref, rows + 1, cols, live)
                     + gload(u_ref, rows, cols - 1, live)
                     + gload(u_ref, rows, cols + 1, live))
            else:
                barrier()                    # earlier reads are done
                plt.store(s_ref.at[srow[:, None], lj[None, :]],
                          u.astype(dt))
                barrier()                    # the tile is visible
                s = sload(-1, 0) + sload(1, 0) + sload(0, -1) + sload(0, 1)
            if bc == "face":
                s = s - nface * u
            return s

        def jacobi(u, first):
            return (f - neighbours(u, first) / hsq) / adiag

        u = gload(u_ref, rows, cols, live)
        first = True
        for _ in range(nu):
            if smoother == "rbgs":
                for p in (0, 1):
                    upd = jacobi(u, first)
                    first = False
                    u = jnp.where(dom & (parity == p), upd, u)
                    u = u.astype(dt).astype(jnp.float32)
            else:
                new = jacobi(u, first)
                first = False
                if smoother == "wjacobi":
                    new = u + omega * (new - u)
                u = jnp.where(dom, new, 0.0).astype(dt).astype(jnp.float32)
        keep = (dom & live
                & ((li >= hr) & (li < hr + tm))[:, None]
                & ((lj >= hc) & (lj < hc + tn))[None, :])
        plt.store(o_ref.at[rows[:, None], cols[None, :]], u.astype(dt),
                  mask=keep)
        return carry

    jax.lax.fori_loop(0, steps, body, 0)


def smooth_pallas(u, f, h, nu, smoother="jacobi", bc="ghost0", *,
                  block=BLOCK, programs=PROGRAMS, interpret=False):
    """nu sweeps of `smoother` in one kernel launch.  Same values as
    xla.smooth up to rounding order; h must be a Python number."""
    if nu == 0:
        return u
    if u.ndim != 2 or smoother not in RADIUS:
        raise ValueError(f"hopper smoother: unsupported {u.ndim}D "
                         f"{smoother!r}")
    plan = _plan(u.shape, smoother, nu, block, programs)
    nprog = plan[5]
    kern = functools.partial(
        _kernel, shape=u.shape, h=float(h), nu=nu, smoother=smoother,
        bc=bc, block=tuple(block), plan=plan, interpret=interpret)
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    out, _ = pl.pallas_call(
        kern,
        out_shape=(jax.ShapeDtypeStruct(u.shape, u.dtype),
                   jax.ShapeDtypeStruct((nprog * block[0], block[1]),
                                        u.dtype)),
        in_specs=[any_spec, any_spec],
        out_specs=(any_spec, any_spec),
        grid=(nprog,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=f"mg_smooth_{smoother}_{bc}_nu{nu}",
    )(u, f.astype(u.dtype))
    return out


def smooth(u, f, h, nu, smoother="jacobi", bc="ghost0"):
    """Drop-in for xla.smooth: the kernel where it applies, else XLA."""
    if (not supports(u.shape, u.dtype, smoother, nu)
            or not isinstance(h, (int, float))):
        return xla.smooth(u, f, h, nu, smoother, bc)
    return smooth_pallas(u, f, h, nu, smoother, bc)


# ------------------------------------------------------------ composites
# Same structure as kernels/xla.py; only the smoother differs.

def smooth_residual_restrict(u, f, h, nu, smoother="jacobi", bc="ghost0"):
    u = smooth(u, f, h, nu, smoother, bc)
    return u, xla.residual_restrict(u, f, h, bc)


def smooth_residual_restrict_zero(f, h, nu, smoother="jacobi",
                                  bc="ghost0"):
    return smooth_residual_restrict(jnp.zeros_like(f), f, h, nu,
                                    smoother, bc)


def prolong_correct_smooth(u, f, V, h, nu, smoother="jacobi", bc="ghost0",
                           kind="inject"):
    u = xla.prolong_correct(u, V, kind)
    return smooth(u, f, h, nu, smoother, bc)


def prolong_correct_smooth_rnorm(u, f, V, h, nu, smoother="jacobi",
                                 bc="ghost0", kind="inject"):
    u = prolong_correct_smooth(u, f, V, h, nu, smoother, bc, kind)
    return u, xla.residual_sq_sum(u, f, h)


# the remaining level ops are XLA's own
neighbor_sum = xla.neighbor_sum
residual = xla.residual
restrict = xla.restrict
prolong = xla.prolong
prolong_correct = xla.prolong_correct
residual_restrict = xla.residual_restrict
coarse_solve = xla.coarse_solve
residual_sq_sum = xla.residual_sq_sum
